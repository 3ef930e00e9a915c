// sample_gradients: bilinear samples of the bf16 gradient planes gx, gy at
// every keypoint's rotated G x G descriptor grid.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/desc_sampler.py::sample_gradients
// (body `_kernel`).  Semantics are those of the plain version,
// siftgpu_tpu_torch/ops/desc_sampler.py::sample_gradients_plain, which is the
// reference's gather route (siftgpu_tpu/frontend/describe.py::_bilerp_xla):
//   x0 = clamp(floor(px), 0, W-1), x1 = min(x0+1, W-1)   (rows alike)
//   fx = clamp(px - x0, 0, 1)                             (fy alike)
//   s  = g00 (1-fy)(1-fx) + g01 (1-fy) fx + g10 fy (1-fx) + g11 fy fx
// with the bf16 taps widened to f32 and the blend evaluated left to right.
// The TPU kernel's tile-snapped 96 x 256 windows and bf16 tent matmul are
// that chip's layout and precision and have no counterpart here.
//
// What bounds it on the H100: 8 scattered 2-byte taps and 8 bytes of
// coordinates read, 8 bytes written per sample — latency of the gathers, not
// bandwidth or flops (a grid spans ~80 px, so the taps hit L1/L2).  The
// simple design: one block per keypoint and one thread per sample (256 for
// G^2 = 256); neighbouring threads take neighbouring samples, so the
// coordinate loads and the sample stores coalesce.  Built with -fmad=false:
// every product and sum rounds as the plain version's PyTorch ops do, so the
// outputs are bit-identical to it.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) sample_gradients_kernel(
    const __nv_bfloat16* __restrict__ gx, const __nv_bfloat16* __restrict__ gy,
    const int* __restrict__ plane, const float* __restrict__ py,
    const float* __restrict__ px, float* __restrict__ sgx,
    float* __restrict__ sgy, int H, int W, int G2) {
  const long long n = blockIdx.x;
  const long long base = static_cast<long long>(plane[n]) * H * W;
  for (int s = threadIdx.x; s < G2; s += blockDim.x) {
    const long long k = n * G2 + s;
    const float fpy = py[k], fpx = px[k];
    const int x0 = min(max(static_cast<int>(floorf(fpx)), 0), W - 1);
    const int y0 = min(max(static_cast<int>(floorf(fpy)), 0), H - 1);
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);
    const float fx = fminf(fmaxf(fpx - static_cast<float>(x0), 0.0f), 1.0f);
    const float fy = fminf(fmaxf(fpy - static_cast<float>(y0), 0.0f), 1.0f);
    const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
    const long long i00 = base + static_cast<long long>(y0) * W + x0;
    const long long i01 = base + static_cast<long long>(y0) * W + x1;
    const long long i10 = base + static_cast<long long>(y1) * W + x0;
    const long long i11 = base + static_cast<long long>(y1) * W + x1;
    float vx = __bfloat162float(gx[i00]) * wy0 * wx0;
    vx = vx + __bfloat162float(gx[i01]) * wy0 * fx;
    vx = vx + __bfloat162float(gx[i10]) * fy * wx0;
    vx = vx + __bfloat162float(gx[i11]) * fy * fx;
    float vy = __bfloat162float(gy[i00]) * wy0 * wx0;
    vy = vy + __bfloat162float(gy[i01]) * wy0 * fx;
    vy = vy + __bfloat162float(gy[i10]) * fy * wx0;
    vy = vy + __bfloat162float(gy[i11]) * fy * fx;
    sgx[k] = vx;
    sgy[k] = vy;
  }
}

}  // namespace

extern "C" int sample_gradients_launch(const __nv_bfloat16* gx,
                                       const __nv_bfloat16* gy,
                                       const int* plane, const float* py,
                                       const float* px, float* sgx, float* sgy,
                                       int N, int H, int W, int G2,
                                       cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || G2 <= 0) return cudaErrorInvalidValue;
  sample_gradients_kernel<<<N, 256, 0, stream>>>(gx, gy, plane, py, px, sgx,
                                                 sgy, H, W, G2);
  return static_cast<int>(cudaGetLastError());
}
