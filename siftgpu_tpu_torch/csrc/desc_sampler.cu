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
// A keypoint whose plane is negative is skipped: its output row keeps its
// bytes.  The TPU kernel's tile-snapped 96 x 256 windows and bf16 tent matmul
// are that chip's layout and precision and have no counterpart here.
//
// What bounds it on the H100: 8 scattered 2-byte taps and 8 bytes of
// coordinates read, 8 bytes written per sample — latency of the gathers, not
// bandwidth or flops (a grid spans ~80 px, so the taps hit L1/L2).  The
// design: a warp per keypoint, 8 keypoints a block; a warp whose keypoint is
// skipped exits at once; each lane takes 4 consecutive samples of a grid row
// per step (a float4 of y and one of x, a float4 store per plane, where G^2
// is a multiple of 4 and the pointers are 16-byte aligned; scalar accesses
// otherwise), so a warp's taps fall on neighbouring cache lines.  Built with
// -fmad=false: every product and sum rounds as the plain version's PyTorch
// ops do, so the outputs are bit-identical to it.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // keypoints of a block
constexpr int kVec = 4;     // consecutive samples of a lane per step

__device__ __forceinline__ void bilerp(const __nv_bfloat16* __restrict__ gx,
                                       const __nv_bfloat16* __restrict__ gy,
                                       int H, int W, float fpy, float fpx,
                                       float& vx, float& vy) {
  const int x0 = min(max(static_cast<int>(floorf(fpx)), 0), W - 1);
  const int y0 = min(max(static_cast<int>(floorf(fpy)), 0), H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const float fx = fminf(fmaxf(fpx - static_cast<float>(x0), 0.0f), 1.0f);
  const float fy = fminf(fmaxf(fpy - static_cast<float>(y0), 0.0f), 1.0f);
  const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
  const int i00 = y0 * W + x0, i01 = y0 * W + x1;
  const int i10 = y1 * W + x0, i11 = y1 * W + x1;
  vx = __bfloat162float(gx[i00]) * wy0 * wx0;
  vx = vx + __bfloat162float(gx[i01]) * wy0 * fx;
  vx = vx + __bfloat162float(gx[i10]) * fy * wx0;
  vx = vx + __bfloat162float(gx[i11]) * fy * fx;
  vy = __bfloat162float(gy[i00]) * wy0 * wx0;
  vy = vy + __bfloat162float(gy[i01]) * wy0 * fx;
  vy = vy + __bfloat162float(gy[i10]) * fy * wx0;
  vy = vy + __bfloat162float(gy[i11]) * fy * fx;
}

template <bool VEC>
__global__ void __launch_bounds__(kWarps * 32) sample_gradients_kernel(
    const __nv_bfloat16* __restrict__ gx, const __nv_bfloat16* __restrict__ gy,
    const int* __restrict__ plane, const float* __restrict__ py,
    const float* __restrict__ px, float* __restrict__ sgx,
    float* __restrict__ sgy, int N, int H, int W, int G2) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const int p = plane[n];
  if (p < 0) return;  // the whole warp: a skipped keypoint
  const size_t base = static_cast<size_t>(p) * H * W;
  const __nv_bfloat16* pgx = gx + base;
  const __nv_bfloat16* pgy = gy + base;
  const size_t row = static_cast<size_t>(n) * G2;
  for (int s = kVec * (threadIdx.x & 31); s < G2; s += kVec * 32) {
    float fy[kVec], fx[kVec], vx[kVec], vy[kVec];
    if (VEC) {
      const float4 a = *reinterpret_cast<const float4*>(py + row + s);
      const float4 b = *reinterpret_cast<const float4*>(px + row + s);
      fy[0] = a.x; fy[1] = a.y; fy[2] = a.z; fy[3] = a.w;
      fx[0] = b.x; fx[1] = b.y; fx[2] = b.z; fx[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        fy[j] = s + j < G2 ? py[row + s + j] : 0.0f;
        fx[j] = s + j < G2 ? px[row + s + j] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) bilerp(pgx, pgy, H, W, fy[j], fx[j], vx[j], vy[j]);
    if (VEC) {
      *reinterpret_cast<float4*>(sgx + row + s) = make_float4(vx[0], vx[1], vx[2], vx[3]);
      *reinterpret_cast<float4*>(sgy + row + s) = make_float4(vy[0], vy[1], vy[2], vy[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (s + j < G2) {
          sgx[row + s + j] = vx[j];
          sgy[row + s + j] = vy[j];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int sample_gradients_launch(const __nv_bfloat16* gx,
                                       const __nv_bfloat16* gy,
                                       const int* plane, const float* py,
                                       const float* px, float* sgx, float* sgy,
                                       int N, int H, int W, int G2,
                                       cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || G2 <= 0) return cudaErrorInvalidValue;
  const bool vec = G2 % kVec == 0 && aligned16(py) && aligned16(px) && aligned16(sgx) &&
                   aligned16(sgy);
  const unsigned blocks = sift_ceil_div(N, kWarps);
  if (vec)
    sample_gradients_kernel<true><<<blocks, kWarps * 32, 0, stream>>>(
        gx, gy, plane, py, px, sgx, sgy, N, H, W, G2);
  else
    sample_gradients_kernel<false><<<blocks, kWarps * 32, 0, stream>>>(
        gx, gy, plane, py, px, sgx, sgy, N, H, W, G2);
  return static_cast<int>(cudaGetLastError());
}
