// grad_stencil: central-difference gradient stack of Gaussian levels 1..S,
// stored as bf16.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/grad_stencil.py::grad_stencil
// (body `_kernel`).  Semantics are those of the plain version,
// siftgpu_tpu_torch/ops/grad_stencil.py::grad_stencil_plain:
//   gx = 0.5 (g[y, x+1] - g[y, x-1]), one-sided and unhalved at x = 0, W-1
//   gy = 0.5 (g[y+1, x] - g[y-1, x]), one-sided and unhalved at y = 0, H-1
// zero beyond (H, W) up to (Hp, Wp), rounded to bf16 to nearest even.
//
// What bounds it on the H100: pure data movement — 4 B read and 2 x 2 B
// written per pixel, ~3 flops.  The simple design: one thread per output
// pixel, neighbouring threads on neighbouring columns so the loads and the
// bf16 stores coalesce; the 5-point reads overlap in L1.  One subtraction and
// one exact halving per value: bit-identical to the plain version.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__global__ void grad_stencil_kernel(const float* __restrict__ gauss,
                                    __nv_bfloat16* __restrict__ gx,
                                    __nv_bfloat16* __restrict__ gy, int L,
                                    int S, int H, int W, int Hp, int Wp,
                                    long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % Wp);
  const int y = static_cast<int>((idx / Wp) % Hp);
  const long long bs = idx / (static_cast<long long>(Wp) * Hp);
  float vx = 0.0f, vy = 0.0f;
  if (y < H && x < W) {
    const long long b = bs / S, s = bs % S;
    const float* g = gauss + (b * L + s + 1) * static_cast<long long>(H) * W;
    const float* row = g + static_cast<long long>(y) * W;
    if (x == 0) vx = row[1] - row[0];
    else if (x == W - 1) vx = row[W - 1] - row[W - 2];
    else vx = 0.5f * (row[x + 1] - row[x - 1]);
    if (y == 0) vy = g[W + x] - g[x];
    else if (y == H - 1) vy = g[static_cast<long long>(H - 1) * W + x] -
                              g[static_cast<long long>(H - 2) * W + x];
    else vy = 0.5f * (row[W + x] - row[x - W]);
  }
  gx[idx] = __float2bfloat16_rn(vx);
  gy[idx] = __float2bfloat16_rn(vy);
}

}  // namespace

extern "C" int grad_stencil_launch(const float* gauss, __nv_bfloat16* gx,
                                   __nv_bfloat16* gy, int B, int L, int S,
                                   int H, int W, int Hp, int Wp,
                                   cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * S * Hp * Wp;
  if (total == 0) return 0;
  grad_stencil_kernel<<<sift_ceil_div(total, 256), 256, 0, stream>>>(
      gauss, gx, gy, L, S, H, W, Hp, Wp, total);
  return static_cast<int>(cudaGetLastError());
}
