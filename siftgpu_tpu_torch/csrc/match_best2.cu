// match_best2: fused best-2 descriptor match reduction on uint8 sets.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/match_kernel.py::match_best2
// (body `_kernel`), ungated.  Semantics are those of the plain version,
// siftgpu_tpu_torch/ops/match_kernel.py::match_best2_plain:
//   sim[i, j] = (float(dot(d0[i], d1[j])) * rn1[j]) * rn0[i], -inf if masked
//   per row: best, second-best and argbest column; per column: argbest row;
//   ties to the lowest index.
//
// What bounds it on the H100: 2048 x 2048 x 128 byte products per pair
// (0.5 G integer multiply-adds, 3 pairs on the main path) against 0.5 MB of
// descriptors — compute-bound in principle, but at this size the block
// count (64 row tiles x 3 pairs) and the shared-memory operand traffic of
// one __dp4a per 4 bytes bound it.  The simple design: one block per tile of
// TM = 32 rows of one pair (blockIdx.z is the pair); it loops over all
// column tiles of TN = 128 descriptors staged in shared memory, each thread
// computing 16 exact integer dots with __dp4a (32 per dot), so the [N0, N1]
// similarity never reaches device memory.  Each thread keeps a running
// (best, second, argbest) over its columns in ascending order; the 8
// threads of a row merge in a fixed order with ties to the lowest column.
// Columns cannot be carried across row tiles as the TPU grid does, so each
// block reduces its tile's columns over its 32 rows and publishes
// (order-preserving sim bits << 32 | ~row) with a 64-bit atomicMax: the
// largest similarity wins, and on ties the lowest row.  A second tiny kernel
// decodes the winning rows.  The integer dot is exact and the two products
// round as in the plain version, so the outputs are bit-identical to it.
#include "common.cuh"

namespace {

constexpr int TM = 32;        // rows per block
constexpr int TN = 128;       // columns per staged tile
constexpr int KW = 32;        // 128 bytes = 32 packed words per descriptor
constexpr int kThreads = 256; // 8 threads per row
constexpr int kCols = TN / 8; // columns per thread per tile

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads) match_best2_kernel(
    const unsigned int* __restrict__ d0, const unsigned int* __restrict__ d1,
    const float* __restrict__ rn0, const float* __restrict__ rn1,
    const uint8_t* __restrict__ m0, const uint8_t* __restrict__ m1,
    float* __restrict__ bsim, float* __restrict__ ssim, int* __restrict__ bestj,
    unsigned long long* __restrict__ colkey, int N0, int N1) {
  __shared__ unsigned int s0[TM][KW + 1];
  __shared__ unsigned int s1[TN][KW + 1];
  __shared__ float tile[TM][TN + 1];
  __shared__ float mb[TM][8], ms[TM][8];
  __shared__ int mj[TM][8];

  const int p = blockIdx.z;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  d0 += static_cast<size_t>(p) * N0 * KW;
  d1 += static_cast<size_t>(p) * N1 * KW;
  rn0 += static_cast<size_t>(p) * N0;
  rn1 += static_cast<size_t>(p) * N1;
  m0 += static_cast<size_t>(p) * N0;
  m1 += static_cast<size_t>(p) * N1;
  colkey += static_cast<size_t>(p) * N1;

  for (int k = tid; k < TM * KW; k += kThreads) {
    const int r = k / KW, w = k % KW;
    s0[r][w] = (row0 + r < N0) ? d0[static_cast<size_t>(row0 + r) * KW + w] : 0u;
  }
  const int r = tid >> 3, q = tid & 7;
  const int gi = row0 + r;
  const bool row_ok = gi < N0 && m0[gi];
  const float rni = gi < N0 ? rn0[gi] : 0.0f;
  const int rows_here = min(TM, N0 - row0);

  float best = -INFINITY, second = -INFINITY;
  int bj = 0x7fffffff;
  for (int c0 = 0; c0 < N1; c0 += TN) {
    __syncthreads();  // previous tile fully consumed (and s0 loaded)
    for (int k = tid; k < TN * KW; k += kThreads) {
      const int c = k / KW, w = k % KW;
      s1[c][w] = (c0 + c < N1) ? d1[static_cast<size_t>(c0 + c) * KW + w] : 0u;
    }
    __syncthreads();
    unsigned int acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0u;
    for (int w = 0; w < KW; ++w) {
      const unsigned int a = s0[r][w];
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] = __dp4a(a, s1[q + 8 * k][w], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {  // ascending columns within the thread
      const int cc = q + 8 * k, j = c0 + cc;
      float v = -INFINITY;
      if (j < N1) {
        if (row_ok && m1[j]) v = (static_cast<float>(acc[k]) * rn1[j]) * rni;
        if (v > best || (v == best && j < bj)) {
          second = best; best = v; bj = j;
        } else if (v > second) {
          second = v;
        }
      }
      tile[r][cc] = v;
    }
    __syncthreads();
    if (tid < TN && c0 + tid < N1) {  // column side: argbest over this block's rows
      float cb = tile[0][tid];
      int ci = 0;
      for (int rr = 1; rr < rows_here; ++rr) {
        const float v = tile[rr][tid];
        if (v > cb) { cb = v; ci = rr; }
      }
      const unsigned long long key =
          (static_cast<unsigned long long>(order_bits(cb)) << 32) |
          static_cast<unsigned long long>(0xffffffffu - static_cast<unsigned int>(row0 + ci));
      atomicMax(&colkey[c0 + tid], key);
    }
  }

  // row side: merge the 8 segments of each row in a fixed order
  mb[r][q] = best; ms[r][q] = second; mj[r][q] = bj;
  __syncthreads();
  if (q == 0 && gi < N0) {
    float B = mb[r][0], S = ms[r][0];
    int J = mj[r][0];
    for (int k = 1; k < 8; ++k) {
      const float b2 = mb[r][k], s2 = ms[r][k];
      const int j2 = mj[r][k];
      S = fmaxf(fmaxf(S, s2), fminf(B, b2));
      if (b2 > B || (b2 == B && j2 < J)) J = j2;
      B = fmaxf(B, b2);
    }
    bsim[static_cast<size_t>(p) * N0 + gi] = B;
    ssim[static_cast<size_t>(p) * N0 + gi] = S;
    bestj[static_cast<size_t>(p) * N0 + gi] = J;
  }
}

__global__ void decode_cols_kernel(const unsigned long long* __restrict__ colkey,
                                   int* __restrict__ colbest, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < total)
    colbest[i] = static_cast<int>(0xffffffffu - static_cast<unsigned int>(colkey[i] & 0xffffffffull));
}

}  // namespace

extern "C" int match_best2_launch(
    const unsigned int* d0, const unsigned int* d1, const float* rn0,
    const float* rn1, const uint8_t* m0, const uint8_t* m1, float* bsim,
    float* ssim, int* bestj, int* colbest, unsigned long long* colkey, int P,
    int N0, int N1, cudaStream_t stream) {
  if (P <= 0 || N0 <= 0 || N1 <= 0) return cudaErrorInvalidValue;
  const dim3 grid(sift_ceil_div(N0, TM), 1, P);
  match_best2_kernel<<<grid, kThreads, 0, stream>>>(
      d0, d1, rn0, rn1, m0, m1, bsim, ssim, bestj, colkey, N0, N1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(P) * N1;
  decode_cols_kernel<<<sift_ceil_div(total, 256), 256, 0, stream>>>(colkey, colbest, total);
  return static_cast<int>(cudaGetLastError());
}
