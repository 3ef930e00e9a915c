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
//
// Guided variant (match_best2_gated_launch; the Pallas kernel's
// gate="h"/"f"/"hf"): the same kernel instantiated with kGate != 0, where
// each pair must also pass the reprojection gate (bit 1) and/or the
// symmetric epipolar gate (bit 2) before it enters the row best-2 and the
// column atomicMax — the ProgramCU::MultiplyDescriptorG fusion, so neither
// the similarity nor the gate matrices reach device memory.  The gates are
// formed from rank-1 operands (frontend/match.py::gate_operands): per row
// [px, py] (H) then [la_x, la_y, la_z, x0x, x0y] (F), per column [x1, y1]
// then [lb_x, lb_y, lb_z] (F); the column operands are staged in shared
// memory with their descriptor tile.  In the plain version's operand order:
//   H: dx = px - x1; dy = py - y1; dx*dx + dy*dy < h2
//   F: max(|la_x*x1 + la_y*y1 + la_z|, |x0x*lb_x + x0y*lb_y + lb_z|) < fthr
// written with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts
// into FMAs, so the gates are bit-identical to the plain version's and the
// ungated instantiation keeps its code and build flags.  The gate adds at
// most 12 flops per pair against the pair's 32 __dp4a.
#include "common.cuh"

namespace {

constexpr int TM = 32;        // rows per block
constexpr int TN = 128;       // columns per staged tile
constexpr int KW = 32;        // 128 bytes = 32 packed words per descriptor
constexpr int kThreads = 256; // 8 threads per row
constexpr int kCols = TN / 8; // columns per thread per tile
constexpr int kGateH = 1, kGateF = 2;

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ constexpr int gate_rows(int gate) {
  return ((gate & kGateH) ? 2 : 0) + ((gate & kGateF) ? 5 : 0);
}
__host__ __device__ constexpr int gate_cols(int gate) {
  return gate ? ((gate & kGateF) ? 5 : 2) : 0;
}

// grow: [P, gate_rows, N0] and gcol: [P, gate_cols, N1] f32 gate operands
// (unused when kGate == 0).
template <int kGate>
__global__ void __launch_bounds__(kThreads) match_best2_kernel(
    const unsigned int* __restrict__ d0, const unsigned int* __restrict__ d1,
    const float* __restrict__ rn0, const float* __restrict__ rn1,
    const uint8_t* __restrict__ m0, const uint8_t* __restrict__ m1,
    const float* __restrict__ grow, const float* __restrict__ gcol, float h2,
    float fthr, float* __restrict__ bsim, float* __restrict__ ssim,
    int* __restrict__ bestj, unsigned long long* __restrict__ colkey, int N0,
    int N1) {
  constexpr int kGR = gate_rows(kGate), kGC = gate_cols(kGate);
  __shared__ unsigned int s0[TM][KW + 1];
  __shared__ unsigned int s1[TN][KW + 1];
  __shared__ float tile[TM][TN + 1];
  __shared__ float mb[TM][8], ms[TM][8];
  __shared__ int mj[TM][8];
  __shared__ float sc[kGC > 0 ? kGC : 1][TN];

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
  float gr[kGR > 0 ? kGR : 1];  // this row's gate operands
#pragma unroll
  for (int g = 0; g < kGR; ++g)
    gr[g] = gi < N0 ? grow[(static_cast<size_t>(p) * kGR + g) * N0 + gi] : 0.0f;

  float best = -INFINITY, second = -INFINITY;
  int bj = 0x7fffffff;
  for (int c0 = 0; c0 < N1; c0 += TN) {
    __syncthreads();  // previous tile fully consumed (and s0 loaded)
    for (int k = tid; k < TN * KW; k += kThreads) {
      const int c = k / KW, w = k % KW;
      s1[c][w] = (c0 + c < N1) ? d1[static_cast<size_t>(c0 + c) * KW + w] : 0u;
    }
    for (int k = tid; k < kGC * TN; k += kThreads) {
      const int g = k / TN, c = k % TN;
      sc[g][c] = (c0 + c < N1) ? gcol[(static_cast<size_t>(p) * kGC + g) * N1 + c0 + c] : 0.0f;
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
        bool ok = row_ok && m1[j];
        if constexpr ((kGate & kGateH) != 0) {
          const float dx = __fsub_rn(gr[0], sc[0][cc]), dy = __fsub_rn(gr[1], sc[1][cc]);
          ok = ok && __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < h2;
        }
        if constexpr ((kGate & kGateF) != 0) {
          constexpr int f = (kGate & kGateH) ? 2 : 0;
          const float x1 = sc[0][cc], y1 = sc[1][cc];
          const float da = fabsf(__fadd_rn(
              __fadd_rn(__fmul_rn(gr[f], x1), __fmul_rn(gr[f + 1], y1)), gr[f + 2]));
          const float db = fabsf(__fadd_rn(
              __fadd_rn(__fmul_rn(gr[f + 3], sc[2][cc]), __fmul_rn(gr[f + 4], sc[3][cc])),
              sc[4][cc]));
          ok = ok && fmaxf(da, db) < fthr;
        }
        if (ok) v = (static_cast<float>(acc[k]) * rn1[j]) * rni;
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

template <int kGate>
int launch(const unsigned int* d0, const unsigned int* d1, const float* rn0,
           const float* rn1, const uint8_t* m0, const uint8_t* m1,
           const float* grow, const float* gcol, float h2, float fthr,
           float* bsim, float* ssim, int* bestj, int* colbest,
           unsigned long long* colkey, int P, int N0, int N1,
           cudaStream_t stream) {
  if (P <= 0 || N0 <= 0 || N1 <= 0) return cudaErrorInvalidValue;
  const dim3 grid(sift_ceil_div(N0, TM), 1, P);
  match_best2_kernel<kGate><<<grid, kThreads, 0, stream>>>(
      d0, d1, rn0, rn1, m0, m1, grow, gcol, h2, fthr, bsim, ssim, bestj,
      colkey, N0, N1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(P) * N1;
  decode_cols_kernel<<<sift_ceil_div(total, 256), 256, 0, stream>>>(colkey, colbest, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int match_best2_launch(
    const unsigned int* d0, const unsigned int* d1, const float* rn0,
    const float* rn1, const uint8_t* m0, const uint8_t* m1, float* bsim,
    float* ssim, int* bestj, int* colbest, unsigned long long* colkey, int P,
    int N0, int N1, cudaStream_t stream) {
  return launch<0>(d0, d1, rn0, rn1, m0, m1, nullptr, nullptr, 0.0f, 0.0f,
                   bsim, ssim, bestj, colbest, colkey, P, N0, N1, stream);
}

// gate: 1 = H, 2 = F, 3 = both; grow [P, 2|5|7, N0], gcol [P, 2|5, N1].
extern "C" int match_best2_gated_launch(
    const unsigned int* d0, const unsigned int* d1, const float* rn0,
    const float* rn1, const uint8_t* m0, const uint8_t* m1, const float* grow,
    const float* gcol, float h2, float fthr, float* bsim, float* ssim,
    int* bestj, int* colbest, unsigned long long* colkey, int P, int N0,
    int N1, int gate, cudaStream_t stream) {
  switch (gate) {
    case kGateH:
      return launch<kGateH>(d0, d1, rn0, rn1, m0, m1, grow, gcol, h2, fthr,
                            bsim, ssim, bestj, colbest, colkey, P, N0, N1, stream);
    case kGateF:
      return launch<kGateF>(d0, d1, rn0, rn1, m0, m1, grow, gcol, h2, fthr,
                            bsim, ssim, bestj, colbest, colkey, P, N0, N1, stream);
    case kGateH | kGateF:
      return launch<kGateH | kGateF>(d0, d1, rn0, rn1, m0, m1, grow, gcol, h2,
                                     fthr, bsim, ssim, bestj, colbest, colkey,
                                     P, N0, N1, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
