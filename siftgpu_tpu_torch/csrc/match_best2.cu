// match_best2: fused best-2 descriptor match reduction on uint8 sets.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/match_kernel.py::match_best2
// (body `_kernel`), ungated and gated.  Semantics are those of the plain
// version, siftgpu_tpu_torch/ops/match_kernel.py::match_best2_plain:
//   sim[i, j] = (float(dot(d0[i], d1[j])) * rn1[j]) * rn0[i], -inf if masked
//   per row: best, second-best and argbest column; per column: argbest row;
//   ties to the lowest index.
//
// What bounds it on the H100.  The product is 2 x 128 int8 operations per
// pair (3.2 G on the main path's 3 x 2048^2 pairs: 1.6 us at the tensor
// cores' 1,979 TOP/s), the bytes a few MB; what is left is the per-pair f32
// epilogue on the CUDA cores (convert, two multiplies, the mask, the row
// best-2 update and the column candidate, plus 5-12 gate operations), about
// 10-35 instructions a pair.  The design keeps the tensor cores and the
// copies out of the epilogue's way:
//
// - The dot products run on the tensor cores, exactly:
//   `mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32`, operands from shared
//   memory by `ldmatrix` (descriptors are row-major with K = 128 contiguous,
//   which is the row.col layout of both operands).  Every sum is at most
//   128 * 255^2 < 2^24, so the s32 accumulator and its conversion to f32 are
//   exact, and the two products round as in the plain version.  mma.sync,
//   not wgmma: the product is not what bounds the kernel, and its
//   per-thread fragment layout is what the register epilogue works on.
// - A block owns a 128-row tile of one pair (staged once) and a range of
//   64-column tiles (a column split).  Column tiles of d1, with rn1, m1 and
//   the column gate operands, go through a double-buffered ring in shared
//   memory by cp.async, so the next tile loads while this one's epilogue
//   runs.  Rows are padded to 144 bytes: ldmatrix reads them conflict-free.
// - 8 warps: 2 row halves (64 rows) x 4 column quarters (16 columns).  Each
//   thread holds 8 rows x 4 columns of the accumulator fragment and does the
//   epilogue in registers: it converts, scales, masks and gates its pairs
//   (gate sums on __fmul_rn / __fadd_rn / __fsub_rn, never contracted, as the
//   plain version's operation order), keeps a running (best, second,
//   argbest) for each of its rows over its columns in ascending order, and
//   reduces each of its columns over its 8 rows.
// - Column argbest: (order-preserving sim bits << 32 | ~row) keys, reduced
//   by max across the 8 lanes and the 2 row halves that share a column,
//   then one 64-bit atomicMax per column per 128-row tile: the largest
//   similarity wins, on ties the lowest row.
// - Rows: after the block's last tile the 4 lanes and the 4 column quarters
//   that share a row merge in ascending column order with the reference's
//   rule (siftgpu_tpu/ops/match_kernel.py:128-130): S = max(max(S, s2),
//   min(B, b2)), J moves on a larger B or an equal B with a lower j.  Each
//   block writes its split's (B, S, J) to a scratch [P, N0, splits]; the
//   second kernel merges the splits in ascending order by the same rule and
//   decodes the column keys.
// - The column splits make the grid several hundred blocks (about 4 per SM
//   of 132), so the main path's 3 x 2048^2 and the facade's 4096^2 calls
//   fill the card; ops/match_kernel.py::launch_plan sizes them.
//
// Guided variant (match_best2_gated_launch; the Pallas kernel's
// gate="h"/"f"/"hf"): the same kernel instantiated with kGate != 0, where
// each pair must also pass the reprojection gate (bit 1) and/or the
// symmetric epipolar gate (bit 2).  Rank-1 operands
// (frontend/match.py::gate_operands): per row [px, py] (H) then [la_x,
// la_y, la_z, x0x, x0y] (F), per column [x1, y1] then [lb_x, lb_y, lb_z]
// (F).  In the plain version's operand order:
//   H: dx = px - x1; dy = py - y1; dx*dx + dy*dy < h2
//   F: max(|la_x*x1 + la_y*y1 + la_z|, |x0x*lb_x + x0y*lb_y + lb_z|) < fthr
// so the gates, and the outputs, are bit-identical to the plain version's.
#include "common.cuh"

namespace {

constexpr int BM = 128;              // rows per block (row tile)
constexpr int BN = 64;               // columns per staged tile
constexpr int KB = 128;              // bytes per descriptor
constexpr int PITCH = KB + 16;       // shared row pitch in bytes (ldmatrix without conflicts)
constexpr int kThreads = 256;        // 8 warps: 2 row halves x 4 column quarters
constexpr int kStages = 2;           // column-tile ring
constexpr int kMaskW = 80;           // mask window per stage: 17 aligned words, rounded up
constexpr int kMaskWords = 17;       // BN bytes from any byte offset in a word
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

// dynamic shared memory of one block (ops/match_kernel.py::launch_plan)
__host__ __device__ constexpr int smem_bytes(int gate) {
  return BM * PITCH + kStages * BN * PITCH + 2 * BN * 8 +
         kStages * BN * 4 * (1 + gate_cols(gate)) + gate_rows(gate) * BM * 4 +
         kStages * kMaskW;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async with zero fill: `bytes` of `src` are copied, the rest is zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// D = A (16 x 32, row) * B (32 x 8, col) + D, u8 operands, s32 accumulator
__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The reference's merge of two disjoint candidates' (best, second, argbest).
__device__ __forceinline__ void merge2(float& B, float& S, int& J, float b2, float s2, int j2) {
  S = fmaxf(fmaxf(S, s2), fminf(B, b2));
  if (b2 > B || (b2 == B && j2 < J)) J = j2;
  B = fmaxf(B, b2);
}

// grow: [P, gate_rows, N0] and gcol: [P, gate_cols, N1] f32 gate operands
// (unused when kGate == 0).  Row partials: pb, ps, pj [P, N0, nsplit].
template <int kGate>
__global__ void __launch_bounds__(kThreads, 2) match_best2_kernel(
    const uint8_t* __restrict__ d0, const uint8_t* __restrict__ d1,
    const float* __restrict__ rn0, const float* __restrict__ rn1,
    const uint8_t* __restrict__ m0, const uint8_t* __restrict__ m1,
    const float* __restrict__ grow, const float* __restrict__ gcol, float h2,
    float fthr, float* __restrict__ pb, float* __restrict__ ps, int* __restrict__ pj,
    unsigned long long* __restrict__ colkey, int N0, int N1, int tiles_per_split) {
  constexpr int kGR = gate_rows(kGate), kGC = gate_cols(kGate);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sA = smem;                                   // [BM][PITCH]
  unsigned char* sB = sA + BM * PITCH;                        // [kStages][BN][PITCH]
  unsigned long long* sCol = reinterpret_cast<unsigned long long*>(sB + kStages * BN * PITCH);
  float* sRn1 = reinterpret_cast<float*>(sCol + 2 * BN);      // [kStages][BN]
  float* sGc = sRn1 + kStages * BN;                           // [kStages][kGC][BN]
  float* sGr = sGc + kStages * kGC * BN;                      // [kGR][BM]
  unsigned char* sM = reinterpret_cast<unsigned char*>(sGr + kGR * BM);  // [kStages][kMaskW]

  const int p = blockIdx.z, split = blockIdx.y, nsplit = gridDim.y;
  const int row0 = blockIdx.x * BM;
  const int tile0 = split * tiles_per_split;
  const int ntiles = min(tiles_per_split, (N1 + BN - 1) / BN - tile0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;   // row half, column quarter
  const int g = lane >> 2, tig = lane & 3;   // mma fragment: row group, column pair
  d0 += static_cast<size_t>(p) * N0 * KB;
  d1 += static_cast<size_t>(p) * N1 * KB;
  rn0 += static_cast<size_t>(p) * N0;
  rn1 += static_cast<size_t>(p) * N1;
  m0 += static_cast<size_t>(p) * N0;
  m1 += static_cast<size_t>(p) * N1;
  colkey += static_cast<size_t>(p) * N1;

  // the row tile (zeros beyond N0) and its gate operands, staged once
  for (int k = tid; k < BM * (KB / 16); k += kThreads) {
    const int r = k >> 3, ch = k & 7;
    const bool in = row0 + r < N0;
    cp_async16(sA + r * PITCH + ch * 16, d0 + static_cast<size_t>(in ? row0 + r : 0) * KB + ch * 16,
               in ? 16 : 0);
  }
  for (int k = tid; k < kGR * BM; k += kThreads) {
    const int gi = k / BM, r = k % BM;
    const bool in = row0 + r < N0;
    cp_async4(sGr + k, grow + (static_cast<size_t>(p) * kGR + gi) * N0 + (in ? row0 + r : 0),
              in ? 4 : 0);
  }
  // column tile t of this split into ring stage `buf`: d1 rows, rn1, the
  // column gate operands (zeros beyond N1), and the mask bytes as the
  // aligned 4-byte words that cover them (never past this pair's N1 bytes)
  auto stage = [&](int t, int buf) {
    const int c0 = (tile0 + t) * BN;
    for (int k = tid; k < BN * (KB / 16); k += kThreads) {
      const int c = k >> 3, ch = k & 7;
      const bool in = c0 + c < N1;
      cp_async16(sB + (buf * BN + c) * PITCH + ch * 16,
                 d1 + static_cast<size_t>(in ? c0 + c : 0) * KB + ch * 16, in ? 16 : 0);
    }
    const uintptr_t mfirst = reinterpret_cast<uintptr_t>(m1 + c0) & ~static_cast<uintptr_t>(3);
    const uintptr_t mend = reinterpret_cast<uintptr_t>(m1 + N1);
    for (int k = tid; k < (1 + kGC) * BN + kMaskWords; k += kThreads) {
      if (k < (1 + kGC) * BN) {
        const int gi = k / BN, c = k % BN;
        const bool in = c0 + c < N1;
        const int j = in ? c0 + c : 0;
        if (gi == 0)
          cp_async4(sRn1 + buf * BN + c, rn1 + j, in ? 4 : 0);
        else
          cp_async4(sGc + (buf * kGC + gi - 1) * BN + c,
                    gcol + (static_cast<size_t>(p) * kGC + gi - 1) * N1 + j, in ? 4 : 0);
      } else {
        const uintptr_t a = mfirst + 4 * (k - (1 + kGC) * BN);
        const int n = a >= mend ? 0 : (mend - a < 4 ? static_cast<int>(mend - a) : 4);
        cp_async4(sM + buf * kMaskW + 4 * (k - (1 + kGC) * BN),
                  n ? reinterpret_cast<const void*>(a) : static_cast<const void*>(m1), n);
      }
    }
  };
  stage(0, 0);
  cp_async_commit();

  // this thread's 8 rows: r(i) = wr*64 + (i>>1)*16 + (i&1)*8 + g, ascending in i
  float rnr[8];
  unsigned rowok = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + wr * 64 + (i >> 1) * 16 + (i & 1) * 8 + g;
    rnr[i] = gi < N0 ? rn0[gi] : 0.0f;
    if (gi < N0 && m0[gi]) rowok |= 1u << i;
  }
  float best[8], second[8];
  int bj[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = -INFINITY; second[i] = -INFINITY; bj[i] = 0x7fffffff;
  }

  const unsigned aBase = smem_u32(sA) +
                         (wr * 64 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16;
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const int c0 = (tile0 + t) * BN;
    if (t + 1 < ntiles) stage(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and the row tile) have landed
    __syncthreads();

    // ---- the 64 x 16 warp tile on the tensor cores ----
    int acc[4][2][4];
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0;
    const unsigned bBase = smem_u32(sB + buf * BN * PITCH) +
                           (wc * 16 + (lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks) {
      unsigned b[4];
      ldsm_x4(bBase + ks * 32, b);
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        unsigned a[4];
        ldsm_x4(aBase + mb * 16 * PITCH + ks * 32, a);
        mma_u8(acc[mb][0], a, b[0], b[1]);
        mma_u8(acc[mb][1], a, b[2], b[3]);
      }
    }

    // ---- epilogue in registers: 8 rows x 4 columns per thread ----
    // column q: cc = wc*16 + (q>>1)*8 + 2*tig + (q&1), ascending in q
    const int mo = static_cast<int>(reinterpret_cast<uintptr_t>(m1 + c0) & 3);
    float rnc[4];
    bool cok[4];
    int jc[4];
    float gc[4][kGC > 0 ? kGC : 1];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = wc * 16 + (q >> 1) * 8 + 2 * tig + (q & 1), j = c0 + cc;
      rnc[q] = sRn1[buf * BN + cc];
      cok[q] = j < N1 && sM[buf * kMaskW + mo + cc] != 0;
      jc[q] = j < N1 ? j : 0x7fffffff;   // beyond N1: never a row's argbest
#pragma unroll
      for (int k = 0; k < kGC; ++k) gc[q][k] = sGc[(buf * kGC + k) * BN + cc];
    }
    float v[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int mb = i >> 1, h = i & 1;
      float gr[kGR > 0 ? kGR : 1];
#pragma unroll
      for (int k = 0; k < kGR; ++k) gr[k] = sGr[k * BM + wr * 64 + mb * 16 + h * 8 + g];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bool ok = ((rowok >> i) & 1u) && cok[q];
        if constexpr ((kGate & kGateH) != 0) {
          const float dx = __fsub_rn(gr[0], gc[q][0]), dy = __fsub_rn(gr[1], gc[q][1]);
          ok = ok && __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < h2;
        }
        if constexpr ((kGate & kGateF) != 0) {
          constexpr int f = (kGate & kGateH) ? 2 : 0;
          const float x1 = gc[q][0], y1 = gc[q][1];
          const float da = fabsf(__fadd_rn(
              __fadd_rn(__fmul_rn(gr[f], x1), __fmul_rn(gr[f + 1], y1)), gr[f + 2]));
          const float db = fabsf(__fadd_rn(
              __fadd_rn(__fmul_rn(gr[f + 3], gc[q][2]), __fmul_rn(gr[f + 4], gc[q][3])),
              gc[q][4]));
          ok = ok && fmaxf(da, db) < fthr;
        }
        const float x = ok ? (static_cast<float>(acc[mb][q >> 1][h * 2 + (q & 1)]) * rnc[q]) * rnr[i]
                           : -INFINITY;
        v[i][q] = x;
        if (x > best[i] || (x == best[i] && jc[q] < bj[i])) {
          second[i] = best[i]; best[i] = x; bj[i] = jc[q];
        } else {
          second[i] = fmaxf(second[i], x);
        }
      }
    }
    // column side: argbest over the thread's 8 rows (ascending, strict >),
    // then over the 8 lanes of the column, as ordered keys
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float cb = v[0][q];
      int ci = 0;
#pragma unroll
      for (int i = 1; i < 8; ++i)
        if (v[i][q] > cb) { cb = v[i][q]; ci = i; }
      const unsigned row = static_cast<unsigned>(row0 + wr * 64 + (ci >> 1) * 16 + (ci & 1) * 8 + g);
      unsigned long long key =
          (static_cast<unsigned long long>(order_bits(cb)) << 32) | (0xffffffffu - row);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
        key = o > key ? o : key;
      }
      if (g == 0) sCol[wr * BN + wc * 16 + (q >> 1) * 8 + 2 * tig + (q & 1)] = key;
    }
    __syncthreads();
    if (tid < BN && c0 + tid < N1) {   // both row halves, then across row tiles
      const unsigned long long k0 = sCol[tid], k1 = sCol[BN + tid];
      atomicMax(&colkey[c0 + tid], k0 > k1 ? k0 : k1);
    }
  }
  cp_async_wait<0>();

  // ---- rows: the 4 lanes of a row, then the 4 column quarters, ascending ----
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float b2 = __shfl_xor_sync(0xffffffffu, best[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, second[i], off);
      const int j2 = __shfl_xor_sync(0xffffffffu, bj[i], off);
      merge2(best[i], second[i], bj[i], b2, s2, j2);
    }
  }
  // the ring's d1 stages are free now (every thread passed the last tile's
  // barrier): reuse them for the per-quarter row results
  float* sRB = reinterpret_cast<float*>(sB);   // [4][BM]
  float* sRS = sRB + 4 * BM;
  int* sRJ = reinterpret_cast<int*>(sRS + 4 * BM);
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = wr * 64 + (i >> 1) * 16 + (i & 1) * 8 + g;
      sRB[wc * BM + r] = best[i]; sRS[wc * BM + r] = second[i]; sRJ[wc * BM + r] = bj[i];
    }
  }
  __syncthreads();
  if (tid < BM && row0 + tid < N0) {
    float B = sRB[tid], S = sRS[tid];
    int J = sRJ[tid];
    for (int k = 1; k < 4; ++k) merge2(B, S, J, sRB[k * BM + tid], sRS[k * BM + tid], sRJ[k * BM + tid]);
    const size_t o = (static_cast<size_t>(p) * N0 + row0 + tid) * nsplit + split;
    pb[o] = B; ps[o] = S; pj[o] = J;
  }
}

// Merge each row's split partials in ascending split order; decode the
// column keys into rows.
__global__ void merge_rows_kernel(const float* __restrict__ pb, const float* __restrict__ ps,
                                  const int* __restrict__ pj, int nsplit,
                                  float* __restrict__ bsim, float* __restrict__ ssim,
                                  int* __restrict__ bestj, long long rows,
                                  const unsigned long long* __restrict__ colkey,
                                  int* __restrict__ colbest, long long cols) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < rows) {
    const size_t o = static_cast<size_t>(i) * nsplit;
    float B = pb[o], S = ps[o];
    int J = pj[o];
    for (int k = 1; k < nsplit; ++k) merge2(B, S, J, pb[o + k], ps[o + k], pj[o + k]);
    bsim[i] = B; ssim[i] = S; bestj[i] = J;
  } else if (i - rows < cols) {
    const long long c = i - rows;
    colbest[c] = static_cast<int>(0xffffffffu - static_cast<unsigned int>(colkey[c] & 0xffffffffull));
  }
}

template <int kGate>
int launch(const uint8_t* d0, const uint8_t* d1, const float* rn0, const float* rn1,
           const uint8_t* m0, const uint8_t* m1, const float* grow, const float* gcol,
           float h2, float fthr, float* bsim, float* ssim, int* bestj, int* colbest,
           unsigned long long* colkey, float* pb, float* ps, int* pj, int P, int N0,
           int N1, int tiles_per_split, int nsplit, cudaStream_t stream) {
  const int col_tiles = static_cast<int>(sift_ceil_div(N1, BN));
  if (P <= 0 || N0 <= 0 || N1 <= 0 || tiles_per_split <= 0 || nsplit <= 0 ||
      static_cast<long long>(nsplit) * tiles_per_split < col_tiles ||
      static_cast<long long>(nsplit - 1) * tiles_per_split >= col_tiles)
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes(kGate);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_best2_kernel<kGate>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(sift_ceil_div(N0, BM), nsplit, P);
  match_best2_kernel<kGate><<<grid, kThreads, smem, stream>>>(
      d0, d1, rn0, rn1, m0, m1, grow, gcol, h2, fthr, pb, ps, pj, colkey, N0, N1,
      tiles_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(P) * N0, cols = static_cast<long long>(P) * N1;
  merge_rows_kernel<<<sift_ceil_div(rows + cols, 256), 256, 0, stream>>>(
      pb, ps, pj, nsplit, bsim, ssim, bestj, rows, colkey, colbest, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// colkey [P, N1] must be zeroed; pb, ps, pj: [P, N0, nsplit] scratch.
extern "C" int match_best2_launch(
    const uint8_t* d0, const uint8_t* d1, const float* rn0, const float* rn1,
    const uint8_t* m0, const uint8_t* m1, float* bsim, float* ssim, int* bestj,
    int* colbest, unsigned long long* colkey, float* pb, float* ps, int* pj, int P,
    int N0, int N1, int tiles_per_split, int nsplit, cudaStream_t stream) {
  return launch<0>(d0, d1, rn0, rn1, m0, m1, nullptr, nullptr, 0.0f, 0.0f, bsim, ssim,
                   bestj, colbest, colkey, pb, ps, pj, P, N0, N1, tiles_per_split, nsplit,
                   stream);
}

// gate: 1 = H, 2 = F, 3 = both; grow [P, 2|5|7, N0], gcol [P, 2|5, N1].
extern "C" int match_best2_gated_launch(
    const uint8_t* d0, const uint8_t* d1, const float* rn0, const float* rn1,
    const uint8_t* m0, const uint8_t* m1, const float* grow, const float* gcol, float h2,
    float fthr, float* bsim, float* ssim, int* bestj, int* colbest,
    unsigned long long* colkey, float* pb, float* ps, int* pj, int P, int N0, int N1,
    int tiles_per_split, int nsplit, int gate, cudaStream_t stream) {
#define SIFT_GATED(G)                                                                     \
  launch<G>(d0, d1, rn0, rn1, m0, m1, grow, gcol, h2, fthr, bsim, ssim, bestj, colbest, \
            colkey, pb, ps, pj, P, N0, N1, tiles_per_split, nsplit, stream)
  switch (gate) {
    case kGateH: return SIFT_GATED(kGateH);
    case kGateF: return SIFT_GATED(kGateF);
    case kGateH | kGateF: return SIFT_GATED(kGateH | kGateF);
    default: return cudaErrorInvalidValue;
  }
#undef SIFT_GATED
}
