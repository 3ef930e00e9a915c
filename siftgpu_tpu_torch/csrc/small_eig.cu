// small_eig: batched symmetric eigendecompositions (n = 3, 4, 9) and 3 x 3
// singular value decompositions by Jacobi in float64: one thread per matrix
// for n = 3, 4 and the SVD, one warp per matrix for n = 9.
//
// Replaces no TPU kernel.  The reference computes these with XLA's
// `jnp.linalg.eigh` / `jnp.linalg.svd` (siftgpu_tpu/geometry/epipolar.py's
// eight_point, siftgpu_tpu/geometry/pose.py's triangulate and
// decompose_essential).  On the card `torch.linalg.eigh` / `svd` read
// cuSOLVER's `info` on the host, which synchronises the stream and cannot
// be captured into a CUDA graph; this kernel reads no host value and
// allocates no workspace.  The plain version is a step-by-step PyTorch
// mirror of the same arithmetic (siftgpu_tpu_torch/ops/small_eig.py,
// `eigh_sym_plain`, `svd3_plain`); built with -fmad=false, every product
// and sum rounds as the mirror's float64 ops do, so the two are
// bit-identical.
//
// eigh (small_eigh_launch): M [B, n, n] f32, its lower triangle read (the
// matrix is taken as symmetric, as torch.linalg.eigh's default).  In
// float64, sweeps of Jacobi rotations J (theta = (a_qq - a_pp) / (2 a_pq),
// t the smaller root of t^2 + 2 theta t - 1 = 0, c = 1 / sqrt(t^2 + 1),
// s = t c), each applied as A J, then J^T (A J), a_pq = a_qp = 0, V J; a
// pair with a_pq == 0 is skipped.  n = 3, 4: a sweep is the pairs p < q in
// row order, one rotation after another.  n = 9: a sweep is the 9 rounds
// of kRounds9, each 4 disjoint pairs (and the pad index 9 with the fifth
// index, which does nothing), every pair p < q once a sweep; a round forms
// its rotations from the round's A, then applies them together: each 2 x 2
// block (pair i rows, pair j columns, i <= j in the round's order) becomes
// R_i^T (A R_j), the column rotation first, and is mirrored into block
// (j, i), so A stays exactly symmetric.  Before each sweep the matrix
// stops when the sum of its squared off-diagonal entries (upper triangle,
// row order) is <= 1e-30 times the sum of its squared diagonal entries (a
// zero matrix stops at once), and after 20 sweeps at the latest.
// Eigenvalues ascending (a stable sort of the diagonal: equal values keep
// their index order), each eigenvector's largest-magnitude component
// positive (the first of equal magnitudes).  Out: w [B, n] and V [B, n, n]
// f32, the vectors in V's columns.
//
// svd3 (small_svd3_launch): A [B, 3, 3] f32.  In float64: the eigh above
// of A^T A (each entry summed over k = 0, 1, 2 in that order), its vectors
// in descending order of eigenvalue as V (the ascending order reversed);
// b_j = A v_j; u_1 = b_1 / |b_1| (e_1 if b_1 = 0), s_1 = |b_1|; r = b_2 -
// (u_1 . b_2) u_1, u_2 = r / |r| and s_2 = min(|r|, s_1) if |r| > 1e-13
// s_1, else u_2 = e_k - u_1k u_1 normalised, k the index of u_1's smallest
// magnitude (the first of equal ones), and s_2 = min(|r|, s_1); u_3 = u_1 x
// u_2, negated if u_3 . b_3 < 0, s_3 = min(|u_3 . b_3|, s_2).  Out: U [B,
// 3, 3] (u_j in its columns), S [B, 3] descending, Vh [B, 3, 3] (v_j in
// its rows), f32: A = U diag(S) Vh as torch.linalg.svd gives it.  The
// eigen route of A^T A rather than a one-sided Jacobi: one solver serves
// both functions, and in float64 the squared condition number costs
// nothing the f32 outputs can show (a singular value near 0 comes from
// |u_3 . b_3|, not from the square root of an eigenvalue).
//
// What bounds it on the H100: the latency of float64 chains; bytes are
// nothing (400 B in and out per 9 x 9 matrix) and the operations far
// below the f64 rate.  n = 9 (the two-view path's [512, 9, 9] eight-point
// solves and its lone [9, 9] refits, where the time went): one thread per
// matrix ran ~7 sweeps of 36 dependent rotations, its 9 x 9 arrays in local
// memory, and a [512, 9, 9] call filled 4 SMs.  Now one warp per matrix,
// 4 warps a block ([512, 9, 9]: 128 blocks on 132 SMs), A (padded to 10 x
// 10) and V in float64 in shared memory (1.6 KB a warp).  A sweep's 36
// dependent rotations become 9 rounds of two phases: lanes 1-4 form the
// round's 4 rotations (a divide, a square root, a reciprocal, a square root
// and a reciprocal in a row: the critical path), then every lane runs one
// code on one item, in place: lanes 0-13 a 2 x 2 block of A (two dependent
// multiply-subtracts an entry, then the mirror), lanes 14-25 three rows of
// V by one rotation.  The convergence test sums in one lane (the
// off-diagonal squares in lane 0, the diagonal in lane 1); the sort ranks
// each diagonal entry in its own lane.  n = 3, 4 and the SVD keep one
// thread per matrix in registers: the [4, N, 4, 4] triangulation solves
// already fill the card, the 3 x 3 calls sit at launch latency.
//
// Arithmetic goes through shared memory in phases (`warp_phase`: each lane
// runs the phase, then the warp synchronises), and within a phase no two
// lanes touch one entry; no value moves between lanes otherwise.  So the
// arithmetic can be checked on a host without nvcc: compile this file's
// anonymous namespace with -ffp-contract=off, SIFT_HOST_CHECK defined, the
// CUDA keywords defined away and `warp_phase` a loop over the 32 lanes
// (tests/test_torch_small_eig.py does).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 20;
constexpr double kTol = 1e-30;    // off-diagonal squares against diagonal squares
constexpr double kRank = 1e-13;   // a second singular vector below this is completed

// Jacobi on the symmetric a[N][N], v[N][N] = I on entry: on return a's
// diagonal holds the eigenvalues and v's columns the vectors.
template <int N>
__device__ void jacobi(double (&a)[N][N], double (&v)[N][N]) {
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0, dd = 0.0;
    for (int p = 0; p < N - 1; ++p)
      for (int q = p + 1; q < N; ++q) off = off + a[p][q] * a[p][q];
    for (int i = 0; i < N; ++i) dd = dd + a[i][i] * a[i][i];
    if (off <= kTol * dd) break;
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const double apq = a[p][q];
        if (apq == 0.0) continue;
        const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
        double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double s = t * c;
#pragma unroll
        for (int k = 0; k < N; ++k) {   // A J: columns p and q
          const double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {   // J^T (A J): rows p and q
          const double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        a[p][q] = 0.0;
        a[q][p] = 0.0;
#pragma unroll
        for (int k = 0; k < N; ++k) {   // V J
          const double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

// The eigen decomposition of the symmetric a (a and v overwritten): w
// ascending and the matching vectors in vs's columns, signed.
template <int N>
__device__ void eigh_sorted(double (&a)[N][N], double (&w)[N], double (&vs)[N][N]) {
  double v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  jacobi<N>(a, v);
  int perm[N];
#pragma unroll
  for (int i = 0; i < N; ++i) perm[i] = i;
  for (int i = 1; i < N; ++i)   // insertion sort: stable
    for (int j = i; j > 0 && a[perm[j - 1]][perm[j - 1]] > a[perm[j]][perm[j]]; --j) {
      const int x = perm[j];
      perm[j] = perm[j - 1];
      perm[j - 1] = x;
    }
  for (int j = 0; j < N; ++j) {
    const int src = perm[j];
    w[j] = a[src][src];
    int big = 0;
    for (int k = 1; k < N; ++k)
      if (fabs(v[k][src]) > fabs(v[big][src])) big = k;
    const bool neg = v[big][src] < 0.0;
    for (int k = 0; k < N; ++k) vs[k][j] = neg ? -v[k][src] : v[k][src];
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    eigh_kernel(const float* __restrict__ M, float* __restrict__ w, float* __restrict__ V,
                int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* m = M + static_cast<size_t>(b) * N * N;
  double a[N][N], ev[N], vs[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      a[i][j] = static_cast<double>(i >= j ? m[i * N + j] : m[j * N + i]);
  eigh_sorted<N>(a, ev, vs);
  float* wo = w + static_cast<size_t>(b) * N;
  float* vo = V + static_cast<size_t>(b) * N * N;
  for (int j = 0; j < N; ++j) wo[j] = __double2float_rn(ev[j]);
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) vo[i * N + j] = __double2float_rn(vs[i][j]);
}

__device__ __forceinline__ double dot3(const double* x, const double* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

__global__ void __launch_bounds__(kThreads)
    svd3_kernel(const float* __restrict__ A, float* __restrict__ U, float* __restrict__ S,
                float* __restrict__ Vh, int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* ap = A + static_cast<size_t>(b) * 9;
  double x[3][3], g[3][3], ev[3], vs[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) x[i / 3][i % 3] = static_cast<double>(ap[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      g[i][j] = x[0][i] * x[0][j] + x[1][i] * x[1][j] + x[2][i] * x[2][j];
  eigh_sorted<3>(g, ev, vs);
  double v[3][3], bc[3][3];   // v[j]: the j-th right vector (descending); bc[j] = A v[j]
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) v[j][k] = vs[k][2 - j];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < 3; ++r)
      bc[j][r] = x[r][0] * v[j][0] + x[r][1] * v[j][1] + x[r][2] * v[j][2];
  double u[3][3], s[3];       // u[j]: the j-th left vector
  const double n1 = sqrt(dot3(bc[0], bc[0]));
#pragma unroll
  for (int r = 0; r < 3; ++r) u[0][r] = n1 > 0.0 ? bc[0][r] / n1 : (r == 0 ? 1.0 : 0.0);
  s[0] = n1;
  const double d = dot3(u[0], bc[1]);
  double rr[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) rr[r] = bc[1][r] - d * u[0][r];
  const double n2 = sqrt(dot3(rr, rr));
  if (!(n2 > kRank * n1)) {   // complete u_1 with the axis it least points along
    int k = 0;
    for (int r = 1; r < 3; ++r)
      if (fabs(u[0][r]) < fabs(u[0][k])) k = r;
#pragma unroll
    for (int r = 0; r < 3; ++r) rr[r] = (r == k ? 1.0 : 0.0) - u[0][k] * u[0][r];
  }
  const double nr = sqrt(dot3(rr, rr));
#pragma unroll
  for (int r = 0; r < 3; ++r) u[1][r] = rr[r] / nr;
  s[1] = fmin(n2, n1);
  u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
  u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
  u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
  double d3 = dot3(u[2], bc[2]);
  if (d3 < 0.0) {
#pragma unroll
    for (int r = 0; r < 3; ++r) u[2][r] = -u[2][r];
    d3 = -d3;
  }
  s[2] = fmin(d3, s[1]);
  float* uo = U + static_cast<size_t>(b) * 9;
  float* so = S + static_cast<size_t>(b) * 3;
  float* vo = Vh + static_cast<size_t>(b) * 9;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    so[j] = __double2float_rn(s[j]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      uo[r * 3 + j] = __double2float_rn(u[j][r]);
      vo[j * 3 + r] = __double2float_rn(v[j][r]);
    }
  }
}

// ---- n = 9: one warp per matrix ----

#ifndef SIFT_HOST_CHECK
// One phase of a warp's work: every lane runs `body(lane)`, then the warp
// synchronises.  Phases share values through shared memory only.
template <class Body>
__device__ __forceinline__ void warp_phase(Body body) {
  body(static_cast<int>(threadIdx.x & 31u));
  __syncwarp();
}
#endif

constexpr int kWarps9 = 4;   // matrices (warps) a block
constexpr int kPad9 = 9;     // the index that pads 0..8 to 10
// Lane L < 14 updates block (i, j) of a round, i and j its nibble L of
// these: the pairs i <= j of slots 0..4 in row order but (0, 0), decoded in
// registers (a decoding loop would run a different count in each lane).
constexpr unsigned long long kBlockI9 = 0x43322211110000ull;
constexpr unsigned long long kBlockJ9 = 0x44343243214321ull;

// The round-robin schedule: round r pairs index r with the pad, and
// (r + k) mod 9 with (r - k) mod 9 for k = 1..4, each pair as (p < q).
// Every pair p < q of 0..8 appears once in the 9 rounds.
__constant__ int kRounds9[9][5][2] = {
    {{0, 9}, {1, 8}, {2, 7}, {3, 6}, {4, 5}},
    {{1, 9}, {0, 2}, {3, 8}, {4, 7}, {5, 6}},
    {{2, 9}, {1, 3}, {0, 4}, {5, 8}, {6, 7}},
    {{3, 9}, {2, 4}, {1, 5}, {0, 6}, {7, 8}},
    {{4, 9}, {3, 5}, {2, 6}, {1, 7}, {0, 8}},
    {{5, 9}, {4, 6}, {3, 7}, {2, 8}, {0, 1}},
    {{6, 9}, {5, 7}, {4, 8}, {0, 3}, {1, 2}},
    {{7, 9}, {6, 8}, {0, 5}, {1, 4}, {2, 3}},
    {{8, 9}, {0, 7}, {1, 6}, {2, 5}, {3, 4}},
};

// A warp's matrix in shared memory, and its round's pairs and rotations by
// slot (slot 0 holds the pad pair and never rotates).  A is padded to 10 x
// 10: row and column 9 (the pad) stay 0, so every block is 2 x 2.
struct Eig9 {
  double a[10][10];
  double v[9][9];
  double c[5], s[5];
  int p[5], q[5], rot[5];
  double off, dd;
  int perm[9];
};

// Lane `slot` (0..4) of round r: the slot's pair and its rotation.
__device__ __forceinline__ void rotation9(Eig9& w, int slot, int r) {
  const int p = kRounds9[r][slot][0], q = kRounds9[r][slot][1];
  const double apq = w.a[p][q];
  const int rot = q != kPad9 && apq != 0.0;
  double c = 1.0, s = 0.0;
  if (rot) {
    const double theta = (w.a[q][q] - w.a[p][p]) / (2.0 * apq);
    double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
    if (theta < 0.0) t = -t;
    c = 1.0 / sqrt(t * t + 1.0);
    s = t * c;
  }
  w.p[slot] = p;
  w.q[slot] = q;
  w.c[slot] = c;
  w.s[slot] = s;
  w.rot[slot] = rot;
}

// One lane's share of a round, in place (no two lanes touch one entry):
// lanes 0-13 the 2 x 2 blocks (slot i rows, slot j columns) i <= j of A
// but (0, 0), which does not change: R_i^T (A R_j), the column rotation
// first, mirrored into block (j, i) (A stays exactly symmetric), a rotated
// pair's own a_pq, a_qp set to 0; lanes 14-25 rows 3t..3t+2 of V times
// slot j's rotation (t = 0..2, j = 1..4).  Both are rows x0, x1 (, x2) by
// the columns of slot j: one code for every lane.
__device__ __forceinline__ void update9(Eig9& w, int lane) {
  if (lane >= 26) return;
  const bool on_a = lane < 14;
  int i, j;
  if (on_a) {
    i = static_cast<int>((kBlockI9 >> (4 * lane)) & 15u);
    j = static_cast<int>((kBlockJ9 >> (4 * lane)) & 15u);
  } else {
    i = 0;        // V: no row rotation (slot 0 never rotates)
    j = 1 + (lane - 14) % 4;
  }
  const int t = (lane - 14) / 4;
  const int x0 = on_a ? w.p[i] : 3 * t, x1 = on_a ? w.q[i] : 3 * t + 1, x2 = 3 * t + 2;
  const int yp = w.p[j], yq = w.q[j];
  double* m0 = on_a ? &w.a[x0][0] : &w.v[x0][0];
  double* m1 = on_a ? &w.a[x1][0] : &w.v[x1][0];
  const double cj = w.c[j], sj = w.s[j], ci = w.c[i], si = w.s[i];
  const bool rj = w.rot[j], ri = w.rot[i];
  // A R_j: columns yp, yq of each row
  const double a0p = m0[yp], a0q = m0[yq], a1p = m1[yp], a1q = m1[yq];
  const double b0p = rj ? cj * a0p - sj * a0q : a0p, b0q = rj ? sj * a0p + cj * a0q : a0q;
  const double b1p = rj ? cj * a1p - sj * a1q : a1p, b1q = rj ? sj * a1p + cj * a1q : a1q;
  if (!on_a) {   // V's third row
    const double a2p = w.v[x2][yp], a2q = w.v[x2][yq];
    w.v[x2][yp] = rj ? cj * a2p - sj * a2q : a2p;
    w.v[x2][yq] = rj ? sj * a2p + cj * a2q : a2q;
  }
  // R_i^T (A R_j): rows x0 = p_i, x1 = q_i
  double c0p = ri ? ci * b0p - si * b1p : b0p, c1p = ri ? si * b0p + ci * b1p : b1p;
  double c0q = ri ? ci * b0q - si * b1q : b0q, c1q = ri ? si * b0q + ci * b1q : b1q;
  if (on_a && i == j && ri) c0q = c1p = 0.0;
  m0[yp] = c0p;
  m0[yq] = c0q;
  m1[yp] = c1p;
  m1[yq] = c1q;
  if (on_a && i != j) {
    w.a[yp][x0] = c0p;
    w.a[yq][x0] = c0q;
    w.a[yp][x1] = c1p;
    w.a[yq][x1] = c1q;
  }
}

// The eigh of one 9 x 9 matrix m (f32, lower triangle read) by one warp:
// w ascending into wo, the signed vectors into vo's columns.
__device__ void eigh9_warp(Eig9& w, const float* m, float* wo, float* vo) {
  warp_phase([&](int lane) {
    for (int e = lane; e < 100; e += 32) {
      const int i = e / 10, j = e % 10;
      w.a[i][j] = i < 9 && j < 9 ? static_cast<double>(i >= j ? m[i * 9 + j] : m[j * 9 + i])
                                 : 0.0;
      if (i < 9 && j < 9) w.v[i][j] = i == j ? 1.0 : 0.0;
    }
  });
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    warp_phase([&](int lane) {   // unrolled: the loads issue at once, the sums stay in order
      if (lane == 0) {
        double off = 0.0;
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = p + 1; q < 9; ++q) off = off + w.a[p][q] * w.a[p][q];
        w.off = off;
      } else if (lane == 1) {
        double dd = 0.0;
#pragma unroll
        for (int i = 0; i < 9; ++i) dd = dd + w.a[i][i] * w.a[i][i];
        w.dd = dd;
      }
    });
    if (w.off <= kTol * w.dd) break;
    for (int r = 0; r < 9; ++r) {
      warp_phase([&](int lane) {
        if (lane < 5) rotation9(w, lane, r);
      });
      warp_phase([&](int lane) { update9(w, lane); });
    }
  }
  warp_phase([&](int lane) {   // a stable ascending sort of the diagonal by rank, NaN last
    if (lane >= 9) return;
    const double d = w.a[lane][lane];
    int rank = 0;
    for (int k = 0; k < 9; ++k) {
      const double e = w.a[k][k];
      const bool before = e < d || (d != d && e == e);
      const bool tie = e == d || (d != d && e != e);
      rank += before || (tie && k < lane);
    }
    w.perm[rank] = lane;
  });
  warp_phase([&](int lane) {
    if (lane >= 9) return;
    const int src = w.perm[lane];
    wo[lane] = __double2float_rn(w.a[src][src]);
    int big = 0;
    for (int k = 1; k < 9; ++k)
      if (fabs(w.v[k][src]) > fabs(w.v[big][src])) big = k;
    const bool neg = w.v[big][src] < 0.0;
    for (int k = 0; k < 9; ++k)
      vo[k * 9 + lane] = __double2float_rn(neg ? -w.v[k][src] : w.v[k][src]);
  });
}

__global__ void __launch_bounds__(kWarps9 * 32)
    eigh9_kernel(const float* __restrict__ M, float* __restrict__ w, float* __restrict__ V,
                 int batch) {
  __shared__ Eig9 sh[kWarps9];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int b = static_cast<int>(blockIdx.x) * kWarps9 + warp;
  if (b >= batch) return;   // the whole warp
  eigh9_warp(sh[warp], M + static_cast<size_t>(b) * 81, w + static_cast<size_t>(b) * 9,
             V + static_cast<size_t>(b) * 81);
}

}  // namespace

extern "C" int small_eigh_launch(const float* M, float* w, float* V, int batch, int n,
                                 cudaStream_t stream) {
  if (batch <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = sift_ceil_div(batch, kThreads);
  switch (n) {
    case 3: eigh_kernel<3><<<blocks, kThreads, 0, stream>>>(M, w, V, batch); break;
    case 4: eigh_kernel<4><<<blocks, kThreads, 0, stream>>>(M, w, V, batch); break;
    case 9:
      eigh9_kernel<<<sift_ceil_div(batch, kWarps9), kWarps9 * 32, 0, stream>>>(M, w, V, batch);
      break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int small_svd3_launch(const float* A, float* U, float* S, float* Vh, int batch,
                                 cudaStream_t stream) {
  if (batch <= 0) return cudaErrorInvalidValue;
  svd3_kernel<<<sift_ceil_div(batch, kThreads), kThreads, 0, stream>>>(A, U, S, Vh, batch);
  return static_cast<int>(cudaGetLastError());
}
