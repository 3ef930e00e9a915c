// small_eig: batched symmetric eigendecompositions (n = 3, 4, 9) and 3 x 3
// singular value decompositions, one thread per matrix, by cyclic Jacobi in
// float64.
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
// float64: cyclic sweeps over the pairs p < q in row order, each a Jacobi
// rotation J (theta = (a_qq - a_pp) / (2 a_pq), t the smaller root of
// t^2 + 2 theta t - 1 = 0, c = 1 / sqrt(t^2 + 1), s = t c) applied as A J,
// then J^T (A J), a_pq = a_qp = 0, V J; a pair with a_pq == 0 is skipped.
// Before each sweep the matrix stops when the sum of its squared
// off-diagonal entries (upper triangle, row order) is <= 1e-30 times the
// sum of its squared diagonal entries (a zero matrix stops at once), and
// after 20 sweeps at the latest.  Eigenvalues ascending (a stable sort of
// the diagonal: equal values keep their index order), each eigenvector's
// largest-magnitude component positive (the first of equal magnitudes).
// Out: w [B, n] and V [B, n, n] f32, the vectors in V's columns.
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
// What bounds it on the H100: float64 arithmetic and the latency of one
// thread's dependent chain — a 9 x 9 matrix takes ~7 sweeps of 36
// rotations, each ~80 dependent float64 operations; bytes are nothing
// (400 B in and out per 9 x 9 matrix).  The design is the simplest that is
// right: one thread per matrix, 128 threads a block, the matrix and its
// vectors in per-thread arrays (registers for n <= 4, local memory for
// n = 9).

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

}  // namespace

extern "C" int small_eigh_launch(const float* M, float* w, float* V, int batch, int n,
                                 cudaStream_t stream) {
  if (batch <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = sift_ceil_div(batch, kThreads);
  switch (n) {
    case 3: eigh_kernel<3><<<blocks, kThreads, 0, stream>>>(M, w, V, batch); break;
    case 4: eigh_kernel<4><<<blocks, kThreads, 0, stream>>>(M, w, V, batch); break;
    case 9: eigh_kernel<9><<<blocks, kThreads, 0, stream>>>(M, w, V, batch); break;
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
