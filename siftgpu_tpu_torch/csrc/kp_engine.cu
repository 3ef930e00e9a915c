// orient_sample: fused orientation assignment + descriptor gradient sampling,
// one thread block per keypoint.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/kp_engine.py::orient_sample
// (bodies `_kernel` and `_compute_block`).  Semantics are those of the plain
// version, siftgpu_tpu_torch/ops/kp_engine.py::orient_sample_plain.  The
// TPU layout devices (8x128 window snapping, quad/pair-packed histogram
// lanes, packed-u32 gradient planes, the block-size knob) are not carried
// over: they are layout, not semantics.
//
// What bounds it on the H100: per keypoint a (2R+1)^2 bf16 window (35^2 at
// the default config, 4.9 KB) and up to 2 x 256 bilinear samples of 4 taps
// each; the gathers are scattered, so it is bound by memory latency and
// the per-pixel atan2/sqrt/polynomial, not by bandwidth.  The simple design:
//   1. the block gathers the window into shared memory, upcast to f32;
//   2. each of the 256 threads builds a private 36-bin histogram of its
//      pixels in shared memory (column tid of a [nb][256] array, so no two
//      threads share a bank or an address); the private histograms are
//      summed in a fixed order (32-thread partials, then 8 partials per
//      bin).  Shared-memory float atomics would make the result depend on
//      the order in which threads arrive;
//   3. 36 threads smooth x6; thread 0 selects the peaks exactly as the plain
//      version (stable ranking, ties to the lowest bin) and refines them;
//   4. per orientation slot that is sampled, one thread per grid sample
//      does the bilinear gather from the bf16 plane in global memory.
// Compiled with -fmad=false, so every expression rounds as in the plain
// version; atan2f/cosf/sinf may differ from PyTorch's CPU functions in the
// last ulp, which the parity budgets allow for.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOri = 8;
constexpr int kMaxBins = 64;

__constant__ float kExpW[8] = {
    2.1755081222e-05f, 5.1727565826e-04f, 5.5559910437e-03f,
    3.6198773900e-02f, 1.6038511456e-01f, 4.9620069315e-01f,
    9.9901960879e-01f, 9.9993781360e-01f};

__device__ __forceinline__ float exp_window(float x) {
  x = fmaxf(x, -4.75f);
  float acc = kExpW[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) acc = acc * x + kExpW[i];
  return acc;
}

struct Params {
  int Hp, Wp, h_true, w_true, R, nb, nori, G;
  float sig_f, rad_f, peak, spacing, spc_cell, smax, bin_scale, two_pi;
};

__global__ void __launch_bounds__(kThreads) orient_sample_kernel(
    const __nv_bfloat16* __restrict__ gx, const __nv_bfloat16* __restrict__ gy,
    const int* __restrict__ plane, const float* __restrict__ ky,
    const float* __restrict__ kx, const float* __restrict__ sigma_in,
    const uint8_t* __restrict__ mask, float* __restrict__ theta_out,
    uint8_t* __restrict__ haspk_out, float* __restrict__ sgx,
    float* __restrict__ sgy, Params P) {
  extern __shared__ float smem[];
  __shared__ float s_theta[kMaxOri];
  __shared__ int s_has[kMaxOri];
  const int n = blockIdx.x, tid = threadIdx.x;
  const int nb = P.nb, nori = P.nori, G2 = P.G * P.G;
  const int win = 2 * P.R + 1, P2 = win * win;
  const size_t out0 = static_cast<size_t>(n) * nori * G2;

  if (!mask[n]) {  // masked keypoint: zeros everywhere
    if (tid < nori) {
      theta_out[n * nori + tid] = 0.0f;
      haspk_out[n * nori + tid] = 0;
    }
    for (int k = tid; k < nori * G2; k += kThreads) {
      sgx[out0 + k] = 0.0f;
      sgy[out0 + k] = 0.0f;
    }
    return;
  }

  float* wgx = smem;                       // [P2]
  float* wgy = wgx + P2;                   // [P2]
  float* hist = wgy + P2;                  // [nb][kThreads] private histograms
  float* part = hist + nb * kThreads;      // [nb][8]
  float* hs = part + nb * 8;               // [2][nb] smoothing buffers

  const float y = ky[n], x = kx[n];
  const float sig = fminf(sigma_in[n], P.smax);
  const int iy = static_cast<int>(rintf(y)), ix = static_cast<int>(rintf(x));
  const int sy = min(max(iy - P.R, 0), P.Hp - win);
  const int sx = min(max(ix - P.R, 0), P.Wp - win);
  const size_t pbase = static_cast<size_t>(plane[n]) * P.Hp * P.Wp;
  const __nv_bfloat16* pgx = gx + pbase;
  const __nv_bfloat16* pgy = gy + pbase;

  // ---- 1. window -> shared (f32) ----
  for (int p = tid; p < P2; p += kThreads) {
    const int r = p / win, c = p % win;
    const size_t g = static_cast<size_t>(sy + r) * P.Wp + (sx + c);
    wgx[p] = __bfloat162float(pgx[g]);
    wgy[p] = __bfloat162float(pgy[g]);
  }
  for (int b = 0; b < nb; ++b) hist[b * kThreads + tid] = 0.0f;
  __syncthreads();

  // ---- 2. private histograms, then a fixed-order sum ----
  const float sw = P.sig_f * sig;
  const float radius = P.rad_f * sw;
  const float rad2 = radius * radius;
  const float den = 2.0f * (sw * sw);
  for (int p = tid; p < P2; p += kThreads) {
    const int r = p / win, c = p % win;
    const int row = sy + r, col = sx + c;
    const float oy = static_cast<float>(row) - y;
    const float ox = static_cast<float>(col) - x;
    const float r2 = oy * oy + ox * ox;
    float w = exp_window(-r2 / den);
    w = r2 <= rad2 ? w : 0.0f;
    w = w * (row < P.h_true ? 1.0f : 0.0f);
    const float vx = wgx[p], vy = wgy[p];
    const float mag = sqrtf(vx * vx + vy * vy);
    float ang = atan2f(vy, vx);
    if (ang < 0.0f) ang = ang + P.two_pi;
    const int bin = min(max(static_cast<int>(ang * P.bin_scale), 0), nb - 1);
    hist[bin * kThreads + tid] += w * mag;
  }
  __syncthreads();
  for (int k = tid; k < nb * 8; k += kThreads) {
    const int b = k >> 3, q = k & 7;
    float s = 0.0f;
    for (int i = 0; i < 32; ++i) s += hist[b * kThreads + q * 32 + ((i + k) & 31)];
    part[k] = s;
  }
  __syncthreads();
  if (tid < nb) {
    float s = 0.0f;
    for (int q = 0; q < 8; ++q) s += part[tid * 8 + q];
    hs[tid] = s;
  }
  __syncthreads();

  // ---- 3. smoothing x6, peaks, parabola refinement ----
  float* cur = hs;
  float* nxt = hs + nb;
  for (int round = 0; round < 6; ++round) {
    if (tid < nb)
      nxt[tid] = ((cur[(tid + nb - 1) % nb] + cur[tid]) + cur[(tid + 1) % nb]) / 3.0f;
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  if (tid == 0) {
    float mx = -INFINITY;
    for (int b = 0; b < nb; ++b) mx = fmaxf(mx, cur[b]);
    unsigned long long chosen = 0ull;
    for (int o = 0; o < nori; ++o) {
      int idx = -1;
      float m = -INFINITY;
      for (int b = 0; b < nb; ++b) {
        if ((chosen >> b) & 1ull) continue;
        const float h = cur[b];
        const bool pk = (h > cur[(b + nb - 1) % nb]) && (h > cur[(b + 1) % nb]) &&
                        (h >= P.peak * mx) && (mx > 0.0f);
        const float pv = pk ? h : -INFINITY;
        if (idx < 0 || pv > m) { m = pv; idx = b; }
      }
      chosen |= 1ull << idx;
      const bool has = m != -INFINITY;
      const float li = cur[(idx + nb - 1) % nb], ci = cur[idx], ri = cur[(idx + 1) % nb];
      const float denom = (li - 2.0f * ci) + ri;
      const float d = fabsf(denom) < 1e-12f ? 0.0f : (0.5f * (li - ri)) / denom;
      float th = (P.two_pi * ((static_cast<float>(idx) + 0.5f) + d)) / static_cast<float>(nb);
      if (th >= P.two_pi) th = th - P.two_pi;
      th = has ? th : 0.0f;
      s_theta[o] = th;
      s_has[o] = has;
      theta_out[n * nori + o] = th;
      haspk_out[n * nori + o] = has ? 1 : 0;
    }
  }
  __syncthreads();

  // ---- 4. rotated-grid bilinear samples, zero outside the true image ----
  const float half = (P.G - 1) * 0.5f;
  const float spc = (P.spacing * sig) / P.spc_cell;
  for (int o = 0; o < nori; ++o) {
    const bool keep = (o == 0) || s_has[o];
    const float th = s_theta[o];
    const float ct = cosf(th), st = sinf(th);
    for (int g = tid; g < G2; g += kThreads) {
      float ox = 0.0f, oyv = 0.0f;
      if (keep) {
        const float u = (static_cast<float>(g % P.G) - half) * spc;
        const float v = (static_cast<float>(g / P.G) - half) * spc;
        const float px = (x + ct * u) - st * v;
        const float py = (y + st * u) + ct * v;
        const int x0 = static_cast<int>(fminf(fmaxf(floorf(px), 0.0f), static_cast<float>(P.Wp - 1)));
        const int y0 = static_cast<int>(fminf(fmaxf(floorf(py), 0.0f), static_cast<float>(P.Hp - 1)));
        const int x1 = min(x0 + 1, P.Wp - 1), y1 = min(y0 + 1, P.Hp - 1);
        const float fx = fminf(fmaxf(px - static_cast<float>(x0), 0.0f), 1.0f);
        const float fy = fminf(fmaxf(py - static_cast<float>(y0), 0.0f), 1.0f);
        const bool inb = (px >= 0.0f) && (px <= static_cast<float>(P.w_true - 1)) &&
                         (py >= 0.0f) && (py <= static_cast<float>(P.h_true - 1));
        const size_t i00 = static_cast<size_t>(y0) * P.Wp + x0;
        const size_t i01 = static_cast<size_t>(y0) * P.Wp + x1;
        const size_t i10 = static_cast<size_t>(y1) * P.Wp + x0;
        const size_t i11 = static_cast<size_t>(y1) * P.Wp + x1;
        const float a = 1.0f - fy, bb = 1.0f - fx;
        const float vx = (((__bfloat162float(pgx[i00]) * a) * bb + (__bfloat162float(pgx[i01]) * a) * fx)
                          + (__bfloat162float(pgx[i10]) * fy) * bb) + (__bfloat162float(pgx[i11]) * fy) * fx;
        const float vy = (((__bfloat162float(pgy[i00]) * a) * bb + (__bfloat162float(pgy[i01]) * a) * fx)
                          + (__bfloat162float(pgy[i10]) * fy) * bb) + (__bfloat162float(pgy[i11]) * fy) * fx;
        const float m = inb ? 1.0f : 0.0f;
        ox = vx * m;
        oyv = vy * m;
      }
      sgx[out0 + static_cast<size_t>(o) * G2 + g] = ox;
      sgy[out0 + static_cast<size_t>(o) * G2 + g] = oyv;
    }
  }
}

}  // namespace

extern "C" int orient_sample_launch(
    const __nv_bfloat16* gx, const __nv_bfloat16* gy, const int* plane,
    const float* ky, const float* kx, const float* sigma, const uint8_t* mask,
    float* theta, uint8_t* haspk, float* sgx, float* sgy, int N, int Hp,
    int Wp, int h_true, int w_true, int R, int nb, int nori, int G,
    float sig_f, float rad_f, float peak, float spacing, float spc_cell,
    float smax, float bin_scale, float two_pi, cudaStream_t stream) {
  if (nori > kMaxOri || nb > kMaxBins || nb < 3 || N <= 0) return cudaErrorInvalidValue;
  const int win = 2 * R + 1;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(win) * win + nb * kThreads + nb * 8 + 2 * nb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        orient_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params P{Hp, Wp, h_true, w_true, R, nb, nori, G,
           sig_f, rad_f, peak, spacing, spc_cell, smax, bin_scale, two_pi};
  orient_sample_kernel<<<N, kThreads, smem, stream>>>(
      gx, gy, plane, ky, kx, sigma, mask, theta, haspk, sgx, sgy, P);
  return static_cast<int>(cudaGetLastError());
}
