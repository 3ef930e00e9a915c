// orient_sample: fused orientation assignment + descriptor gradient sampling,
// one warp per keypoint.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/kp_engine.py::orient_sample
// (bodies `_kernel` and `_compute_block`).  Semantics are those of the plain
// version, siftgpu_tpu_torch/ops/kp_engine.py::orient_sample_plain.  The
// TPU layout devices (8x128 window snapping, quad/pair-packed histogram
// lanes, packed-u32 gradient planes, the block-size knob) are not carried
// over: they are layout, not semantics.
//
// What bounds it on the H100: bytes, by its count (the sgx/sgy outputs,
// 2 x 512 f32 per keypoint, 65 MB for the main path's 15,872 keypoints,
// beside ~20 MB of bf16 gradient planes: ~25 us at 3.35 TB/s); the window
// math (1,225 pixels of atan2, sqrt and a degree-7 polynomial per keypoint)
// is ~1 GFLOP.  In practice each keypoint is a short dependent chain —
// gather the window, histogram, smooth, pick peaks, gather the samples — so
// what sets the time is latency and how many keypoints are in flight.  The
// first design gave each keypoint a 256-thread block with 36 KB of private
// histograms, ~12 block barriers and a peak search on one thread.  This one:
//   - one warp per keypoint, 8 keypoints per 256-thread block, no block
//     barrier after the start: a warp's keypoint is its own; registers
//     capped so 4 blocks (32 warps) fit an SM;
//   - keypoints are strided over the blocks (warp w of block b takes
//     keypoint w * blocks + b), so an octave's live keypoints, which come
//     first, spread over every SM;
//   - only the window's pixels that can lie inside the weighting circle are
//     visited (the others have weight 0 and add nothing): ~15x15 of the 35x35
//     at a typical scale.  They are read straight from the bf16 planes (lanes
//     on consecutive pixels of a row), 8 per lane loaded before any is used:
//     a keypoint is a chain of dependent steps, and latency is its longest
//     link;
//   - each lane keeps a private 36-bin histogram in the warp's [nb][32]
//     shared slice (column = lane: no atomics, no bank conflicts); bin b is
//     then summed by one lane over the 32 partials in a fixed rotated order
//     (deterministic, conflict-free);
//   - smoothing x6 in the warp's slice with __syncwarp; the max and each
//     peak by warp reductions: a peak is the arg-max of an ordered key of
//     its value, ties to the lowest bin (the plain version's stable
//     descending sort); the parabola is computed by every lane alike;
//   - the samples of each slot: lane g takes samples g, g+32, ..., 2 at a
//     time with their 16 taps loaded first; the sgx/sgy stores of a warp are
//     coalesced; window and grid indices come from float reciprocals, not
//     integer division.
// Compiled with -fmad=false, so every expression rounds as in the plain
// version; atan2f/cosf/sinf may differ from PyTorch's CPU functions in the
// last ulp, which the parity budgets allow for.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;             // keypoints per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxOri = 8;
constexpr int kMaxBins = 64;          // two bins per lane at most
constexpr int kBatch = 8;             // window pixels per lane loaded at once
constexpr int kSamples = 2;           // samples per lane loaded at once
constexpr int kMinBlocks = 4;         // blocks per SM the registers must allow

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

// a key whose unsigned order is the float order (-inf lowest of the floats);
// 0 is below every float and marks a bin already chosen
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// y0g: the image row of plane row 0 (a spatial slab's offset; 0 for a
// whole image), global_h: the image's height.  Window rows and samples
// outside the image's rows are masked, in image rows (y0g = 0, global_h =
// the plane's true height: the single-image semantics).
struct Params {
  int Hp, Wp, global_h, w_true, y0g, R, nb, nori, G, N;
  float sig_f, rad_f, peak, spacing, spc_cell, smax, bin_scale, two_pi;
};

// floats of shared memory per warp: histograms, two smoothing buffers,
// and the chosen angles
__host__ __device__ inline int warp_floats(int nb) { return nb * 32 + 2 * nb + kMaxOri; }

// q = n / d and n - q d for 0 <= n < 2^20, d >= 1, from the float reciprocal
// (the quotient's fraction is at least 0.5 / d away from the next integer,
// far above the product's rounding error)
__device__ __forceinline__ int div_small(int n, float inv_d) {
  return static_cast<int>((static_cast<float>(n) + 0.5f) * inv_d);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) orient_sample_kernel(
    const __nv_bfloat16* __restrict__ gx, const __nv_bfloat16* __restrict__ gy,
    const int* __restrict__ plane, const float* __restrict__ ky,
    const float* __restrict__ kx, const float* __restrict__ sigma_in,
    const uint8_t* __restrict__ mask, float* __restrict__ theta_out,
    uint8_t* __restrict__ haspk_out, float* __restrict__ sgx,
    float* __restrict__ sgy, Params P) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // keypoints strided over the blocks: live keypoints, which come first
  // in each octave, spread over every SM
  const int n = warp * gridDim.x + blockIdx.x;
  if (n >= P.N) return;
  const int nb = P.nb, nori = P.nori, G2 = P.G * P.G;
  const int win = 2 * P.R + 1;
  const float inv_G = 1.0f / static_cast<float>(P.G);
  const size_t out0 = static_cast<size_t>(n) * nori * G2;

  if (!mask[n]) {  // masked keypoint: zeros everywhere
    if (lane < nori) {
      theta_out[n * nori + lane] = 0.0f;
      haspk_out[n * nori + lane] = 0;
    }
    if ((nori * G2) % 4 == 0) {  // 16-byte stores: out0 is a multiple of 4
      float4* zx = reinterpret_cast<float4*>(sgx + out0);
      float4* zy = reinterpret_cast<float4*>(sgy + out0);
      for (int k = lane; k < nori * G2 / 4; k += 32) {
        zx[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        zy[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int k = lane; k < nori * G2; k += 32) {
        sgx[out0 + k] = 0.0f;
        sgy[out0 + k] = 0.0f;
      }
    }
    return;
  }

  float* hist = smem + warp * warp_floats(nb);  // [nb][32] private histograms
  float* hs = hist + nb * 32;                   // [2][nb] smoothing buffers
  float* s_theta = hs + 2 * nb;                 // [kMaxOri]

  const float y = ky[n], x = kx[n];
  const float sig = fminf(sigma_in[n], P.smax);
  const int iy = static_cast<int>(rintf(y)), ix = static_cast<int>(rintf(x));
  const int sy = min(max(iy - P.R, 0), P.Hp - win);
  const int sx = min(max(ix - P.R, 0), P.Wp - win);
  const size_t pbase = static_cast<size_t>(plane[n]) * P.Hp * P.Wp;
  const __nv_bfloat16* pgx = gx + pbase;
  const __nv_bfloat16* pgy = gy + pbase;

  // ---- 1. private histograms over the window, read from the bf16 planes ----
  for (int b = 0; b < nb; ++b) hist[b * 32 + lane] = 0.0f;
  const float sw = P.sig_f * sig;
  const float radius = P.rad_f * sw;
  const float rad2 = radius * radius;
  const float den = 2.0f * (sw * sw);
  // Only pixels inside the radius circle have a weight; the others add +0 to
  // a bin, which changes nothing.  So walk the window's rows and columns
  // that can hold such pixels (one pixel of margin for rounding); the
  // weight test below stays exact.  Lane l takes box pixels l, l+32, ...;
  // kBatch of them loaded before any is used.
  const int by0 = max(sy, static_cast<int>(floorf(y - radius)) - 1);
  const int by1 = min(sy + win - 1, static_cast<int>(ceilf(y + radius)) + 1);
  const int bx0 = max(sx, static_cast<int>(floorf(x - radius)) - 1);
  const int bx1 = min(sx + win - 1, static_cast<int>(ceilf(x + radius)) + 1);
  const int bw = max(bx1 - bx0 + 1, 1);
  const int P2 = (by1 >= by0 && bx1 >= bx0) ? (by1 - by0 + 1) * bw : 0;
  const float inv_bw = 1.0f / static_cast<float>(bw);
  for (int p0 = lane; p0 < P2; p0 += 32 * kBatch) {
    float bx[kBatch], by[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = min(p0 + 32 * u, P2 - 1);
      const int r = div_small(p, inv_bw), c = p - r * bw;
      const size_t g = static_cast<size_t>(by0 + r) * P.Wp + (bx0 + c);
      bx[u] = __bfloat162float(pgx[g]);
      by[u] = __bfloat162float(pgy[g]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + 32 * u;
      if (p >= P2) break;
      const int r = div_small(p, inv_bw), c = p - r * bw;
      const int row = by0 + r, col = bx0 + c;
      const float vx = bx[u], vy = by[u];
      const float oy = static_cast<float>(row) - y;
      const float ox = static_cast<float>(col) - x;
      const float r2 = oy * oy + ox * ox;
      float w = exp_window(-r2 / den);
      w = r2 <= rad2 ? w : 0.0f;
      w = w * (row + P.y0g >= 0 && row + P.y0g < P.global_h ? 1.0f : 0.0f);
      const float mag = sqrtf(vx * vx + vy * vy);
      float ang = atan2f(vy, vx);
      if (ang < 0.0f) ang = ang + P.two_pi;
      const int bin = min(max(static_cast<int>(ang * P.bin_scale), 0), nb - 1);
      hist[bin * 32 + lane] += w * mag;
    }
  }
  __syncwarp();
  // bin b: the sum of its 32 partials, lane b, in a fixed rotated order
  for (int b = lane; b < nb; b += 32) {
    float s = 0.0f;
    for (int i = 0; i < 32; ++i) s += hist[b * 32 + ((i + b) & 31)];
    hs[b] = s;
  }
  __syncwarp();

  // ---- 2. smoothing x6, peaks, parabola refinement ----
  float* cur = hs;
  float* nxt = hs + nb;
  for (int round = 0; round < 6; ++round) {
    for (int b = lane; b < nb; b += 32)
      nxt[b] = ((cur[(b + nb - 1) % nb] + cur[b]) + cur[(b + 1) % nb]) / 3.0f;
    __syncwarp();
    float* t = cur; cur = nxt; nxt = t;
  }
  float mx = -INFINITY;
  for (int b = lane; b < nb; b += 32) mx = fmaxf(mx, cur[b]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  unsigned key[2] = {0u, 0u};  // bins lane and lane + 32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = lane + 32 * i;
    if (b < nb) {
      const float h = cur[b];
      const bool pk = (h > cur[(b + nb - 1) % nb]) && (h > cur[(b + 1) % nb]) &&
                      (h >= P.peak * mx) && (mx > 0.0f);
      key[i] = ordered(pk ? h : -INFINITY);
    }
  }
  const unsigned no_peak = ordered(-INFINITY);
  unsigned has_bits = 0u;
  for (int o = 0; o < nori; ++o) {
    const unsigned m = __reduce_max_sync(0xffffffffu, max(key[0], key[1]));
    const int cand = (m != 0u && key[0] == m) ? lane
                     : (m != 0u && key[1] == m) ? lane + 32 : kMaxBins;
    const int idx = min(__reduce_min_sync(0xffffffffu, cand), nb - 1);
    if (idx == lane) key[0] = 0u;
    if (idx == lane + 32) key[1] = 0u;
    const bool has = m > no_peak;
    const float li = cur[(idx + nb - 1) % nb], ci = cur[idx], ri = cur[(idx + 1) % nb];
    const float denom = (li - 2.0f * ci) + ri;
    const float d = fabsf(denom) < 1e-12f ? 0.0f : (0.5f * (li - ri)) / denom;
    float th = (P.two_pi * ((static_cast<float>(idx) + 0.5f) + d)) / static_cast<float>(nb);
    if (th >= P.two_pi) th = th - P.two_pi;
    th = has ? th : 0.0f;
    has_bits |= (has ? 1u : 0u) << o;
    if (lane == 0) {
      s_theta[o] = th;
      theta_out[n * nori + o] = th;
      haspk_out[n * nori + o] = has ? 1 : 0;
    }
  }
  __syncwarp();

  // ---- 3. rotated-grid bilinear samples, zero outside the true image ----
  // lane l takes samples l, l+32, ...; the taps of kSamples of them are
  // loaded before any is combined
  const float half = (P.G - 1) * 0.5f;
  const float spc = (P.spacing * sig) / P.spc_cell;
  for (int o = 0; o < nori; ++o) {
    float* ox_out = sgx + out0 + static_cast<size_t>(o) * G2;
    float* oy_out = sgy + out0 + static_cast<size_t>(o) * G2;
    if (o > 0 && !((has_bits >> o) & 1u)) {   // a slot without a peak: zeros
      for (int g = lane; g < G2; g += 32) {
        ox_out[g] = 0.0f;
        oy_out[g] = 0.0f;
      }
      continue;
    }
    const float th = s_theta[o];
    const float ct = cosf(th), st = sinf(th);
    for (int g0 = lane; g0 < G2; g0 += 32 * kSamples) {
      float tx[kSamples][4], ty[kSamples][4], fxs[kSamples], fys[kSamples], ms[kSamples];
#pragma unroll
      for (int u = 0; u < kSamples; ++u) {
        const int g = min(g0 + 32 * u, G2 - 1);
        const int gr = div_small(g, inv_G);
        const float uu = (static_cast<float>(g - gr * P.G) - half) * spc;
        const float v = (static_cast<float>(gr) - half) * spc;
        const float px = (x + ct * uu) - st * v;
        const float py = (y + st * uu) + ct * v;
        const int x0 = static_cast<int>(fminf(fmaxf(floorf(px), 0.0f), static_cast<float>(P.Wp - 1)));
        const int y0 = static_cast<int>(fminf(fmaxf(floorf(py), 0.0f), static_cast<float>(P.Hp - 1)));
        const int x1 = min(x0 + 1, P.Wp - 1), y1 = min(y0 + 1, P.Hp - 1);
        fxs[u] = fminf(fmaxf(px - static_cast<float>(x0), 0.0f), 1.0f);
        fys[u] = fminf(fmaxf(py - static_cast<float>(y0), 0.0f), 1.0f);
        const float pyg = py + static_cast<float>(P.y0g);   // the image row, in f32
        const bool inb = (px >= 0.0f) && (px <= static_cast<float>(P.w_true - 1)) &&
                         (pyg >= 0.0f) && (pyg <= static_cast<float>(P.global_h - 1));
        ms[u] = inb ? 1.0f : 0.0f;
        const size_t i[4] = {static_cast<size_t>(y0) * P.Wp + x0, static_cast<size_t>(y0) * P.Wp + x1,
                             static_cast<size_t>(y1) * P.Wp + x0, static_cast<size_t>(y1) * P.Wp + x1};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tx[u][k] = __bfloat162float(pgx[i[k]]);
          ty[u][k] = __bfloat162float(pgy[i[k]]);
        }
      }
#pragma unroll
      for (int u = 0; u < kSamples; ++u) {
        const int g = g0 + 32 * u;
        if (g >= G2) break;
        const float fx = fxs[u], fy = fys[u];
        const float a = 1.0f - fy, bb = 1.0f - fx;
        const float vx = (((tx[u][0] * a) * bb + (tx[u][1] * a) * fx) + (tx[u][2] * fy) * bb)
                         + (tx[u][3] * fy) * fx;
        const float vy = (((ty[u][0] * a) * bb + (ty[u][1] * a) * fx) + (ty[u][2] * fy) * bb)
                         + (ty[u][3] * fy) * fx;
        ox_out[g] = vx * ms[u];
        oy_out[g] = vy * ms[u];
      }
    }
  }
}

}  // namespace

extern "C" int orient_sample_launch(
    const __nv_bfloat16* gx, const __nv_bfloat16* gy, const int* plane,
    const float* ky, const float* kx, const float* sigma, const uint8_t* mask,
    float* theta, uint8_t* haspk, float* sgx, float* sgy, int N, int Hp,
    int Wp, int global_h, int w_true, int y0g, int R, int nb, int nori, int G,
    float sig_f, float rad_f, float peak, float spacing, float spc_cell,
    float smax, float bin_scale, float two_pi, cudaStream_t stream) {
  if (nori > kMaxOri || nori < 1 || nb > kMaxBins || nb < 3 || N <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(warp_floats(nb));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        orient_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params P{Hp, Wp, global_h, w_true, y0g, R, nb, nori, G, N,
           sig_f, rad_f, peak, spacing, spc_cell, smax, bin_scale, two_pi};
  orient_sample_kernel<<<sift_ceil_div(N, kWarps), kThreads, smem, stream>>>(
      gx, gy, plane, ky, kx, sigma, mask, theta, haspk, sgx, sgy, P);
  return static_cast<int>(cudaGetLastError());
}
