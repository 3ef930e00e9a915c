// detect_scores: dense keypoint scores + Cramer subpixel records over a DoG
// volume.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/detect_scores.py::detect_scores
// (body `_kernel`, shared `cramer_record`).  Semantics are those of the plain
// version, siftgpu_tpu_torch/ops/detect_scores.py::detect_scores_plain.
//
// What bounds it on the H100: the bytes.  Per pixel of the S inner slices
// it reads about one DoG value and writes four record values and one
// row-pooled score value for each of the two score planes (octave 0 of the
// main path: 24.6 MB in, 73.7 MB out), against ~150 flops of a 27-tap
// stencil and a 3x3 solve.  The design moves each byte once and in wide
// instructions:
//
// - One block per (frame, 16 x 64 output tile), all S slices.  The block
//   stages the tile of each DoG plane with its 1-pixel halo in shared memory
//   once (cp.async; 16-byte copies where the rows are 16-byte aligned, the
//   window starting 4 columns left of the tile; zeros outside the image,
//   which is the plain version's zero padding of the records).  Planes
//   slide through a 4-plane ring: slice s reads planes s-1, s, s+1 while
//   plane s+2 loads, so each DoG value leaves device memory once per octave
//   instead of 27 times per slice through L1/L2.  Where the plane has too
//   few tiles to fill the card (fewer than 2 blocks per SM), each block
//   takes one slice instead, and the octave is latency-bound either way.
// - Each of the 256 threads owns a row pair x 2 consecutive columns: it
//   reads its 4 x 4 window of each plane from shared memory as 8-byte loads
//   into registers, computes its 4 pixels, and stores the four record
//   planes and the two row-pooled score planes as float2 (a warp writes 256
//   contiguous bytes a row).  The padding row and column to even (He, We)
//   is written as zeros, as before.  Registers are held to 85 (3 blocks,
//   24 warps an SM) so that one block's stores overlap another's stencil.
// - The extremum test is taken only at interior pixels, whose 26
//   neighbours all lie in the image, so the plain version's +-inf padding
//   never enters it; scores stay interior-only, and within the rows
//   ylo..yhi (a spatial slab's owned rows; 1..H-2 otherwise).  It runs
//   only where |v| passes the pre-threshold, and the edge ratio's division
//   only at extrema: both are conjuncts of the plain version's test, so
//   skipping them where an earlier conjunct fails changes no output.
//
// Bit parity: this file is compiled with -fmad=false and evaluates every
// expression in the plain version's order, so records and score planes are
// bit-identical to it.  With nvcc's default FMA contraction the subpixel
// records at candidate pixels move by hundreds of ulp on the main path, and
// the Hessian terms of the edge test round differently, which can flip the
// edge mask of a pixel.
#include "common.cuh"

namespace {

constexpr int TH = 16, TW = 64;   // output tile: 8 row pairs x 64 columns
constexpr int WR = TH + 2;        // window rows: the tile and its 1-row halo
constexpr int WP = TW + 8;        // window pitch: 4 columns each side keep 16-byte chunks aligned
constexpr int kThreads = 256;     // 8 row pairs x 32 column pairs
constexpr int kRing = 4;          // planes s-1, s, s+1 and the one loading

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Window of plane `plane` [H, W] around the tile at (y0, x0): rows y0-1 ..
// y0+TH, columns x0-4 .. x0+TW+3, zeros outside the image.  kVec: W is a
// multiple of 4 and the volume 16-byte aligned, so every 16-byte chunk is
// wholly inside or wholly outside the image.
template <bool kVec>
__device__ __forceinline__ void stage_plane(float* dst, const float* plane, int H, int W, int y0,
                                            int x0) {
  if constexpr (kVec) {
    for (int k = threadIdx.x; k < WR * (WP / 4); k += kThreads) {
      const int r = k / (WP / 4), c = 4 * (k % (WP / 4));
      const int gy = y0 - 1 + r, gx = x0 - 4 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(dst + r * WP + c, plane + (in ? static_cast<size_t>(gy) * W + gx : 0), in ? 16 : 0);
    }
  } else {
    for (int k = threadIdx.x; k < WR * WP; k += kThreads) {
      const int r = k / WP, c = k % WP;
      const int gy = y0 - 1 + r, gx = x0 - 4 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(dst + r * WP + c, plane + (in ? static_cast<size_t>(gy) * W + gx : 0), in ? 4 : 0);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3) detect_scores_kernel(
    const float* __restrict__ dog, float* __restrict__ smax,
    float* __restrict__ smin, float* __restrict__ oval,
    float* __restrict__ ool, float* __restrict__ ooy,
    float* __restrict__ oox, int S, int H, int W, int ylo, int yhi, float thr08,
    float edge_c, int subpixel, int slices_per_block) {
  __shared__ __align__(16) float win[kRing][WR * WP];
  const int He = H + (H & 1), We = W + (W & 1);
  const int groups = S / slices_per_block;
  const int b = blockIdx.z / groups, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int s_first = (blockIdx.z % groups) * slices_per_block + 1;
  const int s_last = s_first + slices_per_block - 1;
  const int rp = threadIdx.x >> 5, xp = threadIdx.x & 31;
  const int y = y0 + 2 * rp, x = x0 + 2 * xp;   // this thread's top-left pixel
  const bool live = y < He && x < We;
  const float* vol = dog + static_cast<size_t>(b) * (S + 2) * H * W;
  const size_t plane_sz = static_cast<size_t>(H) * W;

  // plane l sits in ring slot (l - (s_first - 1)) % kRing
  for (int k = 0; k < 3; ++k) {   // planes s_first - 1 .. s_first + 1
    stage_plane<kVec>(win[k], vol + (s_first - 1 + k) * plane_sz, H, W, y0, x0);
    cp_async_commit();
  }
  for (int s = s_first; s <= s_last; ++s) {   // slice s: planes s-1, s, s+1
    const int k = s - s_first;
    if (s + 2 <= s_last + 1)   // into the slot plane s-2 left
      stage_plane<kVec>(win[(k + 3) % kRing], vol + (s + 2) * plane_sz, H, W, y0, x0);
    cp_async_commit();
    cp_async_wait1();          // planes <= s+1 have landed; s+2 may be in flight
    __syncthreads();
    if (live) {
      // w[dl][r][c]: plane s-1+dl, row y-1+r, column x-1+c (window column 2xp+3+c)
      float w[3][4][4];
#pragma unroll
      for (int dl = 0; dl < 3; ++dl) {
        const float* pl = win[(k + dl) % kRing] + 2 * rp * WP + 2 * xp + 2;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 a = *reinterpret_cast<const float2*>(pl + r * WP);
          const float2 m = *reinterpret_cast<const float2*>(pl + r * WP + 2);
          const float2 c = *reinterpret_cast<const float2*>(pl + r * WP + 4);
          w[dl][r][0] = a.y; w[dl][r][1] = m.x; w[dl][r][2] = m.y; w[dl][r][3] = c.x;
        }
      }
      float rv[2][2], rl[2][2], ry[2][2], rx[2][2];
      float pmax[2] = {0.0f, 0.0f}, pmin[2] = {0.0f, 0.0f};
#pragma unroll
      for (int py = 0; py < 2; ++py) {
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          const int yy = y + py, xx = x + px;
#define Q(dl, dy, dx) w[(dl) + 1][py + (dy) + 1][px + (dx) + 1]
          // ---- Cramer record (same expression order as cramer_record) ----
          const float vc = Q(0, 0, 0);
          const float d = (Q(0, 1, 0) + Q(0, -1, 0)) - 2.0f * vc;
          const float f = (Q(0, 0, 1) + Q(0, 0, -1)) - 2.0f * vc;
          const float e_ =
              0.25f * (((Q(0, 1, 1) - Q(0, 1, -1)) - Q(0, -1, 1)) + Q(0, -1, -1));
          float val, off_l, off_y, off_x;
          if (subpixel) {
            const float gl = 0.5f * (Q(1, 0, 0) - Q(-1, 0, 0));
            const float gy = 0.5f * (Q(0, 1, 0) - Q(0, -1, 0));
            const float gx = 0.5f * (Q(0, 0, 1) - Q(0, 0, -1));
            const float a = (Q(1, 0, 0) + Q(-1, 0, 0)) - 2.0f * vc;
            const float b_ =
                0.25f * (((Q(1, 1, 0) - Q(1, -1, 0)) - Q(-1, 1, 0)) + Q(-1, -1, 0));
            const float c_ =
                0.25f * (((Q(1, 0, 1) - Q(1, 0, -1)) - Q(-1, 0, 1)) + Q(-1, 0, -1));
            const float i00 = d * f - e_ * e_;
            const float i01 = c_ * e_ - b_ * f;
            const float i02 = b_ * e_ - c_ * d;
            const float i11 = a * f - c_ * c_;
            const float i12 = b_ * c_ - a * e_;
            const float i22 = a * d - b_ * b_;
            const float detH = (a * i00 + b_ * i01) + c_ * i02;
            const float inv_det = fabsf(detH) > 1e-12f ? 1.0f / detH : 0.0f;
            off_l = -((i00 * gl + i01 * gy) + i02 * gx) * inv_det;
            off_y = -((i01 * gl + i11 * gy) + i12 * gx) * inv_det;
            off_x = -((i02 * gl + i12 * gy) + i22 * gx) * inv_det;
            val = vc + 0.5f * ((gl * off_l + gy * off_y) + gx * off_x);
          } else {
            val = vc;
            off_l = off_y = off_x = vc * 0.0f;
          }
          const bool in = yy < H && xx < W;   // else padding to even (He, We)
          rv[py][px] = in ? val : 0.0f;
          rl[py][px] = in ? off_l : 0.0f;
          ry[py][px] = in ? off_y : 0.0f;
          rx[py][px] = in ? off_x : 0.0f;

          // ---- scores: strict 26-neighbour extremum + tests (interior rows
          // ylo..yhi, within 1..H-2, and interior columns only) ----
          const float av = fabsf(vc);
          if (yy >= ylo && yy <= yhi && xx >= 1 && xx <= W - 2 && av > thr08) {
            float nmax = -INFINITY, nmin = INFINITY;
#pragma unroll
            for (int dl = -1; dl <= 1; ++dl)
#pragma unroll
              for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
                for (int dx = -1; dx <= 1; ++dx) {
                  if (dl == 0 && dy == 0 && dx == 0) continue;
                  const float t = Q(dl, dy, dx);
                  nmax = fmaxf(nmax, t);
                  nmin = fminf(nmin, t);
                }
            const bool is_max = (vc > 0.0f) && (vc > nmax);
            const bool is_min = (vc < 0.0f) && (vc < nmin);
            const float tr = f + d;
            const float det = f * d - e_ * e_;
            // the edge ratio's division only where a candidate needs it
            if ((is_max || is_min) && det > 0.0f && (tr * tr) / det < edge_c) {
              const int par = (yy & 1) * 2 + (xx & 1);
              const float packed = __int_as_float((__float_as_int(av) & ~3) | par);
              if (is_max) pmax[px] = fmaxf(pmax[px], packed);
              else pmin[px] = fmaxf(pmin[px], packed);
            }
          }
#undef Q
        }
      }
      const int bs = b * S + (s - 1);
#pragma unroll
      for (int py = 0; py < 2; ++py) {   // (x, x+1) both lie in [0, We): We is even
        const size_t o = (static_cast<size_t>(bs) * He + y + py) * We + x;
        *reinterpret_cast<float2*>(oval + o) = make_float2(rv[py][0], rv[py][1]);
        *reinterpret_cast<float2*>(ool + o) = make_float2(rl[py][0], rl[py][1]);
        *reinterpret_cast<float2*>(ooy + o) = make_float2(ry[py][0], ry[py][1]);
        *reinterpret_cast<float2*>(oox + o) = make_float2(rx[py][0], rx[py][1]);
      }
      const size_t oh = (static_cast<size_t>(bs) * (He / 2) + y / 2) * We + x;
      *reinterpret_cast<float2*>(smax + oh) = make_float2(pmax[0], pmax[1]);
      *reinterpret_cast<float2*>(smin + oh) = make_float2(pmin[0], pmin[1]);
    }
    __syncthreads();   // plane s-1's slot is reloaded next
  }
}

}  // namespace

// slices_per_block: S (each block walks all slices) or 1 (a block per
// slice, for planes with few tiles); ops/detect_scores.py::launch_plan.
// ylo..yhi: the rows that may hold a candidate (1..H-2 for a whole
// image; a slab's owned rows clipped to that for the spatial path).
extern "C" int detect_scores_launch(
    const float* dog, float* smax, float* smin, float* val, float* off_l,
    float* off_y, float* off_x, int B, int S, int H, int W, int ylo, int yhi,
    float thr08, float edge_c, int subpixel, int slices_per_block, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || W <= 0 || slices_per_block <= 0 ||
      S % slices_per_block != 0 || ylo < 1 || yhi > H - 2)
    return cudaErrorInvalidValue;
  const int He = H + (H & 1), We = W + (W & 1);
  const dim3 grid(sift_ceil_div(We, TW), sift_ceil_div(He, TH), B * (S / slices_per_block));
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(dog) % 16 == 0;
  if (vec)
    detect_scores_kernel<true><<<grid, kThreads, 0, stream>>>(
        dog, smax, smin, val, off_l, off_y, off_x, S, H, W, ylo, yhi, thr08, edge_c,
        subpixel, slices_per_block);
  else
    detect_scores_kernel<false><<<grid, kThreads, 0, stream>>>(
        dog, smax, smin, val, off_l, off_y, off_x, S, H, W, ylo, yhi, thr08, edge_c,
        subpixel, slices_per_block);
  return static_cast<int>(cudaGetLastError());
}
