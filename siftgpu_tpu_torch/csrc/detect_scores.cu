// detect_scores: dense keypoint scores + Cramer subpixel records over a DoG
// volume.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/detect_scores.py::detect_scores
// (body `_kernel`, shared `cramer_record`).  Semantics are those of the plain
// version, siftgpu_tpu_torch/ops/detect_scores.py::detect_scores_plain.
//
// What bounds it on the H100: a 27-tap stencil with ~120 flops per pixel
// over f32 planes; at 640x480 x 4 frames the whole DoG volume (25 MB over
// all octaves) and the six output planes fit in the 50 MB L2, so the
// kernel is bound by load instructions, not device-memory bandwidth.
// The simple design: one thread per output row pair at one (b, s, x); it
// reads its 27 taps per row straight from global memory (neighbouring
// threads read neighbouring addresses, L1 serves the overlap), computes both
// rows and writes the row-pooled scores.  No shared-memory tiling yet.
//
// Bit parity: this file is compiled with -fmad=false and evaluates every
// expression in the plain version's order, so records and score planes are
// bit-identical to it.  With nvcc's default FMA contraction the subpixel
// records at candidate pixels move by hundreds of ulp on the main path, and
// the Hessian terms of the edge test round differently, which can flip the
// edge mask of a pixel.
#include "common.cuh"

namespace {

struct Taps {
  const float* p;  // plane s (dl = -1); planes s+1, s+2 follow
  int H, W, y, x;
  __device__ __forceinline__ float operator()(int dl, int dy, int dx) const {
    const int yy = y + dy, xx = x + dx;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return 0.0f;  // zero padding
    return p[(static_cast<size_t>(dl + 1) * H + yy) * W + xx];
  }
};

__global__ void detect_scores_kernel(
    const float* __restrict__ dog, float* __restrict__ smax,
    float* __restrict__ smin, float* __restrict__ oval,
    float* __restrict__ ool, float* __restrict__ ooy,
    float* __restrict__ oox, int S, int H, int W, float thr08, float edge_c,
    int subpixel) {
  const int He = H + (H & 1), We = W + (W & 1);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int yp = blockIdx.y;
  const int bs = blockIdx.z;  // b * S + s
  if (x >= We) return;
  const int b = bs / S, s = bs % S;
  const float* base = dog + (static_cast<size_t>(b) * (S + 2) + s) * H * W;

  float pooled_max = 0.0f, pooled_min = 0.0f;
  for (int r = 0; r < 2; ++r) {
    const int y = 2 * yp + r;
    const size_t o = (static_cast<size_t>(bs) * He + y) * We + x;
    if (y >= H || x >= W) {  // padding to even (He, We)
      oval[o] = 0.0f; ool[o] = 0.0f; ooy[o] = 0.0f; oox[o] = 0.0f;
      continue;
    }
    const Taps q{base, H, W, y, x};
    // ---- Cramer record (same expression order as cramer_record) ----
    const float vc = q(0, 0, 0);
    const float d = (q(0, 1, 0) + q(0, -1, 0)) - 2.0f * vc;
    const float f = (q(0, 0, 1) + q(0, 0, -1)) - 2.0f * vc;
    const float e_ =
        0.25f * (((q(0, 1, 1) - q(0, 1, -1)) - q(0, -1, 1)) + q(0, -1, -1));
    float val, off_l, off_y, off_x;
    if (subpixel) {
      const float gl = 0.5f * (q(1, 0, 0) - q(-1, 0, 0));
      const float gy = 0.5f * (q(0, 1, 0) - q(0, -1, 0));
      const float gx = 0.5f * (q(0, 0, 1) - q(0, 0, -1));
      const float a = (q(1, 0, 0) + q(-1, 0, 0)) - 2.0f * vc;
      const float b_ =
          0.25f * (((q(1, 1, 0) - q(1, -1, 0)) - q(-1, 1, 0)) + q(-1, -1, 0));
      const float c_ =
          0.25f * (((q(1, 0, 1) - q(1, 0, -1)) - q(-1, 0, 1)) + q(-1, 0, -1));
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
    oval[o] = val; ool[o] = off_l; ooy[o] = off_y; oox[o] = off_x;

    // ---- scores: strict 26-neighbour extremum + tests (interior only) ----
    if (y < 1 || y > H - 2 || x < 1 || x > W - 2) continue;
    float nmax = -INFINITY, nmin = INFINITY;
    for (int dl = -1; dl <= 1; ++dl)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          if (dl == 0 && dy == 0 && dx == 0) continue;
          const float t = q(dl, dy, dx);
          nmax = fmaxf(nmax, t);
          nmin = fminf(nmin, t);
        }
    const float av = fabsf(vc);
    const bool pre = av > thr08;
    const bool is_max = (vc > 0.0f) && (vc > nmax) && pre;
    const bool is_min = (vc < 0.0f) && (vc < nmin) && pre;
    const float tr = f + d;
    const float det = f * d - e_ * e_;
    const bool edge_ok = (det > 0.0f) && ((tr * tr) / det < edge_c);
    if (!edge_ok || !(is_max || is_min)) continue;
    const int par = (y & 1) * 2 + (x & 1);
    const float packed = __int_as_float((__float_as_int(av) & ~3) | par);
    if (is_max) pooled_max = fmaxf(pooled_max, packed);
    else pooled_min = fmaxf(pooled_min, packed);
  }
  const size_t oh = (static_cast<size_t>(bs) * (He / 2) + yp) * We + x;
  smax[oh] = pooled_max;
  smin[oh] = pooled_min;
}

}  // namespace

extern "C" int detect_scores_launch(
    const float* dog, float* smax, float* smin, float* val, float* off_l,
    float* off_y, float* off_x, int B, int S, int H, int W, float thr08,
    float edge_c, int subpixel, cudaStream_t stream) {
  const int He = H + (H & 1), We = W + (W & 1);
  const dim3 block(128);
  const dim3 grid(sift_ceil_div(We, 128), He / 2, B * S);
  detect_scores_kernel<<<grid, block, 0, stream>>>(
      dog, smax, smin, val, off_l, off_y, off_x, S, H, W, thr08, edge_c,
      subpixel);
  return static_cast<int>(cudaGetLastError());
}
