// blur_octave: all incremental Gaussian blurs and DoGs of one octave in one
// launch.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/pyramid_kernel.py::
// blur_octave_fused (body `_kernel`).  Semantics are those of the plain
// version, siftgpu_tpu_torch/ops/pyramid_kernel.py::blur_octave_fused_plain:
// level s = separable blur of level s-1 with the taps of level s, the row
// (W) pass first and then the column (H) pass, each with replicate edges OF
// LEVEL s-1 (a tap outside the image reads level s-1 at the clamped in-image
// coordinate); dog[s-1] = gauss[s] - gauss[s-1].
//
// What bounds it on the H100: the plain chain writes and re-reads every full
// plane twice per level through device memory (52 cuDNN convolutions per
// 5-octave batch).  Here a block reads its tile's window of the base once and
// keeps every level in shared memory, so device traffic is one read of the
// base plus one write per output plane; the cost moves to shared-memory
// reads of the taps' windows, and to the halo each tile recomputes.
//
// Design (simple first):
//  - one launch per octave; one block per (frame, 32 x TY output tile);
//  - a shared window of the tile plus the cumulative halo R = sum of the
//    levels' radii (43 px at S = 3) on each side, in image coordinates
//    (y0 - R .. y0 + TY + R); two buffers: `cur` (level s-1) and `tmp` (the
//    row pass of level s);
//  - per level, the row pass over the rows where level s-1 is valid and the
//    columns where level s will be, then the column pass over level s's
//    valid region; the valid region shrinks by that level's radius per side.
//    Window positions outside the image are never computed or read: every
//    tap clamps its coordinate to the image, which lies inside the region
//    valid for level s-1 whenever the output pixel is in the image;
//  - the column pass writes gauss[s] and dog[s-1] for the tile and then
//    overwrites `cur` in place (it reads only `tmp`).
//
// Numbers: taps are summed in tap order, one rounded product and one rounded
// add each (built with -fmad=false).  cuDNN's own summation order is not
// known, so the bound against the plain version on the card is the
// reference's fused-versus-chain bound, 1e-5 absolute.  A frame's result does
// not depend on the others in its batch.
#include "common.cuh"

namespace {

constexpr int TX = 32;          // tile width: one warp across
constexpr int NTY = 8;          // thread rows per block
constexpr int MAX_LEVELS = 32;  // incremental levels per octave
constexpr int MAX_TAPS = 256;   // all levels' taps together

__global__ void __launch_bounds__(TX * NTY)
blur_octave_kernel(const float* __restrict__ base,
                   const float* __restrict__ taps,
                   const int* __restrict__ radii, float* __restrict__ gauss,
                   float* __restrict__ dog, int nlev, int ntaps, int H, int W,
                   int R, int TY) {
  extern __shared__ float smem[];
  __shared__ float s_taps[MAX_TAPS];
  __shared__ int s_rad[MAX_LEVELS];
  __shared__ int s_off[MAX_LEVELS];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  for (int i = tid; i < ntaps; i += TX * NTY) s_taps[i] = taps[i];
  if (tid == 0) {
    int off = 0;
    for (int s = 0; s < nlev; ++s) {
      s_rad[s] = radii[s];
      s_off[s] = off;
      off += 2 * radii[s] + 1;
    }
  }

  const int WY = TY + 2 * R, WX = TX + 2 * R;
  float* cur = smem;             // level s-1, [WY, WX]
  float* tmp = smem + WY * WX;   // row pass of level s, [WY, WX]
  const long long b = blockIdx.z;
  const long long plane = static_cast<long long>(H) * W;
  const int L = nlev + 1;
  const int wy0 = blockIdx.y * TY - R;  // image row of window row 0
  const int wx0 = blockIdx.x * TX - R;  // image column of window column 0
  // the window's rows / columns that lie inside the image
  const int iy_lo = max(0, -wy0), iy_hi = min(WY, H - wy0);
  const int ix_lo = max(0, -wx0), ix_hi = min(WX, W - wx0);
  // the output tile inside the window
  const int ty_hi = min(R + TY, iy_hi), tx_hi = min(R + TX, ix_hi);

  const float* src = base + b * plane;
  float* g0 = gauss + b * L * plane;
  for (int i = iy_lo + ty; i < iy_hi; i += NTY) {
    const long long row = static_cast<long long>(wy0 + i) * W + wx0;
    for (int j = ix_lo + tx; j < ix_hi; j += TX) {
      const float v = src[row + j];
      cur[i * WX + j] = v;
      if (i >= R && i < ty_hi && j >= R && j < tx_hi) g0[row + j] = v;
    }
  }
  __syncthreads();

  int cum = 0;
  for (int s = 0; s < nlev; ++s) {
    const int r = s_rad[s];
    const float* t = s_taps + s_off[s];
    const int cprev = cum;
    cum += r;
    const int pr_lo = max(cprev, iy_lo), pr_hi = min(WY - cprev, iy_hi);
    const int nr_lo = max(cum, iy_lo), nr_hi = min(WY - cum, iy_hi);
    const int nc_lo = max(cum, ix_lo), nc_hi = min(WX - cum, ix_hi);

    // row pass (along W) of level s-1 -> tmp
    for (int i = pr_lo + ty; i < pr_hi; i += NTY) {
      const float* rowp = cur + i * WX;
      for (int j = nc_lo + tx; j < nc_hi; j += TX) {
        float acc = 0.0f;
        if (j - r >= ix_lo && j + r < ix_hi) {
          for (int k = 0; k <= 2 * r; ++k) acc = acc + t[k] * rowp[j - r + k];
        } else {  // an image edge: replicate level s-1
          for (int k = 0; k <= 2 * r; ++k)
            acc = acc + t[k] * rowp[min(max(j - r + k, ix_lo), ix_hi - 1)];
        }
        tmp[i * WX + j] = acc;
      }
    }
    __syncthreads();

    // column pass (along H) of tmp -> level s; gauss[s], dog[s-1]
    float* gs = gauss + (b * L + s + 1) * plane;
    float* ds = dog + (b * nlev + s) * plane;
    for (int i = nr_lo + ty; i < nr_hi; i += NTY) {
      const long long row = static_cast<long long>(wy0 + i) * W + wx0;
      for (int j = nc_lo + tx; j < nc_hi; j += TX) {
        float acc = 0.0f;
        if (i - r >= iy_lo && i + r < iy_hi) {
          for (int k = 0; k <= 2 * r; ++k)
            acc = acc + t[k] * tmp[(i - r + k) * WX + j];
        } else {
          for (int k = 0; k <= 2 * r; ++k)
            acc = acc + t[k] * tmp[min(max(i - r + k, iy_lo), iy_hi - 1) * WX + j];
        }
        if (i >= R && i < ty_hi && j >= R && j < tx_hi) {
          gs[row + j] = acc;
          ds[row + j] = acc - cur[i * WX + j];
        }
        cur[i * WX + j] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// base [B, H, W] f32; taps: the nlev levels' taps back to back (ntaps in
// all), radii [nlev] int32; gauss [B, nlev+1, H, W], dog [B, nlev, H, W].
// R = sum of radii; TY = output rows per tile (the wrapper picks it so the
// two windows fit in shared memory).
extern "C" int blur_octave_launch(const float* base, const float* taps,
                                  const int* radii, float* gauss, float* dog,
                                  int B, int H, int W, int nlev, int ntaps,
                                  int R, int TY, cudaStream_t stream) {
  if (nlev < 1 || nlev > MAX_LEVELS || ntaps > MAX_TAPS || TY < 1 || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem = 2ull * (TY + 2 * R) * (TX + 2 * R) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      blur_octave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(sift_ceil_div(W, TX), sift_ceil_div(H, TY), B);
  blur_octave_kernel<<<grid, dim3(TX, NTY), smem, stream>>>(
      base, taps, radii, gauss, dog, nlev, ntaps, H, W, R, TY);
  return static_cast<int>(cudaGetLastError());
}
