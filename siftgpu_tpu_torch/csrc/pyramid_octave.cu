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
// What bounds it on the H100: bytes.  The octave must read its base once and
// write L Gaussian and L-1 DoG planes (12 f32 planes at S = 3: 59 MB for a
// 4 x 480x640 octave 0, 17.6 us at 3.35 TB/s); the taps are ~0.6 GFLOP over
// the 5 octaves.  The first design kept every level of a tile in shared
// memory and so carried the 43 px cumulative halo of all levels around each
// 32x32 tile: ~5.5x the taps the blur needs, one shared load per tap, two
// blocks per SM.  This one:
//  - is a persistent cooperative kernel (cudaLaunchCooperativeKernel, grid =
//    co-resident blocks, at most one per tile): blocks walk the octave's
//    64x64 tiles level by level, with a grid-wide barrier between levels;
//  - builds level s of a tile from level s-1 as written to device memory by
//    the previous level (the base for level 1), read through L2 (`ld.cg`:
//    the plane was written in this launch, so the non-coherent path is not
//    allowed), with only that level's radius r as halo: the window is
//    (64+2r)^2, so the row pass computes (64+2r)/64 of the outputs it keeps
//    and the column pass none it drops;
//  - keeps the taps in registers and register-blocks both passes: each thread
//    slides along a run of 8 outputs in the filter direction, so 8+2r shared
//    loads serve 8(2r+1) taps.  The radius is a template parameter for the
//    default configuration's radii (5, 7, 8, 10, 13); any other radius takes
//    a generic loop with the taps in shared memory;
//  - the window is loaded 8 elements per thread at a time, all loads issued
//    before the first store to shared memory: one block's level is a chain
//    of dependent steps, and the load latency is its longest link;
//  - the row pass gives each lane its own window row (odd row pitches: no
//    bank conflicts), the column pass its own column (stores coalesced).
//
// Numbers: taps are summed in tap order with one fused multiply-add each
// (__fmaf_rn, written out; the file is still built with -fmad=false, so no
// other expression is contracted).  cuDNN's own order is not known, so the
// bound against the plain version on the card is the reference's
// fused-versus-chain bound, 1e-5 absolute.  Every pixel's arithmetic depends
// on its image coordinates only, so a frame's result does not depend on the
// others in its batch, nor on the tile schedule.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 64;          // output tile rows
constexpr int TW = 64;          // output tile columns
constexpr int RUN = 8;          // outputs per thread along the filter direction
constexpr int NT = 256;         // threads per block
constexpr int MAX_LEVELS = 32;  // incremental levels per octave
constexpr int MAX_TAPS = 256;   // all levels' taps together
constexpr int TP = TW + 1;      // row pitch of the row-pass buffer (odd)
constexpr int LOADS = 8;        // window loads per thread in flight

struct Args {
  const float* base;    // [B, H, W]
  const float* taps;    // every level's taps back to back
  const int* radii;     // [nlev]
  float* gauss;         // [B, nlev+1, H, W]
  float* dog;           // [B, nlev, H, W]
  int B, H, W, nlev, ntaps, rmax, tiles_y, tiles_x;
};

// the input window's row pitch for a halo of r: odd, so that lanes on
// consecutive rows fall in distinct banks
__host__ __device__ inline int in_pitch(int r) { return (TW + 2 * r) | 1; }

// Level s of one tile: `prev` is level s-1 of the frame, `gout`/`dout` the
// frame's gauss[s] and dog[s-1] planes; `g0` (level 1 only) receives the
// base tile as gauss[0].  RT > 0: radius RT, taps in registers; RT == 0:
// radius r, taps read from shared memory.
template <int RT>
__device__ void level_tile(const float* prev, float* gout, float* dout, float* g0,
                           const float* taps, int r_rt, int H, int W, int y0, int x0,
                           float* in, float* tmp) {
  const int r = RT > 0 ? RT : r_rt;
  const int wr = TH + 2 * r, wc = TW + 2 * r, pin = in_pitch(r);
  const int tid = threadIdx.x;

  // 1. the window of level s-1, each coordinate clamped to the image; LOADS
  // loads in flight per thread before any is stored
  const int nwin = wr * wc;
  for (int i0 = tid; i0 < nwin; i0 += LOADS * NT) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = min(i0 + u * NT, nwin - 1);
      const int a = i / wc, c = i - a * wc;
      const int gy = min(max(y0 - r + a, 0), H - 1), gx = min(max(x0 - r + c, 0), W - 1);
      v[u] = __ldcg(prev + static_cast<long long>(gy) * W + gx);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * NT;
      if (i < nwin) {
        const int a = i / wc, c = i - a * wc;
        in[a * pin + c] = v[u];
        if (g0 != nullptr && a >= r && a < r + TH && c >= r && c < r + TW &&
            y0 - r + a < H && x0 - r + c < W)
          g0[static_cast<long long>(y0 - r + a) * W + (x0 - r + c)] = v[u];
      }
    }
  }
  __syncthreads();

  float t[RT > 0 ? 2 * RT + 1 : 1];
  if (RT > 0) {
#pragma unroll
    for (int k = 0; k < (RT > 0 ? 2 * RT + 1 : 1); ++k) t[k] = taps[k];
  }

  // 2. row pass: tmp[a][j] for every window row a and tile column j
  for (int item = tid; item < wr * (TW / RUN); item += NT) {
    const int a = item % wr, j0 = (item / wr) * RUN;
    const float* src = in + a * pin + j0;
    float acc[RUN];
    if (RT > 0) {
      float v[RT > 0 ? RUN + 2 * RT : 1];
#pragma unroll
      for (int k = 0; k < (RT > 0 ? RUN + 2 * RT : 1); ++k) v[k] = src[k];
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < (RT > 0 ? 2 * RT + 1 : 1); ++k) s = __fmaf_rn(t[k], v[q + k], s);
        acc[q] = s;
      }
    } else {
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        float s = 0.0f;
        for (int k = 0; k <= 2 * r; ++k) s = __fmaf_rn(taps[k], src[q + k], s);
        acc[q] = s;
      }
    }
#pragma unroll
    for (int q = 0; q < RUN; ++q) tmp[a * TP + j0 + q] = acc[q];
  }
  __syncthreads();

  // 3. column pass: the tile's outputs, a run of RUN rows per thread
  for (int item = tid; item < TW * (TH / RUN); item += NT) {
    const int j = item % TW, i0 = (item / TW) * RUN;
    const int x = x0 + j;
    if (x >= W || y0 + i0 >= H) continue;
    const float* src = tmp + i0 * TP + j;
    float acc[RUN];
    if (RT > 0) {
      float v[RT > 0 ? RUN + 2 * RT : 1];
#pragma unroll
      for (int k = 0; k < (RT > 0 ? RUN + 2 * RT : 1); ++k) v[k] = src[k * TP];
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < (RT > 0 ? 2 * RT + 1 : 1); ++k) s = __fmaf_rn(t[k], v[q + k], s);
        acc[q] = s;
      }
    } else {
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        float s = 0.0f;
        for (int k = 0; k <= 2 * r; ++k) s = __fmaf_rn(taps[k], src[(q + k) * TP], s);
        acc[q] = s;
      }
    }
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      const int y = y0 + i0 + q;
      if (y < H) {
        const long long o = static_cast<long long>(y) * W + x;
        gout[o] = acc[q];
        dout[o] = acc[q] - in[(r + i0 + q) * pin + r + j];
      }
    }
  }
  __syncthreads();  // the next tile overwrites `in` and `tmp`
}

__global__ void __launch_bounds__(NT) blur_octave_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float s_taps[MAX_TAPS];
  __shared__ int s_rad[MAX_LEVELS];
  __shared__ int s_off[MAX_LEVELS];

  for (int i = threadIdx.x; i < a.ntaps; i += NT) s_taps[i] = a.taps[i];
  if (threadIdx.x == 0) {
    int off = 0;
    for (int s = 0; s < a.nlev; ++s) {
      s_rad[s] = a.radii[s];
      s_off[s] = off;
      off += 2 * a.radii[s] + 1;
    }
  }
  __syncthreads();

  float* in = smem;                                      // [TH+2rmax][in_pitch]
  float* tmp = smem + (TH + 2 * a.rmax) * in_pitch(a.rmax);  // [TH+2rmax][TP]
  const long long plane = static_cast<long long>(a.H) * a.W;
  const int L = a.nlev + 1;
  const int per_frame = a.tiles_y * a.tiles_x;
  const int ntiles = a.B * per_frame;
  cg::grid_group grid = cg::this_grid();

  for (int s = 0; s < a.nlev; ++s) {
    const int r = s_rad[s];
    const float* t = s_taps + s_off[s];
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int b = tile / per_frame, rem = tile % per_frame;
      const int y0 = (rem / a.tiles_x) * TH, x0 = (rem % a.tiles_x) * TW;
      const float* prev = s == 0 ? a.base + b * plane : a.gauss + (b * L + s) * plane;
      float* gout = a.gauss + (b * L + s + 1) * plane;
      float* dout = a.dog + (b * a.nlev + s) * plane;
      float* g0 = s == 0 ? a.gauss + b * L * plane : nullptr;
      switch (r) {
        case 5: level_tile<5>(prev, gout, dout, g0, t, r, a.H, a.W, y0, x0, in, tmp); break;
        case 7: level_tile<7>(prev, gout, dout, g0, t, r, a.H, a.W, y0, x0, in, tmp); break;
        case 8: level_tile<8>(prev, gout, dout, g0, t, r, a.H, a.W, y0, x0, in, tmp); break;
        case 10: level_tile<10>(prev, gout, dout, g0, t, r, a.H, a.W, y0, x0, in, tmp); break;
        case 13: level_tile<13>(prev, gout, dout, g0, t, r, a.H, a.W, y0, x0, in, tmp); break;
        default: level_tile<0>(prev, gout, dout, g0, t, r, a.H, a.W, y0, x0, in, tmp); break;
      }
    }
    if (s + 1 < a.nlev) grid.sync();  // level s is complete in device memory
  }
}

}  // namespace

// base [B, H, W] f32; taps: the nlev levels' taps back to back (ntaps in
// all), radii [nlev] int32 on the device; rmax = the largest radius (sizes
// the shared windows); gauss [B, nlev+1, H, W], dog [B, nlev, H, W].
// Returns cudaErrorCooperativeLaunchTooLarge if not one block fits an SM.
extern "C" int blur_octave_launch(const float* base, const float* taps,
                                  const int* radii, float* gauss, float* dog,
                                  int B, int H, int W, int nlev, int ntaps,
                                  int rmax, cudaStream_t stream) {
  if (nlev < 1 || nlev > MAX_LEVELS || ntaps > MAX_TAPS || rmax < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(TH + 2 * rmax) * (in_pitch(rmax) + TP);
  cudaError_t e = cudaFuncSetAttribute(
      blur_octave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, blur_octave_kernel, NT, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args a{base, taps, radii, gauss, dog, B, H, W, nlev, ntaps, rmax,
         static_cast<int>(sift_ceil_div(H, TH)), static_cast<int>(sift_ceil_div(W, TW))};
  const long long ntiles = static_cast<long long>(B) * a.tiles_y * a.tiles_x;
  const int grid = static_cast<int>(ntiles < static_cast<long long>(per_sm) * sms
                                        ? ntiles : static_cast<long long>(per_sm) * sms);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(blur_octave_kernel),
                                  dim3(grid), dim3(NT), params, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
