// grad_stencil: central-difference gradient stack of Gaussian levels 1..S,
// stored as bf16.
//
// Replaces the Pallas kernel siftgpu_tpu/ops/grad_stencil.py::grad_stencil
// (body `_kernel`).  Semantics are those of the plain version,
// siftgpu_tpu_torch/ops/grad_stencil.py::grad_stencil_plain:
//   gx = 0.5 (g[y, x+1] - g[y, x-1]), one-sided and unhalved at x = 0, W-1
//   gy = 0.5 (g[y+1, x] - g[y-1, x]), one-sided and unhalved at y = 0, H-1
// zero beyond (H, W) up to (Hp, Wp), rounded to bf16 to nearest even.
// A spatial slab's rows f0 and f1 (the image's first and last rows, where
// they fall inside the slab; -1 otherwise) take gy x 2 after the
// difference: there the slab's central difference is half the image's
// one-sided one (siftgpu_tpu/ops/grad_stencil.py:86-95).
//
// What bounds it on the H100: pure data movement — 4 B read and 2 x 2 B
// written per pixel, ~3 flops.  The design: a thread owns 8 consecutive x
// (one 16-byte bf16 store per plane and row) and a strip of R rows; it loads
// the strip's R+2 rows (y-1 .. y+R) once, all in flight together (two float4
// loads a row where W and Wp are multiples of 8 and the pointers 16-byte
// aligned — every main-path octave — scalar loads otherwise), and takes the
// x-1 / x+8 halo from the neighbouring lanes by __shfl, or by one scalar load
// at the warp's edges.  R = 4 on planes with enough strips to fill the card
// (octave 0 of the main path), R = 1 on smaller ones, whose time is the
// latency of a thread's instructions, not bytes.  blockIdx.z is the (frame,
// level) plane and a 2-D grid covers the strips and column chunks: 32-bit
// index math, no division per element.  One subtraction and one exact
// halving per value, then
// __float2bfloat16_rn: bit-identical to the plain version.
// ops/grad_stencil.py::launch_plan states the launch.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kCols = 8;            // consecutive x of a thread
constexpr int kRows = 4;            // rows of a thread's strip on large planes
constexpr int kThreads = 256;       // threads of a block (at most)
constexpr int kMinBlocks = 4 * 132; // blocks a kRows grid needs, else 1 row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x = a at the lower address
  return *reinterpret_cast<const unsigned*>(&h);
}

template <bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int x0, int W,
                                         float (&v)[kCols]) {
  if (VEC) {
    if (x0 < W) {  // W % 8 == 0: the whole chunk is inside
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + x0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(row + x0 + 4));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = x0 + j < W ? __ldg(row + x0 + j) : 0.0f;
  }
}

// blockDim.x is a multiple of 32, so a warp shares threadIdx.y (its strip)
// and its lanes hold consecutive column chunks.  SLAB: row f0 or f1 lies in
// the plane (a spatial slab holding an image edge row); without it the
// kernel is the whole-image one, instruction for instruction.
template <bool VEC, int R, bool SLAB>
__global__ void __launch_bounds__(kThreads) grad_stencil_kernel(
    const float* __restrict__ gauss, __nv_bfloat16* __restrict__ gx,
    __nv_bfloat16* __restrict__ gy, int L, int S, int H, int W, int Hp, int Wp, int f0,
    int f1) {
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R;
  if (y0 >= Hp) return;  // the whole warp
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  const int lane = threadIdx.x & 31;
  const int bs = blockIdx.z;  // b * S + s
  const int b = bs / S;       // once per thread
  const float* g = gauss + static_cast<size_t>(b * L + (bs - b * S) + 1) * H * W;

  // rows y0-1 .. y0+R (rows outside [0, H) are never read as values), and
  // at the warp's edges the x-1 / x+8 halo of each output row: all loads
  // in flight together, one round trip
  float r[R + 2][kCols], el[R], er[R];
#pragma unroll
  for (int i = 0; i < R + 2; ++i) {
    const int yy = y0 - 1 + i;
    if (yy >= 0 && yy < H) {
      load_row<VEC>(g + yy * W, x0, W, r[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) r[i][j] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int y = y0 + i;
    el[i] = lane == 0 && y < H && x0 > 0 && x0 <= W ? __ldg(g + y * W + x0 - 1) : 0.0f;
    er[i] = lane == 31 && y < H && x0 + kCols < W ? __ldg(g + y * W + x0 + kCols) : 0.0f;
  }
  // elsewhere the halo is the neighbouring lanes' end values
  float hl[R], hr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float up = __shfl_up_sync(kFull, r[i + 1][kCols - 1], 1);
    const float down = __shfl_down_sync(kFull, r[i + 1][0], 1);
    hl[i] = lane == 0 ? el[i] : up;
    hr[i] = lane == 31 ? er[i] : down;
  }
  if (x0 >= Wp) return;

  const size_t plane = static_cast<size_t>(bs) * Hp * Wp;
  __nv_bfloat16* ox = gx + plane;
  __nv_bfloat16* oy = gy + plane;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int y = y0 + i;
    if (y >= Hp) break;
    float vx[kCols], vy[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int x = x0 + j;
      vx[j] = 0.0f;
      vy[j] = 0.0f;
      if (y < H && x < W) {
        const float c = r[i + 1][j];
        const float left = j == 0 ? hl[i] : r[i + 1][j - 1];
        const float right = j == kCols - 1 ? hr[i] : r[i + 1][j + 1];
        if (x == 0) vx[j] = right - c;
        else if (x == W - 1) vx[j] = c - left;
        else vx[j] = 0.5f * (right - left);
        if (y == 0) vy[j] = r[i + 2][j] - c;
        else if (y == H - 1) vy[j] = c - r[i][j];
        else vy[j] = 0.5f * (r[i + 2][j] - r[i][j]);
        if (SLAB && (y == f0 || y == f1)) vy[j] = vy[j] * 2.0f;
      }
    }
    const int o = y * Wp + x0;
    if (VEC) {
      *reinterpret_cast<uint4*>(ox + o) =
          make_uint4(pack_bf16x2(vx[0], vx[1]), pack_bf16x2(vx[2], vx[3]),
                     pack_bf16x2(vx[4], vx[5]), pack_bf16x2(vx[6], vx[7]));
      *reinterpret_cast<uint4*>(oy + o) =
          make_uint4(pack_bf16x2(vy[0], vy[1]), pack_bf16x2(vy[2], vy[3]),
                     pack_bf16x2(vy[4], vy[5]), pack_bf16x2(vy[6], vy[7]));
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (x0 + j < Wp) {
          ox[o + j] = __float2bfloat16_rn(vx[j]);
          oy[o + j] = __float2bfloat16_rn(vy[j]);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool VEC, bool SLAB>
void launch_strips(const dim3& grid, const dim3& block, int rows, cudaStream_t stream,
                   const float* gauss, __nv_bfloat16* gx, __nv_bfloat16* gy, int L, int S,
                   int H, int W, int Hp, int Wp, int f0, int f1) {
  if (rows == kRows)
    grad_stencil_kernel<VEC, kRows, SLAB><<<grid, block, 0, stream>>>(gauss, gx, gy, L, S, H, W,
                                                                        Hp, Wp, f0, f1);
  else
    grad_stencil_kernel<VEC, 1, SLAB><<<grid, block, 0, stream>>>(gauss, gx, gy, L, S, H, W, Hp,
                                                                    Wp, f0, f1);
}

template <bool VEC>
void launch(const dim3& grid, const dim3& block, int rows, cudaStream_t stream,
            const float* gauss, __nv_bfloat16* gx, __nv_bfloat16* gy, int L, int S, int H,
            int W, int Hp, int Wp, int f0, int f1) {
  if ((f0 >= 0 && f0 < H) || (f1 >= 0 && f1 < H))
    launch_strips<VEC, true>(grid, block, rows, stream, gauss, gx, gy, L, S, H, W, Hp, Wp, f0, f1);
  else
    launch_strips<VEC, false>(grid, block, rows, stream, gauss, gx, gy, L, S, H, W, Hp, Wp, f0, f1);
}

}  // namespace

// f0, f1: the rows whose gy is doubled (-1: none); ops/grad_stencil.py
// derives them from a slab's y0 and global_h.
extern "C" int grad_stencil_launch(const float* gauss, __nv_bfloat16* gx,
                                   __nv_bfloat16* gy, int B, int L, int S,
                                   int H, int W, int Hp, int Wp, int f0, int f1,
                                   cudaStream_t stream) {
  if (B * S == 0 || Hp == 0 || Wp == 0) return 0;
  const int chunks = (Wp + kCols - 1) / kCols;
  const int tx = chunks >= kThreads ? kThreads : (chunks + 31) / 32 * 32;
  const int ty = kThreads / tx;
  const int gx_blocks = (chunks + tx - 1) / tx;
  const long long strips4 = (Hp + kRows * ty - 1) / (kRows * ty);
  const int rows = static_cast<long long>(gx_blocks) * strips4 * B * S >= kMinBlocks ? kRows : 1;
  const dim3 block(tx, ty);
  const dim3 grid(gx_blocks, (Hp + rows * ty - 1) / (rows * ty), B * S);
  const bool vec = W % kCols == 0 && Wp % kCols == 0 && aligned16(gauss) &&
                   aligned16(gx) && aligned16(gy);
  if (vec)
    launch<true>(grid, block, rows, stream, gauss, gx, gy, L, S, H, W, Hp, Wp, f0, f1);
  else
    launch<false>(grid, block, rows, stream, gauss, gx, gy, L, S, H, W, Hp, Wp, f0, f1);
  return static_cast<int>(cudaGetLastError());
}
