"""Dense keypoint-score pass over the DoG volume: CUDA kernel + plain version.

Replaces `siftgpu_tpu/ops/detect_scores.py::detect_scores` (Pallas) and
mirrors `siftgpu_tpu/frontend/detect.py::_dense_scores_xla` (its XLA route).
For every pixel of DoG slices 1..S it tests for a strict 26-neighbour
extremum passing |v| > 0.8·threshold, the Hessian edge ratio and the 1-px
border, and emits

  s_max, s_min  [B, S, He/2, We]  row-pooled |DoG| of maxima / minima, the
                                   2x2 corner packed in the low 2 mantissa bits
  val, off_l, off_y, off_x  [B, S, He, We]  the Cramer 3x3 subpixel record

with (He, We) = (H, W) rounded up to even and zeros in the padding.
`owned_rows=(lo, hi)` (a spatial slab's own rows) keeps candidates to rows
[lo, hi) as well; the records stay dense.

`detect_scores(dog, cfg, owned_rows)` takes the plain version for a CPU
tensor and the CUDA kernel (`csrc/detect_scores.cu`: one block per frame
and 16 x 64 tile,
every DoG plane of the tile staged once in shared memory with its halo,
float2 stores; `launch_plan` states the launch) for a CUDA tensor.  The
kernel is compiled with -fmad=false and repeats the plain version's
operations in the same order, so its outputs are bit-identical to the plain
version's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["detect_scores", "detect_scores_plain", "candidate_rows", "cramer_record", "launch_plan",
           "KERNEL"]

KERNEL = _build.Kernel(
    "detect_scores", "detect_scores.cu",
    {"detect_scores_launch": [ctypes.c_void_p] * 7
     + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]},
    flags=["-fmad=false"],
)


# csrc/detect_scores.cu's constants: output tile (rows, columns), pixels per
# thread (a row pair x 2 columns), threads, planes in the shared ring, the
# window's columns beside the tile on each side (16-byte aligned chunks);
# a plane with fewer tiles than 2 blocks per SM of the H100's 132 gets a
# block per slice
TILE, THREAD_PIXELS, THREADS, RING, WIN_SIDE = (16, 64), (2, 2), 256, 4, 4
MIN_BLOCKS = 2 * 132


def launch_plan(B: int, S: int, H: int, W: int) -> dict:
    """The detect kernel's launch for a DoG volume [B, S+2, H, W], as
    `csrc/detect_scores.cu` runs it: one block per frame and 16 x 64 tile of
    the even-padded (He, We) output, walking all S slices
    (`slices_per_block` = S), or one block per slice where the tiles number
    fewer than MIN_BLOCKS (`slices_per_block` = 1); the block's 256 threads
    each own a row pair x 2 consecutive columns (float2 stores); each DoG
    plane a block needs is staged once with a 1-pixel halo (a window of 18
    rows x 72 columns, 4 each side) into a ring of 4 planes in shared
    memory, by 16-byte copies when W is a multiple of 4 (`vector_loads`)."""
    if min(B, S, H, W) <= 0:
        raise ValueError(f"launch_plan: empty volume ({B}, {S} + 2, {H}, {W})")
    He, We = H + H % 2, W + W % 2
    th, tw = TILE
    win = (th + 2, tw + 2 * WIN_SIDE)
    tiles = (-(-We // tw), -(-He // th))
    spb = S if tiles[0] * tiles[1] * B >= MIN_BLOCKS else 1
    return dict(tile=TILE, thread_pixels=THREAD_PIXELS, threads=THREADS, halo=1, ring=RING,
                window=win, smem_bytes=RING * win[0] * win[1] * 4, slices_per_block=spb,
                grid=(tiles[0], tiles[1], B * (S // spb)), out_shape=(He, We),
                vector_loads=W % 4 == 0)


def _f32(x: float) -> float:
    return float(np.float32(x))


def thresholds(cfg):
    """(pre-threshold 0.8·t, edge bound (r+1)²/r), rounded to f32 once so the
    plain version and the kernel compare against the same values."""
    r = cfg.edge_threshold
    return _f32(0.8 * cfg.dog_threshold), _f32((r + 1.0) ** 2 / r)


def cramer_record(q, subpixel: bool):
    """Closed-form (Cramer) 3x3 subpixel solve at every pixel, operation for
    operation as the reference's `cramer_record`; `q(dl, dy, dx)` returns
    the DoG taps at that offset.  Returns (val, off_l, off_y, off_x,
    (dyy, dxx, dxy))."""
    vc = q(0, 0, 0)
    d = q(0, 1, 0) + q(0, -1, 0) - 2 * vc
    f = q(0, 0, 1) + q(0, 0, -1) - 2 * vc
    e_ = 0.25 * (q(0, 1, 1) - q(0, 1, -1) - q(0, -1, 1) + q(0, -1, -1))
    if not subpixel:
        zero = vc * 0.0
        return vc, zero, zero, zero, (d, f, e_)
    gl = 0.5 * (q(1, 0, 0) - q(-1, 0, 0))
    gy = 0.5 * (q(0, 1, 0) - q(0, -1, 0))
    gx = 0.5 * (q(0, 0, 1) - q(0, 0, -1))
    a = q(1, 0, 0) + q(-1, 0, 0) - 2 * vc
    b_ = 0.25 * (q(1, 1, 0) - q(1, -1, 0) - q(-1, 1, 0) + q(-1, -1, 0))
    c_ = 0.25 * (q(1, 0, 1) - q(1, 0, -1) - q(-1, 0, 1) + q(-1, 0, -1))
    i00 = d * f - e_ * e_
    i01 = c_ * e_ - b_ * f
    i02 = b_ * e_ - c_ * d
    i11 = a * f - c_ * c_
    i12 = b_ * c_ - a * e_
    i22 = a * d - b_ * b_
    detH = a * i00 + b_ * i01 + c_ * i02
    ok_det = detH.abs() > _f32(1e-12)
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, detH, 1.0),
                          torch.zeros_like(detH))
    off_l = -(i00 * gl + i01 * gy + i02 * gx) * inv_det
    off_y = -(i01 * gl + i11 * gy + i12 * gx) * inv_det
    off_x = -(i02 * gl + i12 * gy + i22 * gx) * inv_det
    val = vc + 0.5 * (gl * off_l + gy * off_y + gx * off_x)
    return val, off_l, off_y, off_x, (d, f, e_)


def _pack_corner(s: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """Overwrite the two low mantissa bits of positive scores with `par`."""
    u = s.view(torch.int32)
    u = torch.where(s > 0, (u & ~3) | par, torch.zeros_like(u))
    return u.view(torch.float32)


def candidate_rows(H: int, owned_rows=None) -> tuple:
    """(ylo, yhi): the rows that may hold a candidate, the interior rows
    1..H-2 within `owned_rows=(lo, hi)` (default (0, H)), as the
    reference's kernel takes them (`siftgpu_tpu/ops/detect_scores.py:327-331`)."""
    lo, hi = owned_rows if owned_rows is not None else (0, H)
    return max(1, int(lo)), min(H - 2, int(hi) - 1)


def detect_scores_plain(dog: torch.Tensor, cfg, owned_rows=None):
    """Plain PyTorch version (the reference's `_dense_scores_xla`).
    dog: [B, S+2, H, W] f32; `owned_rows=(lo, hi)` restricts candidates to
    rows [lo, hi)."""
    B, L, H, W = dog.shape
    S = L - 2
    dog = dog.to(torch.float32)
    v = dog[:, 1 : S + 1]

    # strict 26-neighbour extremum test (max/min are exact in any order)
    ninf = torch.nn.functional.pad(dog, (1, 1, 1, 1), value=float("-inf"))
    pinf = torch.nn.functional.pad(dog, (1, 1, 1, 1), value=float("inf"))
    nmax = nmin = None
    for dl in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if (dl, dy, dx) == (1, 1, 1):
                    continue
                a = ninf[:, dl : dl + S, dy : dy + H, dx : dx + W]
                b = pinf[:, dl : dl + S, dy : dy + H, dx : dx + W]
                nmax = a if nmax is None else torch.maximum(nmax, a)
                nmin = b if nmin is None else torch.minimum(nmin, b)
    thr08, edge_c = thresholds(cfg)
    pre = v.abs() > thr08
    is_max = (v > 0) & (v > nmax) & pre
    is_min = (v < 0) & (v < nmin) & pre

    dgp = torch.nn.functional.pad(dog, (1, 1, 1, 1))

    def q(dl, dy, dx):
        return dgp[:, 1 + dl : 1 + dl + S, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]

    val, off_l, off_y, off_x, (dyy, dxx, dxy) = cramer_record(q, bool(cfg.subpixel))

    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr / torch.where(det > 0, det, 1.0) < edge_c)

    yy = torch.arange(H, device=dog.device, dtype=torch.int32)[:, None]
    xx = torch.arange(W, device=dog.device, dtype=torch.int32)[None, :]
    ylo, yhi = candidate_rows(H, owned_rows)
    interior = (yy >= ylo) & (yy <= yhi) & (xx >= 1) & (xx <= W - 2)
    keep = edge_ok & interior

    par = (yy & 1) * 2 + (xx & 1)
    s_max = _pack_corner(v.abs() * (is_max & keep).to(torch.float32), par)
    s_min = _pack_corner(v.abs() * (is_min & keep).to(torch.float32), par)

    He, We = H + (H % 2), W + (W % 2)
    pad = (0, We - W, 0, He - H)
    planes = [torch.nn.functional.pad(p, pad) for p in
              (s_max, s_min, val, off_l, off_y, off_x)]
    # score planes are row-pooled (max over row pairs); the consumer pools
    # the lane pairs
    pooled = [p.view(B, S, He // 2, 2, We).amax(dim=3) for p in planes[:2]]
    return tuple(pooled) + tuple(planes[2:])


def _detect_scores_cuda(dog: torch.Tensor, cfg, owned_rows=None):
    _build.check_tensor(dog, "dog", torch.float32, 4)
    B, L, H, W = dog.shape
    S = L - 2
    He, We = H + (H % 2), W + (W % 2)
    half = torch.empty((2, B, S, He // 2, We), dtype=torch.float32, device=dog.device)
    recs = torch.empty((4, B, S, He, We), dtype=torch.float32, device=dog.device)
    thr08, edge_c = thresholds(cfg)
    plan = launch_plan(B, S, H, W)
    p = _build.ptr
    KERNEL.launch(
        "detect_scores_launch", dog.device,
        p(dog), p(half[0]), p(half[1]), p(recs[0]), p(recs[1]), p(recs[2]), p(recs[3]),
        B, S, H, W, *candidate_rows(H, owned_rows), thr08, edge_c, int(bool(cfg.subpixel)),
        plan["slices_per_block"],
    )
    return (half[0], half[1], recs[0], recs[1], recs[2], recs[3])


def detect_scores(dog: torch.Tensor, cfg, owned_rows=None):
    """dog: [B, S+2, H, W] f32 -> (s_max, s_min, val, off_l, off_y, off_x);
    `owned_rows=(lo, hi)` keeps candidates to rows [lo, hi) (default: the
    whole volume).  CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if dog.device.type == "cpu":
        return detect_scores_plain(dog, cfg, owned_rows)
    return _detect_scores_cuda(dog, cfg, owned_rows)
