"""One octave's incremental Gaussian blurs and DoGs: CUDA kernel + plain version.

Replaces `siftgpu_tpu/ops/pyramid_kernel.py::blur_octave_fused` (Pallas).
From an octave's base level (already blurred to level 0's sigma) and the
incremental taps of levels 1..L-1 (`cfg.gaussian_taps(s)` for `s` in
`cfg.incremental_sigmas()`):

    gauss[:, 0] = base
    gauss[:, s] = blur_separable(gauss[:, s-1], taps[s-1])   (W, then H)
    dog[:, s-1] = gauss[:, s] - gauss[:, s-1]

with replicate edges of level s-1 at every level (not a blur of the
replicated base, which differs near the borders).

`blur_octave_fused(base, taps_list)` takes the plain version for a CPU tensor
and the CUDA kernel (`csrc/pyramid_octave.cu`: one cooperative launch per
octave whose blocks walk 64x64 tiles level by level, each level read back
from device memory with only its own radius as halo; `launch_plan` states
the launch) for a CUDA tensor.  The plain version is the sequential chain
of f32 separable convolutions, TF32 off (cuDNN on the card).  The kernel
sums each pass's taps in order with fused multiply-adds, which on an H100
equals cuDNN's direct convolutions bit for bit; the bound it is held to is
1e-5 absolute, the reference's own fused-versus-chain bound.

`blur_separable` lives here because it is the plain version's building
block; `frontend/pyramid.py` uses it for the initial blur as well.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..core.graphs import device_constant
from ..core.precision import full_f32
from . import _build

__all__ = ["blur_separable", "blur_octave_fused", "blur_octave_fused_plain", "launch_plan",
           "KERNEL"]

KERNEL = _build.Kernel(
    "blur_octave_fused", "pyramid_octave.cu",
    {"blur_octave_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
     + [ctypes.c_void_p]},
    flags=["-fmad=false"],
)

# csrc/pyramid_octave.cu's constants: output tile, threads per block, static
# tap storage, levels, and the shared memory a block may hold (227 KB, less
# the static arrays)
TILE, THREADS, _MAX_TAPS, _MAX_LEVELS = (64, 64), 256, 256, 32
_SMEM_BYTES = 232448 - (_MAX_TAPS + 2 * _MAX_LEVELS) * 4


def blur_separable(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W] f32 with replicate edges: the
    columns (W) first, then the rows (H), as the reference's conv route.
    Each image is convolved alone, so an image's result does not depend on
    the batch it came in (a batched convolution may pick another algorithm,
    and round otherwise, for another batch size: oneDNN on the CPU does)."""
    a = np.asarray(taps, np.float32)
    t = device_constant(("taps", a.tobytes()), x.device, lambda: a)
    r = (t.shape[0] - 1) // 2
    out = []
    with full_f32():
        for xi in x:
            y = F.conv2d(F.pad(xi[None, None], (r, r, 0, 0), mode="replicate"),
                         t.view(1, 1, 1, -1))
            out.append(F.conv2d(F.pad(y, (0, 0, r, r), mode="replicate"),
                                t.view(1, 1, -1, 1))[:, 0])
    return torch.cat(out)


def blur_octave_fused_plain(base: torch.Tensor, taps_list):
    """base [B, H, W] f32 -> (gauss [B, L, H, W], dog [B, L-1, H, W]),
    L = len(taps_list) + 1: the sequential per-level chain."""
    levels = [base]
    for taps in taps_list:
        levels.append(blur_separable(levels[-1], taps))
    gauss = torch.stack(levels, dim=1)
    return gauss, gauss[:, 1:] - gauss[:, :-1]


def _taps_operands(taps_list, device):
    """(taps back to back [sum(2r+1)] f32, radii [L-1] int32) on `device`,
    cached per taps and device."""
    arrs = [np.asarray(t, np.float32) for t in taps_list]
    if any(a.ndim != 1 or a.shape[0] % 2 == 0 for a in arrs):
        raise ValueError("taps: expected 1-D arrays of odd length")
    key = tuple(a.tobytes() for a in arrs)
    radii = lambda: np.array([(a.shape[0] - 1) // 2 for a in arrs], np.int32)
    return (device_constant(("octave taps", key), device, lambda: np.concatenate(arrs)),
            device_constant(("octave radii", key), device, radii))


def launch_plan(B: int, H: int, W: int, radii) -> dict:
    """The octave kernel's launch for a [B, H, W] base and the levels' tap
    radii, as `csrc/pyramid_octave.cu` sizes it: 64x64 output tiles; level
    s reads level s-1 with a halo of its own radius `halo[s-1]`; the shared
    memory holds one input window of the largest radius, (64 + 2r) rows at
    an odd pitch of (64 + 2r) | 1, beside a (64 + 2r) x 65 row-pass buffer.
    The grid is at most `tiles` blocks (the C entry caps it at the blocks
    that fit on the card at once: a cooperative launch)."""
    radii = [int(r) for r in radii]
    if not 1 <= len(radii) <= _MAX_LEVELS:
        raise ValueError(f"taps_list: expected 1..{_MAX_LEVELS} levels, got {len(radii)}")
    ntaps = sum(2 * r + 1 for r in radii)
    if ntaps > _MAX_TAPS:
        raise ValueError(f"taps_list: {ntaps} taps in all, at most {_MAX_TAPS}")
    th, tw = TILE
    rmax = max(radii)
    smem = 4 * (th + 2 * rmax) * (((tw + 2 * rmax) | 1) + tw + 1)
    if smem > _SMEM_BYTES:
        raise ValueError(f"taps: a radius of {rmax} px does not fit in shared memory")
    tiles = B * -(-H // th) * -(-W // tw)
    return dict(tile=TILE, threads=THREADS, tiles=tiles, smem_bytes=smem,
                halo=tuple(radii), rmax=rmax, ntaps=ntaps)


def _blur_octave_cuda(base: torch.Tensor, taps_list):
    _build.check_tensor(base, "base", torch.float32, 3)
    n = len(taps_list)
    B, H, W = base.shape
    taps, radii = _taps_operands(taps_list, base.device)
    plan = launch_plan(B, H, W, [(len(t) - 1) // 2 for t in taps_list])
    gauss = torch.empty((B, n + 1, H, W), dtype=torch.float32, device=base.device)
    dog = torch.empty((B, n, H, W), dtype=torch.float32, device=base.device)
    if gauss.numel() == 0:
        return gauss, dog
    p = _build.ptr
    KERNEL.launch("blur_octave_launch", base.device, p(base), p(taps), p(radii),
                  p(gauss), p(dog), B, H, W, n, plan["ntaps"], plan["rmax"])
    return gauss, dog


def blur_octave_fused(base: torch.Tensor, taps_list):
    """All incremental levels and DoGs of one octave: base [B, H, W] f32,
    taps_list the per-level incremental taps -> (gauss [B, L, H, W],
    dog [B, L-1, H, W]), L = len(taps_list) + 1."""
    if base.device.type == "cpu":
        return blur_octave_fused_plain(base, taps_list)
    return _blur_octave_cuda(base, taps_list)
