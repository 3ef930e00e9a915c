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
and the CUDA kernel (`csrc/pyramid_octave.cu`: one launch per octave, every
level in shared memory, built with -fmad=false) for a CUDA tensor.  The plain
version is the sequential chain of f32 separable convolutions, TF32 off
(cuDNN on the card).  The two sum the taps in different orders: they agree
within 1e-5 absolute, the reference's own fused-versus-chain bound.

`blur_separable` lives here because it is the plain version's building
block; `frontend/pyramid.py` uses it for the initial blur as well.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import full_f32
from . import _build

__all__ = ["blur_separable", "blur_octave_fused", "blur_octave_fused_plain", "KERNEL"]

KERNEL = _build.Kernel(
    "blur_octave_fused", "pyramid_octave.cu",
    {"blur_octave_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
     + [ctypes.c_void_p]},
    flags=["-fmad=false"],
)

# csrc/pyramid_octave.cu's limits: tile width, static tap storage, levels,
# and the shared memory a block may hold (227 KB, less the static arrays)
_TX, _MAX_TAPS, _MAX_LEVELS = 32, 256, 32
_SMEM_BYTES = 232448 - (_MAX_TAPS + 2 * _MAX_LEVELS) * 4

_TAPS_CACHE: dict = {}


def blur_separable(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W] f32 with replicate edges: the
    columns (W) first, then the rows (H), as the reference's conv route."""
    t = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
    r = (t.shape[0] - 1) // 2
    with full_f32():
        y = F.conv2d(F.pad(x[:, None], (r, r, 0, 0), mode="replicate"),
                     t.view(1, 1, 1, -1))
        y = F.conv2d(F.pad(y, (0, 0, r, r), mode="replicate"),
                     t.view(1, 1, -1, 1))
    return y[:, 0]


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
    key = (tuple(a.tobytes() for a in arrs), str(device))
    if key not in _TAPS_CACHE:
        if any(a.ndim != 1 or a.shape[0] % 2 == 0 for a in arrs):
            raise ValueError("taps: expected 1-D arrays of odd length")
        radii = np.array([(a.shape[0] - 1) // 2 for a in arrs], np.int32)
        _TAPS_CACHE[key] = (torch.from_numpy(np.concatenate(arrs)).to(device),
                            torch.from_numpy(radii).to(device), int(radii.sum()))
    return _TAPS_CACHE[key]


def _tile_rows(R: int) -> int:
    """Output rows per tile: the largest of 32, 16, 8 whose two windows of
    (rows + 2R) x (32 + 2R) f32 fit in shared memory."""
    for ty in (32, 16, 8):
        if 2 * (ty + 2 * R) * (_TX + 2 * R) * 4 <= _SMEM_BYTES:
            return ty
    raise ValueError(f"taps: a cumulative halo of {R} px does not fit in shared memory")


def _blur_octave_cuda(base: torch.Tensor, taps_list):
    _build.check_tensor(base, "base", torch.float32, 3)
    n = len(taps_list)
    if not 1 <= n <= _MAX_LEVELS:
        raise ValueError(f"taps_list: expected 1..{_MAX_LEVELS} levels, got {n}")
    taps, radii, R = _taps_operands(taps_list, base.device)
    if taps.shape[0] > _MAX_TAPS:
        raise ValueError(f"taps_list: {taps.shape[0]} taps in all, at most {_MAX_TAPS}")
    TY = _tile_rows(R)
    B, H, W = base.shape
    gauss = torch.empty((B, n + 1, H, W), dtype=torch.float32, device=base.device)
    dog = torch.empty((B, n, H, W), dtype=torch.float32, device=base.device)
    if gauss.numel() == 0:
        return gauss, dog
    p = _build.ptr
    KERNEL.launch("blur_octave_launch", base.device, p(base), p(taps), p(radii),
                  p(gauss), p(dog), B, H, W, n, taps.shape[0], R, TY)
    return gauss, dog


def blur_octave_fused(base: torch.Tensor, taps_list):
    """All incremental levels and DoGs of one octave: base [B, H, W] f32,
    taps_list the per-level incremental taps -> (gauss [B, L, H, W],
    dog [B, L-1, H, W]), L = len(taps_list) + 1."""
    if base.device.type == "cpu":
        return blur_octave_fused_plain(base, taps_list)
    return _blur_octave_cuda(base, taps_list)
