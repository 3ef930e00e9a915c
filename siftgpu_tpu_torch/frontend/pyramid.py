"""Gaussian / DoG pyramid on batched image tensors.

Port of `siftgpu_tpu/frontend/pyramid.py` on its convolution route
(`_conv1d`): each blur is a plain f32 separable convolution with replicate
edges on every device — the TPU's banded-matmul route has no counterpart
here.  Octave o+1 is seeded by top-left 2x decimation of Gaussian level S.
`first_octave = -1` upsamples the input 2x bilinearly (`upsample2x`) before
the initial blur.

Precision: a float32 convolution on the card defaults to TF32 in cuDNN,
whose ~1e-3 error is of the order of the DoG contrast threshold (6.7e-3).
`full_f32()` turns TF32 off for cuDNN convolutions and cuBLAS matmuls for the
duration of a call and restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import SiftConfig

__all__ = [
    "Octave", "blur_separable", "downsample2x", "upsample2x", "octave0_base",
    "build_pyramid", "full_f32",
]


class Octave(NamedTuple):
    gauss: torch.Tensor  # [B, S+3, H, W] f32
    dog: torch.Tensor    # [B, S+2, H, W] f32


@contextlib.contextmanager
def full_f32():
    """Run f32 convolutions and matmuls in full f32 (no TF32) inside."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


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


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """Top-left 2x decimation (oracle `gauss[S][::2, ::2]`)."""
    return x[:, ::2, ::2].contiguous()


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of [B, H, W] with half-pixel centres and clamped
    edges: the reference's `jax.image.resize(..., "linear")` (which, for an
    upscale, is the same triangle filter with renormalised edge weights)."""
    return F.interpolate(x[:, None], scale_factor=2, mode="bilinear",
                         align_corners=False)[:, 0]


def octave0_base(images: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Input conditioning (-fo: 2x upsample or n decimations) and the initial
    blur -> octave 0's Gaussian level 0, [B, H0, W0] f32."""
    x = images.to(torch.float32)
    if cfg.upsampled:
        x = upsample2x(x)
    else:
        for _ in range(cfg.first_octave):
            x = downsample2x(x)
    return blur_separable(x, cfg.gaussian_taps(cfg.initial_blur_sigma()))


def _octave_levels(base: torch.Tensor, cfg: SiftConfig) -> Octave:
    levels = [base]
    for s in cfg.incremental_sigmas():
        levels.append(blur_separable(levels[-1], cfg.gaussian_taps(float(s))))
    gauss = torch.stack(levels, dim=1)            # [B, S+3, H, W]
    dog = gauss[:, 1:] - gauss[:, :-1]            # [B, S+2, H, W]
    return Octave(gauss=gauss, dog=dog)


def build_pyramid(images: torch.Tensor, cfg: SiftConfig) -> Tuple[Octave, ...]:
    """images: [B, H, W] grayscale in [0, 1] on any device. Returns the
    per-octave (gauss, dog) on the same device."""
    base = octave0_base(images, cfg)
    octaves: List[Octave] = []
    for _ in range(cfg.octaves):
        oc = _octave_levels(base, cfg)
        octaves.append(oc)
        base = downsample2x(oc.gauss[:, cfg.dog_levels])
    return tuple(octaves)
