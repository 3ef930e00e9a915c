"""Gaussian / DoG pyramid on batched image tensors.

Port of `siftgpu_tpu/frontend/pyramid.py`.  The initial blur is a plain f32
separable convolution with replicate edges on every device (the reference's
conv route; the TPU's banded-matmul route has no counterpart here).  Each
octave's levels and DoGs come from `ops/pyramid_kernel.py::
blur_octave_fused`: the hand-written octave kernel on a CUDA tensor, the
sequential chain of the same blurs on a CPU tensor.  `octave_impl="xla"`
runs that chain on every device (the reference's name for its chain).
Octave o+1 is seeded by top-left 2x decimation of Gaussian level S.
`first_octave = -1` upsamples the input 2x bilinearly (`upsample2x`) before
the initial blur.

Precision: the convolutions run with TF32 off (`core.precision.full_f32`):
cuDNN's TF32 default has ~1e-3 error, of the order of the DoG contrast
threshold (6.7e-3).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import SiftConfig
from ..ops.pyramid_kernel import blur_octave_fused, blur_octave_fused_plain, blur_separable

__all__ = [
    "Octave", "blur_separable", "downsample2x", "upsample2x", "octave0_base",
    "build_pyramid", "OCTAVE_IMPLS",
]

OCTAVE_IMPLS = ("fused", "xla")


class Octave(NamedTuple):
    gauss: torch.Tensor  # [B, S+3, H, W] f32
    dog: torch.Tensor    # [B, S+2, H, W] f32


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


def _pick_octave_impl(cfg: SiftConfig) -> str:
    """Default: "fused" — the octave kernel on a CUDA tensor (the plain
    chain on a CPU tensor).

    Measured by `chip_smoke.py` on an NVIDIA H100 80GB HBM3 at a 700 W
    power limit, the 5 octaves of a 4 x 480x640 batch: the whole pyramid
    1.410 ms with the kernel against 6.008 ms with the cuDNN chain ("xla")
    (CUDA events, both set by the host's launches); the card's own time
    (torch.profiler) per octave 0.0635 / 0.0329 / 0.0327 / 0.0320 / 0.0291
    ms for the kernel against 0.3270 / 0.1044 / 0.0486 / 0.0475 / 0.0471 ms
    for the chain's convolutions alone."""
    return "fused"


def _octave_levels(base: torch.Tensor, cfg: SiftConfig, impl: Optional[str] = None) -> Octave:
    """One octave's (gauss, dog) from its base level: `impl` "fused" (the
    default) routes by device, "xla" runs the plain chain everywhere."""
    impl = impl or _pick_octave_impl(cfg)
    if impl not in OCTAVE_IMPLS:
        raise ValueError(f"octave_impl: expected one of {OCTAVE_IMPLS}, got {impl!r}")
    taps = [cfg.gaussian_taps(float(s)) for s in cfg.incremental_sigmas()]
    fn = blur_octave_fused if impl == "fused" else blur_octave_fused_plain
    return Octave(*fn(base, taps))


def build_pyramid(images: torch.Tensor, cfg: SiftConfig,
                  octave_impl: Optional[str] = None) -> Tuple[Octave, ...]:
    """images: [B, H, W] grayscale in [0, 1] on any device. Returns the
    per-octave (gauss, dog) on the same device.  `octave_impl`: "fused"
    (default) or "xla", as in the reference."""
    base = octave0_base(images, cfg)
    octaves: List[Octave] = []
    for _ in range(cfg.octaves):
        oc = _octave_levels(base, cfg, octave_impl)
        octaves.append(oc)
        base = downsample2x(oc.gauss[:, cfg.dog_levels])
    return tuple(octaves)
