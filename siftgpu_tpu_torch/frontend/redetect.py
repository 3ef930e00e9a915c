"""Descriptor-only mode: descriptors at a preset keypoint list.

Port of `siftgpu_tpu/frontend/redetect.py` (`SiftGPU::SetKeypointList` +
`RunSIFT`): callers supply (x, y, sigma, theta) in image coordinates and get
128-D descriptors.  Each keypoint is assigned to the octave where its scale
is octave-local in [sigma0, 2·sigma0), and to the Gaussian level nearest its
scale (`torch.round`, half to even, as `jnp.round`).  Where the reference
describes the full list on every octave and keeps the rows assigned to each
(fixed shapes), the port samples each keypoint once, on its own octave
(`describe.describe_octaves`: one `ops/desc_sampler.py` call per octave into
a shared buffer, one binning pass).  Its octave-local coordinates divide by
its own octave's scale, a power of two, so they are the bits the
reference's per-octave scalar arithmetic gives.  `describe_at_keypoints_jit`
is the reference's jitted `describe_at_keypoints` (cfg static), captured once
per signature on CUDA inputs (`core/graphs.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import SiftConfig
from ..core.graphs import graphed
from . import describe, orient, pyramid
from .extract import Features

__all__ = ["describe_at_keypoints", "describe_at_keypoints_jit"]

# f32 ln 2: the reference's log2 is log(x) / log(2) in f32
_LN2 = float(np.float32(math.log(2.0)))


def _log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) / _LN2


def describe_at_keypoints(images: torch.Tensor, keypoints: torch.Tensor,
                          cfg: SiftConfig) -> Features:
    """images: [B, H, W]; keypoints: [B, K, 4] (x, y, sigma, theta) in image
    coordinates, on the images' device.  Returns Features with descriptors
    at the given points (mask: the keypoint has a valid octave)."""
    B, K = keypoints.shape[:2]
    x, y, sig, th = (keypoints[..., i].to(torch.float32) for i in range(4))
    S = cfg.dog_levels
    pyr = pyramid.build_pyramid(images, cfg)

    # octave assignment: sigma / 2^(o + fo) in [sigma0, 2 sigma0)
    ratio = _log2(torch.clamp(sig, min=1e-6) / cfg.sigma0) - cfg.first_octave
    oct_f = torch.floor(ratio)
    octave = oct_f.clamp(0, cfg.octaves - 1).to(torch.int32)
    valid = (sig > 0) & (oct_f >= 0) & (oct_f < cfg.octaves)

    # each keypoint's own octave (-1: none) and that octave's scale
    live = torch.where(valid, octave, -1)
    scale = torch.ones_like(x)
    for o in range(cfg.octaves):
        scale = torch.where(live == o, cfg.octave_scale(o), scale)
    shift = 0.5 if cfg.lowe_origin else 0.0
    xo = x / scale - shift
    yo = y / scale - shift
    sigma_local = torch.clamp(sig / scale, cfg.sigma0 * 0.5, cfg.sigma0 * 4.0)
    lvl = torch.round(S * _log2(torch.clamp(sigma_local, min=1e-6) / cfg.sigma0))
    lvl = lvl.clamp(1, S).to(torch.int32)
    grads = [orient.gradient_stack(oc.gauss, cfg) for oc in pyr]
    desc = describe.describe_octaves(grads, live, yo, xo, sigma_local, th, lvl, cfg)
    desc = torch.where(valid[..., None], desc, 0)

    return Features(x=x, y=y, sigma=sig, theta=th, response=torch.zeros_like(x),
                    octave=octave, desc=desc, mask=valid)


describe_at_keypoints_jit = graphed(describe_at_keypoints, "describe_at_keypoints_jit")
