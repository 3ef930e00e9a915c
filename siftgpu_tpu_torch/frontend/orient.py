"""Gradient stack for orientation assignment and descriptor sampling.

Port of `siftgpu_tpu/frontend/orient.py::gradient_stack` for one chip: the
stack holds the gradients of Gaussian levels 1..S, zero-padded to at least
the orientation window, stored as bf16 (round-to-nearest-even).  The top-K
and orientation budgets of the reference rest on that storage.  The slab
factor of the spatially sharded path (`y0`, `global_h`) is not ported.

The orientation histogram itself runs inside the fused orientation +
sampling kernel (`ops/kp_engine.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import SiftConfig
from ..ops.grad_stencil import grad_stencil

__all__ = ["GradStack", "gradient_stack"]


class GradStack(NamedTuple):
    gx: torch.Tensor  # [B, S, Hp, Wp] bf16
    gy: torch.Tensor  # [B, S, Hp, Wp] bf16
    h: int            # true (unpadded) height
    w: int            # true width


def gradient_stack(gauss: torch.Tensor, cfg: SiftConfig) -> GradStack:
    """gauss: [B, S+3, H, W] -> central-difference grads of levels 1..S."""
    H, W = gauss.shape[-2:]
    win = 2 * cfg.orient_window_radius + 1
    gx, gy = grad_stencil(gauss, cfg.dog_levels, min_h=win, min_w=win)
    return GradStack(gx=gx, gy=gy, h=H, w=W)
