"""Fused orientation + descriptor path built on `ops/kp_engine.py`.

Port of `siftgpu_tpu/frontend/fused.py`: one pass per keypoint over its
gradient window builds the orientation histogram and samples the rotated
descriptor grid for each orientation; `describe.bin_descriptors` bins them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.config import SiftConfig
from ..ops import kp_engine
from . import describe
from .detect import OctaveKeypoints
from .orient import GradStack

__all__ = ["orient_describe_fused"]


def orient_describe_fused(
    grads: GradStack, kp: OctaveKeypoints, cfg: SiftConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (theta [B, K*n], valid [B, K*n], desc uint8 [B, K*n, 128]) in
    keypoint-major / orientation-minor layout."""
    B, K = kp.y.shape
    S = grads.gx.shape[1]
    Hp, Wp = grads.gx.shape[-2:]
    n = cfg.max_orientations
    G2 = cfg.descriptor_grid ** 2

    b_idx = torch.arange(B, dtype=torch.int32, device=kp.y.device)[:, None]
    plane = (b_idx * S + (kp.grad_level - 1)).reshape(B * K)
    theta, haspk, sgx, sgy = kp_engine.orient_sample(
        grads.gx.reshape(B * S, Hp, Wp), grads.gy.reshape(B * S, Hp, Wp),
        plane.contiguous(), kp.y.reshape(B * K).contiguous(),
        kp.x.reshape(B * K).contiguous(), kp.sigma.reshape(B * K).contiguous(),
        cfg, kp.mask.reshape(B * K).contiguous(), grads.image_h, grads.w, grads.y0,
    )
    theta = theta.reshape(B, K, n)
    valid = haspk.reshape(B, K, n) & kp.mask[..., None]
    # slot 0 fallback: a degenerate histogram still yields one theta=0 keypoint
    valid[..., 0] = kp.mask
    theta2 = theta.reshape(B, K * n)
    desc = describe.bin_descriptors(
        sgx.reshape(B, K * n, G2), sgy.reshape(B, K * n, G2), theta2, cfg
    )
    return theta2, valid.reshape(B, K * n), desc
