"""Absolute pose from 2D-3D correspondences (PnP) by robust manifold GN.

Port of `siftgpu_tpu/optim/pnp.py`: the SLAM tracker's per-frame pose solve,
fixed-iteration Gauss-Newton on the 6-dof camera pose with Huber-weighted
reprojection residuals (fixed shapes, masked correspondences, no RANSAC loop
— robustness comes from the loss and from gating by the previous pose).

Differences from the reference:
  - the Jacobian is closed form instead of `jax.jacfwd`: under a left
    perturbation exp(d) o (R, t) the camera-frame point y = R X + t moves
    by [-[y]x, I] d at d = 0, which is the derivative the reference's
    forward pass takes (exp_so3 is I + [w]x there); the projection's
    derivative is `ba._proj_jacobian`'s.  The two differ only in rounding
    (poses within 1e-5, tests/test_torch_pnp.py);
  - the 6x6 systems are solved by `torch.linalg.solve_ex`, which does not
    check the factorisation on the host: nothing here synchronises;
  - contractions run with TF32 off (`full_f32`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.graphs import graphed
from ..core.precision import full_f32
from ..geometry import pose as P
from .ba import _pixels, _proj_jacobian

__all__ = ["PnPResult", "pnp_gn", "pnp_gn_jit"]


class PnPResult(NamedTuple):
    pose: torch.Tensor         # [6] se3 twist (world->cam)
    inliers: torch.Tensor      # [N] bool (< inlier_px after optimization)
    num_inliers: torch.Tensor  # [] int32
    rms: torch.Tensor          # inlier reprojection rms (px)


def _camera_points(R, t, X):
    with full_f32():
        return X @ R.transpose(-1, -2) + t


def _step(R0, t0, X, uv, intr, wv, huber_px):
    """One Huber-weighted GN step from (R0, t0); returns the new (R, t)."""
    y = _camera_points(R0, t0, X)                                 # [N, 3]
    r = _pixels(y, intr) - uv                                     # [N, 2]
    z = y[:, 2]
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(y.shape[0], 3, 3)
    with full_f32():
        J = _proj_jacobian(y, intr) @ torch.cat([-P.hat(y), eye], dim=-1)   # [N, 2, 6]
        rn = torch.linalg.vector_norm(r, dim=1)
        hw = torch.where(rn <= huber_px, torch.ones_like(rn),
                         huber_px / torch.clamp(rn, min=1e-9))
        ww = wv * hw * (z > 1e-6)
        H = torch.einsum("nia,nib,n->ab", J, J, ww) + 1e-6 * torch.eye(
            6, dtype=y.dtype, device=y.device)
        b = -torch.einsum("nia,ni,n->a", J, r, ww)
    d = torch.linalg.solve_ex(H, b)[0]
    dR, dt = P.exp_se3(d)
    return P.compose(dR, dt, R0, t0)


def _residual_norms(R, t, X, uv, intr):
    y = _camera_points(R, t, X)
    return torch.linalg.vector_norm(_pixels(y, intr) - uv, dim=1), y[:, 2]


def pnp_gn(
    X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, intr: torch.Tensor,
    pose0: torch.Tensor, iters: int = 10, huber_px: float = 3.0,
    inlier_px: float = 3.0,
) -> PnPResult:
    """X: [N, 3] world points; uv: [N, 2] pixels; w: [N] weights (0 masks);
    intr: [4]; pose0: [6] initial twist; all f32 on one device.  Returns
    the refined pose, with no host synchronisation."""
    R, t = P.exp_se3(pose0)
    for _ in range(iters):
        R, t = _step(R, t, X, uv, intr, w, huber_px)

    # reject-then-refine: gross outliers survive Huber with small but nonzero
    # weight; a second pass on hard inliers removes the residual bias
    rn, z = _residual_norms(R, t, X, uv, intr)
    w = w * ((rn < inlier_px) & (z > 1e-6))
    for _ in range(max(2, iters // 2)):
        R, t = _step(R, t, X, uv, intr, w, huber_px)

    rn, z = _residual_norms(R, t, X, uv, intr)
    inl = (rn < inlier_px) & (w > 0) & (z > 1e-6)
    n = torch.clamp(inl.sum(), min=1)
    rms = torch.sqrt(((rn ** 2) * inl).sum() / n)
    return PnPResult(pose=P.log_se3(R, t), inliers=inl,
                     num_inliers=inl.sum().to(torch.int32), rms=rms)


# the reference's jitted `pnp_gn` (`iters`, `huber_px` and `inlier_px`
# static): captured once per signature on CUDA inputs (`core/graphs.py`)
pnp_gn_jit = graphed(pnp_gn, "pnp_gn_jit")
