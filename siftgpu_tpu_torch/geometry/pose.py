"""Pose recovery and triangulation on batched tensors.

Port of `siftgpu_tpu/geometry/pose.py`.  Rotations use the so(3)
exponential map (Rodrigues); world-to-camera convention x_cam = R x_world +
t.  E decomposition follows Hartley & Zisserman; cheirality (positive depth
in both views) selects among the four (R, t) candidates.  The reference's
`vmap`ped small solves are batched `ops.small_eig` calls here ([4, N, 4, 4]
in `recover_pose`: the sync-free kernel on the card, `torch.linalg` on the
CPU).  Matmuls run with TF32 off (`full_f32`),
the reference's "highest".  Eigen- and singular-vector signs are arbitrary
in both frameworks: `triangulate` divides by the fourth coordinate and
`decompose_essential` fixes U and V^T to det +1, so neither output depends
on them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.graphs import device_constant
from ..core.precision import full_f32
from ..ops import small_eig

__all__ = [
    "exp_so3", "log_so3", "hat",
    "exp_se3", "log_se3", "compose", "inverse", "relative",
    "compose_sim3", "inverse_sim3", "relative_sim3",
    "triangulate", "decompose_essential", "recover_pose", "TwoViewPose",
]


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zeros], -1),
        ],
        -2,
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation (safe at 0)."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    K = hat(w / torch.clamp(theta[..., 0], min=1e-12))
    s, c = torch.sin(theta), torch.cos(theta)
    I = _eye(w).expand(K.shape)
    with full_f32():
        R = I + s * K + (1.0 - c) * (K @ K)
    return torch.where(theta < 1e-8, I + hat(w), R)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] axis-angle (principal branch).

    Robust at the theta ~ pi singularity: there the skew part vanishes, so
    the axis is recovered from the symmetric part (outer product aa^T =
    (R_sym - cos I) / (1 - cos)), taking the column with the largest
    diagonal for numerically stable, sign-consistent components."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )
    # generic branch (theta away from 0 and pi): w_skew = 2 sin(theta) * axis
    s = torch.where(theta.abs() < 1e-8, torch.full_like(theta, 0.5),
                    theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12))
    w_generic = w * s[..., None]

    # near-pi branch: axis from the symmetric part
    I = _eye(R).expand(R.shape)
    sym = 0.5 * (R + R.transpose(-1, -2))
    denom = torch.clamp(1.0 - cos, min=1e-6)[..., None, None]
    aa = (sym - cos[..., None, None] * I) / denom          # ~ axis axis^T
    d = torch.clamp(torch.diagonal(aa, dim1=-2, dim2=-1), min=0.0)
    k = torch.argmax(d, dim=-1, keepdim=True)
    col = torch.gather(aa, -1, k[..., None].expand(*aa.shape[:-1], 1))[..., 0]
    ak = torch.sqrt(torch.clamp(torch.gather(d, -1, k)[..., 0], min=1e-12))
    axis = col / ak[..., None]
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    # fix the overall sign from the (tiny but sign-carrying) skew part; at
    # exactly pi both signs are equivalent
    dot = (axis * w).sum(-1, keepdim=True)
    axis = torch.where(dot < 0, -axis, axis)
    w_pi = axis * theta[..., None]
    return torch.where((theta > 3.0)[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V such that exp_se3([w, v]) has translation V @ v. [..., 3, 3]."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    K = hat(w / torch.clamp(theta[..., 0], min=1e-12))
    I = _eye(w).expand(K.shape)
    s, c = torch.sin(theta), torch.cos(theta)
    th = torch.clamp(theta, min=1e-12)
    with full_f32():
        V = I + (1.0 - c) / th * K + (theta - s) / th * (K @ K)
    return torch.where(theta < 1e-6, I + 0.5 * hat(w), V)


def exp_se3(xi: torch.Tensor):
    """[..., 6] (rot, trans) twist -> (R [..., 3, 3], t [..., 3])."""
    w, v = xi[..., :3], xi[..., 3:]
    with full_f32():
        return exp_so3(w), (_so3_left_jacobian(w) @ v[..., None])[..., 0]


def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] twist (inverse of exp_se3)."""
    w = log_so3(R)
    with full_f32():
        # inv_ex: the left Jacobian is invertible below 2 pi, and unlike
        # `inv` it does not check the factorisation on the host (no sync)
        v = (torch.linalg.inv_ex(_so3_left_jacobian(w))[0] @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    with full_f32():
        return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    with full_f32():
        return Rt, -(Rt @ t[..., None])[..., 0]


def relative(Ri, ti, Rj, tj):
    """T_ij = T_j o T_i^-1 (maps cam_i coordinates to cam_j)."""
    return compose(Rj, tj, *inverse(Ri, ti))


# ---------------- Sim(3): (s, R, t) acts as x -> s R x + t ----------------

def compose_sim3(sa, Ra, ta, sb, Rb, tb):
    """(sa, Ra, ta) o (sb, Rb, tb): x -> sa Ra (sb Rb x + tb) + ta."""
    with full_f32():
        return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta


def inverse_sim3(s, R, t):
    Rt = R.transpose(-1, -2)
    si = 1.0 / s
    with full_f32():
        return si, Rt, -si[..., None] * (Rt @ t[..., None])[..., 0]


def relative_sim3(si, Ri, ti, sj, Rj, tj):
    """S_ij = S_j o S_i^-1 (maps cam_i coordinates to cam_j)."""
    return compose_sim3(sj, Rj, tj, *inverse_sim3(si, Ri, ti))


def triangulate(R0, t0, R1, t1, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """DLT triangulation.  (R*, t*): world->cam [..., 3, 3] / [..., 3], with
    any leading batch of candidates; x*: [N, 2] normalized coords.  Returns
    X [..., N, 3] world points (eigenvector of the smallest eigenvalue of
    A^T A per point)."""
    P0 = torch.cat([R0, t0[..., :, None]], dim=-1)[..., None, :, :]   # [..., 1, 3, 4]
    P1 = torch.cat([R1, t1[..., :, None]], dim=-1)[..., None, :, :]
    A = torch.stack(
        [
            x0[:, 0, None] * P0[..., 2, :] - P0[..., 0, :],
            x0[:, 1, None] * P0[..., 2, :] - P0[..., 1, :],
            x1[:, 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[:, 1, None] * P1[..., 2, :] - P1[..., 1, :],
        ],
        dim=-2,
    )                                                                 # [..., N, 4, 4]
    with full_f32():
        _, vecs = small_eig.eigh_sym(A.transpose(-1, -2) @ A)
    X = vecs[..., 0]
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


_W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


def decompose_essential(E: torch.Tensor):
    """E -> 4 candidate (R, t) with |t| = 1.  Returns (Rs [4,3,3], ts [4,3])."""
    U, _, Vt = small_eig.svd3(E)
    # proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = device_constant("essential_W", E.device, lambda: _W).to(E.dtype)
    with full_f32():
        Ra = U @ W @ Vt
        Rb = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([t, -t, t, -t])


class TwoViewPose(NamedTuple):
    R: torch.Tensor          # [3, 3] world(cam0)->cam1
    t: torch.Tensor          # [3] unit-norm translation
    points: torch.Tensor     # [N, 3] triangulated points (cam0 frame)
    good: torch.Tensor       # [N] bool: positive depth in both views
    num_good: torch.Tensor   # [] int32


def recover_pose(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                 w: torch.Tensor) -> TwoViewPose:
    """Cheirality check over the 4 (R, t) candidates (the cv2.recoverPose
    analog), all four triangulated in one batch.  w: [N] inlier mask;
    returns the pose of cam1 w.r.t. cam0."""
    Rs, ts = decompose_essential(E)
    I = _eye(E).expand(4, 3, 3)
    z = torch.zeros_like(ts)
    X = triangulate(I, z, Rs, ts, x0, x1)                       # [4, N, 3]
    with full_f32():
        z1 = (X @ Rs.transpose(-1, -2) + ts[:, None, :])[..., 2]
    goods = (X[..., 2] > 1e-6) & (z1 > 1e-6) & w.to(torch.bool)
    counts = goods.sum(-1)
    best = torch.argmax(counts).reshape(1)    # a 0-d index would be read on the host
    return TwoViewPose(R=Rs[best][0], t=ts[best][0], points=X[best][0], good=goods[best][0],
                       num_good=counts[best][0].to(torch.int32))
