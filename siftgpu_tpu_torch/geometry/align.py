"""Trajectory alignment + ATE (the BASELINE 'ATE on benchmark seqs' metric).

Port of `siftgpu_tpu/geometry/align.py`.  `umeyama` and `ate_rmse` are
NumPy in the reference and are copied verbatim; `camera_centers` takes the
rotations and translations from the port's `exp_se3` in float32, as the
reference does from JAX's with 64-bit floats off.
"""

from __future__ import annotations

import numpy as np
import torch

from .pose import exp_se3

__all__ = ["umeyama", "ate_rmse", "camera_centers"]


def camera_centers(poses) -> np.ndarray:
    """[T, 6] world->cam twists (NumPy or a tensor) -> [T, 3] camera
    centers (-R^T t), NumPy f32."""
    xi = torch.as_tensor(np.asarray(poses.cpu() if torch.is_tensor(poses) else poses),
                         dtype=torch.float32)
    R, t = exp_se3(xi)
    return (-(R.transpose(-1, -2) @ t[..., None])[..., 0]).numpy()


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform: dst ~= s * R @ src + t.
    Returns (s, R [3,3], t [3])."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True):
    """Absolute trajectory error after similarity alignment. Returns (rmse,
    per-frame errors)."""
    s, R, t = umeyama(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ np.asarray(est_centers, np.float64).T)).T + t
    err = np.linalg.norm(aligned - gt_centers, axis=1)
    return float(np.sqrt((err**2).mean())), err
