"""The port's PnP (`optim/pnp.py`) against the reference on tests/test_pnp.py's
three scenes.

Both `pnp_gn`s get the same NumPy inputs.  The port takes its Jacobian in
closed form where the reference uses `jax.jacfwd`; they differ in rounding
only: poses within 1e-5, inlier masks and counts equal, RMS within 1e-4 px.
The port also meets test_pnp.py's ground-truth asserts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.geometry import pose as JP
from siftgpu_tpu.optim import pnp as jpnp
from siftgpu_tpu_torch.optim import pnp


def _scene(n=80, seed=0):
    """tests/test_pnp.py's scene."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 5], [2, 2, 12], (n, 3)).astype(np.float32)
    intr = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
    gt = np.array([0.04, -0.06, 0.02, 0.3, -0.1, 0.15], np.float32)
    R, t = JP.exp_se3(jnp.asarray(gt))
    Xc = X @ np.asarray(R).T + np.asarray(t)
    uv = intr[:2] * Xc[:, :2] / Xc[:, 2:] + intr[2:]
    return X, uv.astype(np.float32), intr, gt


def _recovers():
    X, uv, intr, gt = _scene()
    return X, uv, np.ones(len(X), np.float32), intr, dict(iters=12)


def _outliers():
    X, uv, intr, gt = _scene(seed=2)
    uv = uv.copy()
    uv[:15] += 80.0
    return X, uv, np.ones(len(X), np.float32), intr, dict(iters=15, huber_px=2.0)


def _weights():
    X, uv, intr, gt = _scene(seed=3)
    uv = uv.copy()
    uv[:10] += 500.0
    w = np.ones(len(X), np.float32)
    w[:10] = 0.0
    return X, uv, w, intr, dict(iters=12)


SCENES = {"recovers_pose": (_recovers, 0, 1e-4), "robust_to_outliers": (_outliers, 2, 2e-3),
          "respects_weights": (_weights, 3, 1e-4)}


@pytest.mark.parametrize("name", list(SCENES))
def test_pnp_matches_reference(name):
    make, seed, gt_tol = SCENES[name]
    X, uv, w, intr, kw = make()
    gt = _scene(seed=seed)[3]
    ref = jpnp.pnp_gn(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w), jnp.asarray(intr),
                      jnp.zeros(6), **kw)
    res = pnp.pnp_gn(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(w),
                     torch.from_numpy(intr), torch.zeros(6), **kw)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(ref.inliers))
    assert int(res.num_inliers) == int(ref.num_inliers)
    assert abs(float(res.rms) - float(ref.rms)) < 1e-4
    # tests/test_pnp.py's ground truth
    np.testing.assert_allclose(res.pose.numpy(), gt, atol=gt_tol)
    inl = res.inliers.numpy()
    if name == "recovers_pose":
        assert int(res.num_inliers) == len(X) and float(res.rms) < 1e-3
    if name == "robust_to_outliers":
        assert not inl[:15].any() and inl[15:].all()
    assert res.num_inliers.dtype == torch.int32
