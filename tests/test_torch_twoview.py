"""The port's two-view SfM path (BASELINE config 4) against the reference.

`two_plane_stereo` makes the same images in both packages (within 1e-6:
both take R from an f32 Rodrigues).  `two_view_from_features` on the
reference's features, matches and RANSAC draws: inliers within 1%, R within
1e-4 rad, post-BA RMS within 1e-3 px.  `two_view_reconstruct` end to end on
the CPU meets tests/test_twoview.py's ground-truth bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend.extract import extract_features_jit
from siftgpu_tpu.frontend.match import match_descriptors as jmatch
from siftgpu_tpu.oracle import fixtures as jfixtures
from siftgpu_tpu.pipeline import twoview as jtwoview
from siftgpu_tpu_torch import Features, MatchConfig, MatchResult, SiftConfig
from siftgpu_tpu_torch.convert import tree_to_torch
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import twoview

H, W = 160, 200
INTR = (180.0, 180.0, W / 2.0, H / 2.0)
RVEC = np.array([0.01, -0.03, 0.005])
T_GT = np.array([-0.4, 0.05, 0.02])


def _rot_angle(Ra, Rb):
    """Angle of Ra Rb^T in radians, from atan2 of its skew and symmetric parts
    (arccos of the trace cannot resolve angles below ~5e-4 rad in f32)."""
    dR = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2
    return float(np.arctan2(s, (np.trace(dR) - 1) / 2))


@pytest.mark.parametrize("h,w", [(H, W), (480, 640)])
def test_two_plane_stereo_matches_reference(h, w):
    intr = (180.0 * w / W, 180.0 * w / W, w / 2.0, h / 2.0)
    a0, a1, am = fixtures.two_plane_stereo(h, w, intr, RVEC, T_GT, 5.0, 10.0, seed=2)
    b0, b1, bm = jfixtures.two_plane_stereo(h, w, intr, RVEC, T_GT, 5.0, 10.0, seed=2)
    np.testing.assert_array_equal(a0, b0)
    assert np.abs(a1 - b1).max() <= 1e-6
    assert am["R"].dtype == np.float32
    np.testing.assert_array_equal(am["R"], bm["R"])
    np.testing.assert_array_equal(am["t"], bm["t"])


def _check_ground_truth(res, R_gt):
    """tests/test_twoview.py's bounds."""
    assert int(res.num_matches) > 100
    assert int(res.num_inliers) > 0.5 * int(res.num_matches)
    assert _rot_angle(res.R.cpu().numpy(), R_gt) < 0.01
    tn = res.t.cpu().numpy() / np.linalg.norm(res.t.cpu().numpy())
    tg = T_GT / np.linalg.norm(T_GT)
    assert min(np.abs(tn - tg).max(), np.abs(tn + tg).max()) < 0.02
    assert float(res.rms) < 0.75
    m = res.point_mask.cpu().numpy()
    z = res.points.cpu().numpy()[m][:, 2] / (np.linalg.norm(res.t.cpu().numpy()) / np.linalg.norm(T_GT))
    assert ((z > 4.0) & (z < 6.0)).mean() + ((z > 8.0) & (z < 12.0)).mean() > 0.8


def test_two_view_from_reference_features_matches_reference():
    img0, img1, meta = jfixtures.two_plane_stereo(H, W, INTR, RVEC, T_GT, seed=2)
    jcfg = JConfig(height=H, width=W, max_keypoints=1024)
    feats = extract_features_jit(jnp.stack([jnp.asarray(img0), jnp.asarray(img1)]), jcfg)
    res = jmatch(feats.desc[0], feats.desc[1], feats.mask[0], feats.mask[1], JMatch(max_match=1024))
    key = jax.random.PRNGKey(7)
    intr = jnp.asarray(INTR, jnp.float32)
    ref = jtwoview.two_view_from_features(feats, res, intr, key)
    # the reference's draws: ransac_essential's jax.random.choice on the same key
    valid = jnp.asarray(res.pairs[:, 0] >= 0, jnp.float32)
    draws = np.array(jax.random.choice(key, valid.shape[0], shape=(512, 8), p=valid / valid.sum()))

    got = twoview.two_view_from_features(
        tree_to_torch(feats, Features), tree_to_torch(res, MatchResult),
        torch.tensor(INTR, dtype=torch.float32), samples=torch.from_numpy(draws))
    assert int(got.num_matches) == int(ref.num_matches)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 0.01 * int(ref.num_inliers)
    assert (got.point_mask.numpy() != np.asarray(ref.point_mask)).mean() <= 0.01
    assert _rot_angle(got.R.numpy(), np.asarray(ref.R)) < 1e-4
    assert abs(float(got.rms) - float(ref.rms)) < 1e-3
    _check_ground_truth(got, meta["R"])


def test_two_view_reconstruct_meets_ground_truth():
    img0, img1, meta = fixtures.two_plane_stereo(H, W, INTR, RVEC, T_GT, seed=2)
    res = twoview.two_view_reconstruct(
        torch.from_numpy(np.stack([img0, img1])), torch.tensor(INTR, dtype=torch.float32),
        SiftConfig(height=H, width=W, max_keypoints=1024), MatchConfig(max_match=1024),
        torch.Generator().manual_seed(7))
    _check_ground_truth(res, meta["R"])
    assert res.pairs.shape == (1024, 2) and res.points.shape == (1024, 3)
