"""The port's map repair after loop closure and its lost-tracking path,
against the reference.

- `_drifted_state` of tests/test_map_repair.py, built once in NumPy and
  copied into both packages' keyframes: `apply_pose_graph_sim3` (dense
  Sim(3) graph, anchor transport, trajectory re-anchoring) gives the same
  keyframe poses, trajectory and map within 1e-4 (f32 GN in two
  frameworks), and landmark fusion the same slot remap and frees, exactly.
- `refit_map_points` against the reference: points within 1e-4.
- One port-only run of tests/test_relocalization.py's blackout scene with
  that test's assertions.
"""

import numpy as np
import pytest

from siftgpu_tpu.pipeline import slam as jslam
from siftgpu_tpu_torch import MatchConfig, SiftConfig
from siftgpu_tpu_torch.geometry import align
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import metrics, slam

from test_map_repair import _drifted_state, _loop_edge_rel7
from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def state():
    kfs, traj, map_X, map_mask, anchor, C, intr, X_true = _drifted_state()
    gt6 = np.zeros((len(kfs), 6), np.float32)
    gt6[:, 3:] = -C
    return kfs, traj, map_X, map_mask, anchor, gt6, intr


def _copies(kfs, cls):
    return [cls(frame_idx=k.frame_idx, pose=k.pose.copy(), feats=None,
                kp={key: (None if v is None else np.array(v)) for key, v in k.kp.items()},
                pt_ids=k.pt_ids.copy()) for k in kfs]


def _apply(pkg, state, edges, **kw):
    kfs, traj, map_X, map_mask, anchor, _, _ = state
    k2, tr, mx, mm = _copies(kfs, pkg.Keyframe), traj.copy(), map_X.copy(), map_mask.copy()
    changed = pkg.apply_pose_graph_sim3(k2, tr, mx, mm, anchor.copy(), edges, **kw)
    return changed, k2, tr, mx, mm


@pytest.mark.parametrize("case", ["scale_edge", "se3_edge", "fusion", "online_n_fix"])
def test_apply_pose_graph_sim3_matches_reference(state, case):
    gt6 = state[5]
    M = len(gt6)
    s_rel = 1.0 if case == "se3_edge" else float(np.exp(np.log(1.35)))
    fuse = np.zeros((0, 2), np.int64)
    if case == "fusion":
        fuse = np.stack([[0, 1, 2], [(M - 1) * 40 + i for i in range(3)]], 1).astype(np.int64)
    edges = [(0, M - 1, _loop_edge_rel7(gt6, 0, M - 1, s_rel), 60.0, fuse)]
    kw = {}
    if case == "online_n_fix":
        # the online policy: stored odometry, the first keyframes frozen
        est = np.stack([k.pose for k in state[0]])
        odo = [(i, i + 1, _loop_edge_rel7(est, i, i + 1, 1.0)) for i in range(M - 1)]
        kw = dict(odo_edges=odo, n_fix=M - 6, upto_frame=M - 2)
    ref = _apply(jslam, state, edges, **kw)
    got = _apply(slam, state, edges, device="cpu", **kw)
    assert got[0] and ref[0]
    np.testing.assert_allclose(np.stack([k.pose for k in got[1]]),
                               np.stack([k.pose for k in ref[1]]), atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-4)
    np.testing.assert_array_equal(got[4], ref[4])
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a.pt_ids, b.pt_ids)
    if case == "fusion":
        assert not got[4][fuse[:, 1]].any() and got[4][fuse[:, 0]].all()


def test_apply_pose_graph_sim3_no_loop_is_noop(state):
    changed, k2, tr, mx, _ = _apply(slam, state, [], device="cpu")
    assert not changed
    np.testing.assert_array_equal(tr, state[1])


def test_refit_map_points_matches_reference():
    kfs, _, map_X, map_mask, _, _, intr, _ = _drifted_state(s_end=1.0, t_end=0.0)
    rng = np.random.default_rng(3)
    noisy = map_X + rng.normal(0, 0.05, map_X.shape).astype(np.float32)
    a, b = noisy.copy(), noisy.copy()
    jslam.refit_map_points(_copies(kfs, jslam.Keyframe), a, map_mask, intr, iters=4)
    slam.refit_map_points(_copies(kfs, slam.Keyframe), b, map_mask, intr, iters=4, device="cpu")
    np.testing.assert_allclose(b, a, atol=1e-4)
    assert np.abs(b - noisy).max() > 1e-3


H, W = 144, 192
INTR = (170.0, 170.0, W / 2.0, H / 2.0)
BO = (11, 16)
T = 24


def _blackout_scene():
    """tests/test_relocalization.py:27-44."""
    stepA, stepB = np.array([-0.08, 0.012, 0.006]), np.array([0.05, -0.06, -0.004])
    rvA, rvB = np.array([0.002, -0.004, 0.001]), np.array([-0.003, 0.005, -0.001])
    tvecs, rvecs = np.zeros((T, 3)), np.zeros((T, 3))
    for k in range(1, T):
        tvecs[k] = tvecs[k - 1] + (stepA if k <= BO[0] else stepB)
        rvecs[k] = rvecs[k - 1] + (rvA if k <= BO[0] else rvB)
    return fixtures.two_plane_sequence_poses(rvecs, tvecs, H, W, INTR, d_near=5.0,
                                             d_far=10.0, seed=4)


def _ate_outside_blackout(res, gt):
    sel = np.r_[0:BO[0], BO[1]:T]
    return align.ate_rmse(align.camera_centers(res.trajectory)[sel],
                          align.camera_centers(gt)[sel], with_scale=True)[0]


def test_blackout_recovery_and_no_blackout_keyframes(tmp_path):
    """tests/test_relocalization.py:63-85 on the port."""
    frames, gt = _blackout_scene()
    dark = frames.copy()
    dark[BO[0]:BO[1]] = 0.0
    cfg = SiftConfig(height=H, width=W, max_keypoints=768)
    mcfg = MatchConfig(max_match=768)
    scfg = slam.SlamConfig(kf_min_inliers=60, kf_flow_px=8.0, init_flow_px=10.0)
    clean = slam.run_slam(frames, INTR, cfg, mcfg, scfg, device="cpu")
    mpath = str(tmp_path / "m.jsonl")
    with metrics.MetricsLogger(mpath) as m:
        res = slam.run_slam(dark, INTR, cfg, mcfg, scfg, device="cpu", metrics=m)
    assert not any(BO[0] <= i < BO[1] for i in res.keyframe_indices), res.keyframe_indices
    post = res.num_tracked[BO[1]:]
    assert max(post) > 20, post
    ate_clean, ate_dark = _ate_outside_blackout(clean, gt), _ate_outside_blackout(res, gt)
    c = align.camera_centers(gt)
    span = np.linalg.norm(c[-1] - c[0])
    assert ate_dark < max(1.5 * ate_clean, 0.02 * span), (ate_dark, ate_clean, span)
    assert '"track_lost"' in open(mpath).read()
    assert res.num_tracked[BO[0]:BO[1]] == [0] * (BO[1] - BO[0])
