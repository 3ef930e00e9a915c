"""The port's checkpoint / resume (`pipeline/checkpoint.py`) on the CPU, at
tests/test_checkpoint.py's scene (144x192, T = 10, checkpoint after 7).

- The port's resume replays its full run with tests/test_checkpoint.py's
  criteria: the same keyframes, map mask and inlier counts, the trajectory
  within 1e-4, the ATE bound, and the prefix rows restored verbatim.
- A checkpoint written by the reference's `save_slam_state` loads in the
  port, and the resumed run meets the ATE bound; one written by the port
  loads in the reference, which resumes within the same bound.
- Both packages write the same keys with the same dtypes.
- A legacy single-keyframe checkpoint (the round-2 fields only) resumes.
"""

import os

import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.pipeline import checkpoint as jcheckpoint
from siftgpu_tpu.pipeline import slam as jslam
from siftgpu_tpu_torch import MatchConfig, SiftConfig
from siftgpu_tpu_torch.geometry import align
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import checkpoint, slam
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W = 144, 192
INTR = (170.0, 170.0, W / 2.0, H / 2.0)
T, TC = 10, 7
SCFG = dict(kf_min_inliers=60, kf_flow_px=8.0, init_flow_px=10.0)


def _scene():
    return fixtures.two_plane_sequence(T, H, W, INTR, rvec_step=np.array([0.002, -0.004, 0.001]),
                                       t_step=np.array([-0.08, 0.012, 0.006]), d_near=5.0,
                                       d_far=10.0, seed=4)


def _port(frames, **kw):
    return slam.run_slam(frames, INTR, SiftConfig(height=H, width=W, max_keypoints=768),
                         MatchConfig(max_match=768), slam.SlamConfig(**SCFG), device="cpu", **kw)


def _ref(frames, **kw):
    return jslam.run_slam(frames, INTR, JConfig(height=H, width=W, max_keypoints=768),
                          JMatch(max_match=768), jslam.SlamConfig(**SCFG), **kw)


def _ate_ok(res, gt, frac=0.06):
    c, g = align.camera_centers(res.trajectory), align.camera_centers(gt)
    rmse = align.ate_rmse(c, g)[0]
    span = np.linalg.norm(g[-1] - g[0])
    assert rmse < frac * span, (rmse, span)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    frames, gt = _scene()
    full = _port(frames)
    part = _port(frames[:TC])
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    checkpoint.save_slam_state(path, part, next_frame=TC)
    return frames, gt, full, part, path


@pytest.fixture(scope="module")
def ref_checkpoint(tmp_path_factory):
    frames, _ = _scene()
    path = str(tmp_path_factory.mktemp("ckpt") / "ref.npz")
    jcheckpoint.save_slam_state(path, _ref(frames[:TC]), next_frame=TC)
    return path


def test_resume_replays_the_full_run(port_runs):
    frames, gt, full, part, path = port_runs
    ck = checkpoint.load_slam_state(path)
    assert ck.next_frame == TC
    resumed = _port(frames, resume=ck)
    assert resumed.keyframe_indices == full.keyframe_indices
    np.testing.assert_allclose(resumed.trajectory, full.trajectory, atol=1e-4)
    np.testing.assert_array_equal(resumed.map_mask, full.map_mask)
    assert resumed.num_tracked == full.num_tracked
    _ate_ok(resumed, gt)
    non_kf = [t for t in range(TC - 1) if t not in full.keyframe_indices]
    np.testing.assert_allclose(resumed.trajectory[non_kf], part.trajectory[non_kf], atol=1e-6)


def test_reference_checkpoint_resumes_in_the_port(port_runs, ref_checkpoint):
    frames, gt = port_runs[:2]
    resumed = _port(torch.from_numpy(frames), resume=checkpoint.load_slam_state(ref_checkpoint))
    _ate_ok(resumed, gt)
    assert all(n > 20 for n in resumed.num_tracked[TC:])


def test_port_checkpoint_resumes_in_the_reference(port_runs):
    frames, gt, _, _, path = port_runs
    resumed = _ref(frames, resume=jcheckpoint.load_slam_state(path))
    _ate_ok(resumed, gt)


def test_keys_and_dtypes_match(port_runs, ref_checkpoint):
    with np.load(port_runs[4]) as a, np.load(ref_checkpoint) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].ndim == b[k].ndim, k
    assert not os.path.exists(port_runs[4] + ".tmp")


def test_legacy_checkpoint_resumes(port_runs, tmp_path):
    frames, gt, _, _, path = port_runs
    legacy = ("trajectory", "keyframe_indices", "map_points", "map_mask", "num_tracked",
              "next_frame", "kf_pose", "kf_frame_idx", "kf_x", "kf_y", "kf_desc", "kf_mask",
              "kf_pt_ids")
    with np.load(path) as z:
        data = {k: z[k] for k in legacy}
    resumed = _port(frames, resume=checkpoint.SlamCheckpoint(data))
    assert len(resumed.num_tracked) == T
    assert all(n > 20 for n in resumed.num_tracked[TC:])
    _ate_ok(resumed, gt)
