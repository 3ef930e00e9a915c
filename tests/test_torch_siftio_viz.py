"""The port's TUM trajectory writer, feature store and overlays against the
reference's:

  - `save_trajectory_tum` of the same [T, 6] twists from both packages,
    parsed: equal within 2e-6 (the file's 6 decimals), with rotations that
    take every branch of Shepperd's method, one of them near pi; the
    quaternion of each branch equal to the reference's;
  - `save_feature_store`: a round trip, readable by the reference with the
    same keys, dtypes and values;
  - `draw_keypoints` / `draw_matches`: the reference's canvases bit for bit.
"""

import numpy as np
import pytest
import torch

from siftgpu_tpu.pipeline import siftio as jsiftio
from siftgpu_tpu.pipeline import viz as jviz
from siftgpu_tpu_torch import Features
from siftgpu_tpu_torch.geometry import pose
from siftgpu_tpu_torch.pipeline import siftio, viz

# rotation vectors whose camera-to-world rotation takes each Shepperd branch:
# trace > 0, and near pi about x, y and z (the largest diagonal entry)
BRANCHES = {"trace": [0.1, -0.2, 0.05], "x": [np.pi - 0.01, 0.02, -0.03],
            "y": [0.03, np.pi - 0.002, 0.01], "z": [-0.01, 0.02, np.pi - 0.05]}


def _twists():
    rng = np.random.default_rng(0)
    rot = np.concatenate([np.array(list(BRANCHES.values())), rng.normal(0, 0.3, (6, 3))])
    return np.concatenate([rot, rng.normal(0, 2.0, (len(rot), 3))], 1).astype(np.float32)


def _read(path):
    return np.array([[float(v) for v in ln.split()] for ln in open(path)])


def test_trajectory_tum_matches_reference(tmp_path):
    xi = _twists()
    siftio.save_trajectory_tum(str(tmp_path / "p.txt"), torch.from_numpy(xi))
    jsiftio.save_trajectory_tum(str(tmp_path / "j.txt"), xi)
    p, j = _read(tmp_path / "p.txt"), _read(tmp_path / "j.txt")
    assert p.shape == (len(xi), 8)
    np.testing.assert_array_equal(p[:, 0], np.arange(len(xi)))
    # a quaternion and its negative are one rotation: compare up to sign
    sign = np.sign((p[:, 4:] * j[:, 4:]).sum(1, keepdims=True))
    np.testing.assert_allclose(p[:, 1:4], j[:, 1:4], rtol=0, atol=2e-6)
    np.testing.assert_allclose(p[:, 4:] * sign, j[:, 4:], rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(p[:, 4:], axis=1), 1.0, atol=1e-5)
    siftio.save_trajectory_tum(str(tmp_path / "ts.txt"), xi, timestamps=np.arange(len(xi)) * 0.5)
    np.testing.assert_array_equal(_read(tmp_path / "ts.txt")[:, 0], np.arange(len(xi)) * 0.5)


@pytest.mark.parametrize("branch", BRANCHES)
def test_quaternion_branch_matches_reference(branch):
    R = pose.exp_so3(torch.tensor(BRANCHES[branch], dtype=torch.float32)).numpy().T
    tr, diag = np.trace(R), np.diag(R)
    assert (tr > 0) == (branch == "trace")
    if branch != "trace":
        assert "xyz"[int(np.argmax(diag))] == branch
    np.testing.assert_array_equal(siftio._quat_from_rotation(R), jsiftio._quat_from_rotation(R))


def _features(B=2, K=16, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))
    return Features(x=f(B, K), y=f(B, K), sigma=f(B, K), theta=f(B, K), response=f(B, K),
                    octave=torch.from_numpy(rng.integers(0, 4, (B, K)).astype(np.int32)),
                    desc=torch.from_numpy(rng.integers(0, 256, (B, K, 128)).astype(np.uint8)),
                    mask=torch.from_numpy(rng.random((B, K)) > 0.3))


def test_feature_store_round_trip(tmp_path):
    feats = _features()
    path = str(tmp_path / "s.npz")
    siftio.save_feature_store(path, feats, frame_ids=[3, 4])
    got, ref = siftio.load_feature_store(path), jsiftio.load_feature_store(path)
    assert set(got) == set(Features._fields) | {"frame_ids"}
    for name in Features._fields:
        want = getattr(feats, name).numpy()
        assert got[name].dtype == want.dtype and got[name].shape == want.shape
        np.testing.assert_array_equal(got[name], want)
        np.testing.assert_array_equal(ref[name], want)
    np.testing.assert_array_equal(got["frame_ids"], [3, 4])
    # the reference's store of the same arrays: the same keys, dtypes and shapes
    jsiftio.save_feature_store(str(tmp_path / "j.npz"), Features(*(t.numpy() for t in feats)),
                               frame_ids=[3, 4])
    ref = siftio.load_feature_store(str(tmp_path / "j.npz"))
    assert {k: (v.dtype, v.shape) for k, v in ref.items()} == \
        {k: (v.dtype, v.shape) for k, v in got.items()}


def test_draw_keypoints_matches_reference():
    rng = np.random.default_rng(2)
    img = rng.random((48, 64)).astype(np.float32)
    n = 12
    x, y = rng.uniform(-5, 70, n), rng.uniform(-5, 52, n)     # some off the canvas
    sigma, theta = rng.uniform(-3, 4, n), rng.uniform(0, 2 * np.pi, n)
    for args in ((x, y, sigma, theta), (x, y, sigma)):
        np.testing.assert_array_equal(viz.draw_keypoints(img, *args),
                                      jviz.draw_keypoints(img, *args))
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(viz.draw_keypoints(u8, x, y, sigma, theta, scale_factor=1.5),
                                  jviz.draw_keypoints(u8, x, y, sigma, theta, scale_factor=1.5))


def test_draw_matches_matches_reference():
    rng = np.random.default_rng(3)
    a, b = rng.random((40, 50)).astype(np.float32), rng.random((48, 30)).astype(np.float32)
    kp0 = np.concatenate([rng.uniform(0, 50, (9, 2)), rng.random((9, 2))], 1).astype(np.float32)
    kp1 = np.concatenate([rng.uniform(0, 30, (7, 2)), rng.random((7, 2))], 1).astype(np.float32)
    pairs = np.stack([rng.integers(0, 9, 11), rng.integers(0, 7, 11)], 1)
    for max_lines in (0, 5):
        np.testing.assert_array_equal(viz.draw_matches(a, b, kp0, kp1, pairs, max_lines),
                                      jviz.draw_matches(a, b, kp0, kp1, pairs, max_lines))
    xy0, xy1 = (kp0[:, 0], kp0[:, 1]), (kp1[:, 0], kp1[:, 1])
    np.testing.assert_array_equal(viz.draw_matches(a, b, xy0, xy1, pairs),
                                  jviz.draw_matches(a, b, kp0, kp1, pairs))
