"""The port's data-parallel extraction (`parallel/dp.py`) and sequence feature
store (`parallel/sequence.py::extract_sequence_dp`), in 2 gloo ranks on the
CPU.

- `extract_features_dp` and `extract_features_dp_jit` (4 frames, 64x80, K
  = 128, 2 octaves; 2 frames a rank) gathered equal one process's
  `extract_features` of the 4 frames bit for bit (tests/test_torch_extract.py holds that against the
  reference), with the reference's keypoint count per frame.
- `extract_sequence_dp` (T = 6 at 144x192, K = 768, chunk 4: a full chunk,
  then a tail of 2 padded to the world size) equals one batched
  extraction bit for bit.
- The host-resident store (`desc_hbm_budget=0`) equals the device store,
  and `run_slam` on either gives the same trajectory within 1e-6 and the
  same keyframes (tests/test_sequence.py:54-86).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend.extract import extract_features_jit
from siftgpu_tpu_torch import MatchConfig, SiftConfig, extract_features
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.parallel import comm, sequence
from siftgpu_tpu_torch.pipeline import slam
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W = 144, 192
INTR = (170.0, 170.0, W / 2.0, H / 2.0)


def _scene(T):
    """tests/test_sequence.py's `_scene`, with the port's fixtures."""
    frames, _ = fixtures.two_plane_sequence(
        T, H, W, INTR, rvec_step=np.array([0.002, -0.004, 0.001]),
        t_step=np.array([-0.08, 0.012, 0.006]), d_near=5.0, d_far=10.0, seed=4)
    return frames, SiftConfig(height=H, width=W, max_keypoints=768)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_extract_features_dp_equals_one_process(jit):
    imgs = np.stack([fixtures.random_texture(64, 80, seed=s) for s in range(4)])
    cfg = SiftConfig(height=64, width=80, max_keypoints=128, num_octaves=2)
    out, other = comm.spawn(worker.extract_features_dp, 2, "gloo", "cpu", imgs, cfg, jit,
                            timeout=120, threads=1)
    one = extract_features(torch.from_numpy(imgs), cfg)
    for name, a, b, c in zip(one._fields, one, out, other):
        assert np.array_equal(a.numpy(), b) and np.array_equal(b, c), name
    ref = extract_features_jit(jnp.asarray(imgs),
                               JConfig(height=64, width=80, max_keypoints=128, num_octaves=2))
    np.testing.assert_array_equal(out[7].sum(1), np.asarray(ref.mask).sum(1))


@pytest.fixture(scope="module")
def stores():
    """(device store, host store) of rank 0, one spawn for both."""
    frames, cfg = _scene(6)
    return frames, cfg, comm.spawn(worker.extract_sequence_dps, 2, "gloo", "cpu", frames, cfg, 4,
                                   timeout=120, threads=1)


def test_extract_sequence_dp_equals_batched(stores):
    frames, cfg, ranks = stores
    one = extract_features(torch.from_numpy(frames), cfg)
    for dev_store, host_store in ranks:
        host_mode, desc, x, y, mask = dev_store
        assert not host_mode
        assert np.array_equal(desc, one.desc.numpy()) and np.array_equal(mask, one.mask.numpy())
        assert np.array_equal(x, one.x.numpy()) and np.array_equal(y, one.y.numpy())


def test_host_resident_store_equals_device_store(stores):
    frames, cfg, ranks = stores
    (dev_store, host_store), _ = ranks
    assert host_store[0] and not dev_store[0]
    for a, b in zip(dev_store[1:], host_store[1:]):
        np.testing.assert_array_equal(a, b)
    dev = sequence.extract_sequence_dp(frames, cfg, None, "cpu", chunk=4)
    host = sequence.extract_sequence_dp(frames, cfg, None, "cpu", chunk=4, desc_hbm_budget=0)
    assert isinstance(host.desc, np.ndarray) and torch.is_tensor(dev.desc)
    scfg = slam.SlamConfig(kf_min_inliers=60, kf_flow_px=8.0, init_flow_px=10.0)
    run = lambda feats: slam.run_slam(frames, INTR, cfg, MatchConfig(max_match=768), scfg,
                                      features=feats, device="cpu")
    r_dev, r_host = run(dev), run(host)
    np.testing.assert_allclose(r_host.trajectory, r_dev.trajectory, atol=1e-6)
    assert r_host.keyframe_indices == r_dev.keyframe_indices
