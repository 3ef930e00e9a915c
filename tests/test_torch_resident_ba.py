"""The port's rank-resident windowed BA (`parallel/resident_ba.py`) and the
SLAM loop's resident protocol, in 2 gloo ranks on the CPU, against the
reference's `ResidentBA` on a 2-device mesh.

- One `ResidentBA.solve` (and, as a second case, `ResidentBAJit.solve`)
  on a fixed synthetic window (tests/test_ba.py's `_make_problem(n_cams=4,
  n_pts=64, seed=7)` placed in slots of a 300-slot map on both ranks'
  blocks, 8 of them fixed), 3 LM x 30 CG steps, which reach the window's
  least cost: new poses within 1e-4 of the reference's; the same slots
  written into `map_X`, within 1e-3; after a few host edits a second call
  uploads exactly the count the reference's `_upload_dirty` returns.  Both ranks return the same bits.  (Steps past
  the least cost wander along its flat valley by the rounding of the
  accept test: at 10 or 20 steps the reference's own 1- and 2-device runs
  differ by ~3e-4.)
- Back-end parity, in the manner of tests/test_torch_slam.py: the port's
  `run_slam(features=..., ba_fn=ResidentBA(group),
  pg_fn=make_pg_optimizer(group))` in 2 ranks against the reference's
  `run_slam` with its `ResidentBA` and `make_pg_optimizer` on 2 devices,
  both on the reference's features and bootstrap RANSAC draws
  (tests/test_torch_slam.py's scene, T = 10).  Keyframes equal, PnP
  inliers within 2, rotations within 1e-4, positions within 1e-4 after
  the one similarity that best maps the port's centers onto the
  reference's (BA's free scale gauge; see that file).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import chip_smoke as cs
import torch_dist_worker as worker
from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend.extract import extract_features_jit
from siftgpu_tpu.oracle import fixtures as jfixtures
from siftgpu_tpu.parallel import resident_ba as jresident
from siftgpu_tpu.parallel import sequence as jsequence
from siftgpu_tpu.pipeline import slam as jslam
from siftgpu_tpu_torch import MatchConfig, SiftConfig
from siftgpu_tpu_torch.geometry import align
from siftgpu_tpu_torch.parallel import comm
from siftgpu_tpu_torch.pipeline import slam

from test_ba import _make_problem
from test_torch_slam import H, INTR, SCFG, W, RefFeatures, _sequence

EDITS = {7: (0.5, -0.25, 8.0), 20: (1.0, 1.0, 9.0), 260: (-1.0, 0.5, 7.0)}


def _mesh2(name):
    return Mesh(np.array(jax.devices()[:2]), axis_names=(name,))


def _window():
    prob, _, _ = _make_problem(n_cams=4, n_pts=64, seed=7)
    return cs.resident_window(*(np.asarray(a) for a in (prob.cams, prob.points, prob.cam_idx,
                                                        prob.pt_idx, prob.uv, prob.intrinsics)))


@pytest.mark.parametrize("jit", [False, True], ids=["ResidentBA", "ResidentBAJit"])
def test_resident_solve_matches_reference(jit):
    win = _window()
    out, other = comm.spawn(worker.resident_solve, 2, "gloo", "cpu", win, EDITS, jit, timeout=120,
                            threads=1)
    assert all(np.array_equal(a, b) for a, b in zip(out, other))
    cams, cost, first, count, _, _ = out

    rb = jresident.ResidentBA(_mesh2("ba"))
    rb.set_intrinsics(win["intr"])
    map_X = win["map_X"].copy()
    args = [win[k] for k in ("cams", "obs_c", "obs_p", "obs_uv", "fixed")]
    ref_cams, ref_cost = rb.solve(*args, map_X, win["iters"], win["n_cg"])
    np.testing.assert_allclose(cams, ref_cams, atol=1e-4)
    np.testing.assert_allclose(cost, ref_cost, rtol=1e-3, atol=1e-6)
    moved = np.nonzero((map_X != win["map_X"]).any(1))[0]
    assert np.array_equal(moved, np.nonzero((first != win["map_X"]).any(1))[0])
    assert len(moved) == 64 - 8     # the window's free points, on both ranks' blocks
    np.testing.assert_allclose(first[moved], map_X[moved], atol=1e-3)

    for slot, xyz in EDITS.items():
        map_X[slot] = xyz
    assert count == rb._upload_dirty(map_X) == len(EDITS)


@pytest.fixture(scope="module")
def backend_pair():
    frames, _ = _sequence(10, jfixtures)
    feats = extract_features_jit(jnp.asarray(frames), JConfig(height=H, width=W, max_keypoints=768))
    ref = jslam.run_slam(frames, INTR, JConfig(height=H, width=W, max_keypoints=768),
                         JMatch(max_match=768), jslam.SlamConfig(**SCFG),
                         features=RefFeatures(feats), ba_fn=jresident.ResidentBA(_mesh2("ba")),
                         pg_fn=jsequence.make_pg_optimizer(_mesh2("pg")))
    arrays = [np.asarray(a) for a in feats]
    port = comm.spawn(worker.run_slam_resident, 2, "gloo", "cpu", arrays, frames, INTR,
                      SiftConfig(height=H, width=W, max_keypoints=768), MatchConfig(max_match=768),
                      slam.SlamConfig(**SCFG), timeout=180, threads=1)
    return ref, port


def test_resident_backend_parity(backend_pair):
    ref, (port, other) = backend_pair
    assert all(np.array_equal(port[k], other[k]) for k in ("trajectory", "map_points"))
    assert port["keyframe_indices"] == list(ref.keyframe_indices)
    n_ref, n_port = np.asarray(ref.num_tracked), np.asarray(port["num_tracked"])
    bad = np.nonzero(np.abs(n_ref - n_port) > 2)[0]
    assert not len(bad), f"PnP inliers differ at frames {bad}: {n_ref[bad]} vs {n_port[bad]}"
    np.testing.assert_array_equal(port["map_mask"], ref.map_mask)
    assert port["map_n"] == ref.map_n
    d = np.abs(port["trajectory"][:, :3] - ref.trajectory[:, :3]).max(axis=1)
    worst = int(np.argmax(d))
    assert d[worst] < 1e-4, f"frame {worst}: rotation differs by {d[worst]}"
    cp, cr = align.camera_centers(port["trajectory"]), align.camera_centers(ref.trajectory)
    s, R, t = align.umeyama(cp, cr)
    assert abs(s - 1.0) < 1e-2, f"scale gauge {s}"
    res = np.linalg.norm((s * (R @ cp.T)).T + t - cr, axis=1)
    worst = int(np.argmax(res))
    assert res[worst] < 1e-4, f"frame {worst}: aligned center differs by {res[worst]}"
