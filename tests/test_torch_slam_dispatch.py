"""Which entry points the port's SLAM loop (`pipeline/slam.py`) calls: where
the reference's `run_slam` calls a compiled program of a fixed signature,
the port's calls the captured counterpart (`core/graphs.py`), on the CPU at
tests/test_torch_slam.py's 144x192 scene, T = 10 (keyframes [0, 5, 9]).
No JAX: the reference is not run here.

Each captured entry point is wrapped by a counting pass-through, and each
eager step function by a counter of the calls the loop makes to it by name.
Then:

- every frame after the bootstrap goes through `_track_step_jit`, one
  signature for the whole run, and the loop never calls `_track_step`
  itself; the eager extraction and match run only inside the track step;
- the bootstrap's frames go through `extract_features_jit` and its matches
  (the bootstrap's and the buffered frames' relocation) through
  `match_descriptors_jit`, one signature each;
- keyframe 0 retires when keyframe 9 is inserted: the loop search then
  goes through `_loop_match_jit` with a pow2 archive capacity, never
  through `_loop_match`;
- on pre-extracted features (`features=`) each frame after the bootstrap
  goes through `_match_kf_jit`, and nothing is extracted;
- `refit_map_points`, called on the run's keyframes as the end-of-run pass
  calls it, goes through `ba.refine_points_jit` on the padded problem;
- every run, and the refit, equals bit for bit the run with the eager
  functions patched back in (`unittest.mock.patch.object`, as
  chip_smoke.py phase 4d does on the card).

On CPU tensors a captured entry point calls its eager function, so these
tests pin the dispatch, not the captures: chip_smoke.py phase 4d holds the
replayed run to the eager-patched run on the card.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from siftgpu_tpu_torch import Features, MatchConfig, SiftConfig
from siftgpu_tpu_torch.frontend import extract as extract_mod
from siftgpu_tpu_torch.frontend import match as match_mod
from siftgpu_tpu_torch.optim import ba
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import slam
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W, T = 144, 192, 10
INTR = (170.0, 170.0, W / 2.0, H / 2.0)
CFG = SiftConfig(height=H, width=W, max_keypoints=768)
MCFG = MatchConfig(max_match=768)
SCFG = slam.SlamConfig(kf_min_inliers=60, kf_flow_px=8.0, init_flow_px=10.0)

# module, captured entry point, the eager function it captures
CAPTURED = (
    (slam, "_track_step_jit", slam._track_step),
    (slam, "_match_kf_jit", slam._match_kf),
    (slam, "_loop_match_jit", slam._loop_match),
    (slam, "extract_features_jit", extract_mod.extract_features),
    (slam, "match_descriptors_jit", match_mod.match_descriptors),
    (ba, "refine_points_jit", ba.refine_points),
)
# the eager functions by the names the loop would call them by
EAGER = ("_track_step", "_match_kf", "_loop_match", "extract_features")


class Counted:
    """A pass-through that records each call's arguments and signature key."""

    def __init__(self, fn):
        self.fn, self.calls, self.keys = fn, [], []

    def __call__(self, *args, **kwargs):
        self.calls.append(args)
        if hasattr(self.fn, "signature"):
            self.keys.append(self.fn.signature(*args, **kwargs)[0])
        return self.fn(*args, **kwargs)


def _frames():
    frames, _ = fixtures.two_plane_sequence(T, H, W, INTR, rvec_step=[0.002, -0.004, 0.001],
                                            t_step=[-0.08, 0.012, 0.006], d_near=5.0,
                                            d_far=10.0, seed=4)
    return frames


class Store:
    """The port's own features of the whole sequence, in `run_slam`'s
    `features=` duck type."""

    def __init__(self, frames):
        self.f = extract_mod.extract_features(torch.from_numpy(frames), CFG)
        self.x, self.y, self.mask = (a.numpy() for a in (self.f.x, self.f.y, self.f.mask))

    def frame_feats(self, t):
        return Features(*(a[t:t + 1] for a in self.f))


def _counted_run(frames, **kw):
    """One `run_slam` on the CPU with every captured entry point and eager
    step counted; then the refit of its final map.  Returns (result, the
    refit map, {name: Counted})."""
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, _ in CAPTURED:
            counts[name] = Counted(getattr(mod, name))
            mp.setattr(mod, name, counts[name])
        for name in EAGER:
            counts[name] = Counted(getattr(slam, name))
            mp.setattr(slam, name, counts[name])
        res = slam.run_slam(frames, INTR, CFG, MCFG, SCFG, device="cpu", **kw)
        refit = res.map_points.copy()
        slam.refit_map_points(res.keyframes, refit, res.map_mask, INTR, device="cpu")
    return res, refit, counts


def _eager_run(frames, **kw):
    """The same run and refit with the eager functions patched in for the
    captured entry points."""
    with contextlib.ExitStack() as stack:
        for mod, name, eager in CAPTURED:
            stack.enter_context(mock.patch.object(mod, name, eager))
        res = slam.run_slam(frames, INTR, CFG, MCFG, SCFG, device="cpu", **kw)
        refit = res.map_points.copy()
        slam.refit_map_points(res.keyframes, refit, res.map_mask, INTR, device="cpu")
    return res, refit


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def own(frames):
    """The loop on its own extraction: counted, and eager-patched."""
    return _counted_run(frames), _eager_run(frames)


@pytest.fixture(scope="module")
def pre(frames):
    """The loop on pre-extracted features: counted, and eager-patched."""
    store = Store(frames)
    return _counted_run(frames, features=store), _eager_run(frames, features=store)


def _frame_index(frames, x) -> int:
    hits = [t for t in range(len(frames)) if np.array_equal(frames[t], x.numpy())]
    assert len(hits) == 1, hits
    return hits[0]


def test_scene_bootstraps_retires_and_archives(own):
    (res, _, _), _ = own
    assert res.keyframe_indices == [0, 5, 9]
    assert sum(k.kp.get("desc_host") is not None for k in res.keyframes) == 1


def test_track_loop_replays_the_track_step(own, frames):
    (res, _, c), _ = own
    boot = res.keyframe_indices[1]
    steps = c["_track_step_jit"]
    assert sorted(_frame_index(frames, a[0]) for a in steps.calls) == list(range(boot + 1, T))
    assert len(set(steps.keys)) == 1, "one signature: P = 2 live keyframes for the whole run"
    assert c["_track_step"].calls == [], "the loop called the eager track step itself"
    assert c["_match_kf_jit"].calls == []
    # the eager extraction and match run only inside the track step (the
    # jit's own fn, which calls them by these names)
    assert len(c["extract_features"].calls) == len(steps.calls)
    assert len(c["_match_kf"].calls) == len(steps.calls)


def test_bootstrap_replays_extract_and_match(own, frames):
    (res, _, c), _ = own
    boot = res.keyframe_indices[1]
    ex = c["extract_features_jit"]
    assert [_frame_index(frames, a[0][0]) for a in ex.calls] == list(range(boot + 1))
    assert len(set(ex.keys)) == 1
    m = c["match_descriptors_jit"]
    # frames 1..boot against frame 0, then the boot - 1 buffered frames
    assert len(m.calls) == 2 * boot - 1
    assert len(set(m.keys)) == 1


def test_loop_search_replays_the_loop_match(own):
    (res, _, c), _ = own
    lm = c["_loop_match_jit"]
    assert len(lm.calls) >= 1
    assert c["_loop_match"].calls == []
    for a in lm.calls:
        C = a[0].shape[0]
        assert C & (C - 1) == 0, f"archive capacity {C} is not a pow2 bucket"
    n_arch = sum(k.kp.get("desc_host") is not None for k in res.keyframes)
    assert len(set(lm.keys)) <= int(np.log2(max(n_arch, 1))) + 1


def test_refit_replays_refine_points(own):
    (_, _, c), _ = own
    rp = c["refine_points_jit"]
    assert len(rp.calls) == 1
    prob = rp.calls[0][0]
    n, m = prob.cam_idx.shape[0], prob.cams.shape[0]
    assert n & (n - 1) == 0 and m & (m - 1) == 0, (n, m)
    assert float(prob.w.sum()) < n, "the problem is padded with weight-0 rows"


def test_pre_extracted_path_replays_match_kf(pre, frames):
    (res, _, c), _ = pre
    boot = res.keyframe_indices[1]
    mk = c["_match_kf_jit"]
    assert len(mk.calls) == T - boot - 1
    assert len(set(mk.keys)) == 1
    assert c["_match_kf"].calls == [] and c["_track_step_jit"].calls == []
    assert c["extract_features_jit"].calls == [] and c["extract_features"].calls == []
    assert len(c["match_descriptors_jit"].calls) == 2 * boot - 1


def _same_run(a, b):
    assert a.keyframe_indices == b.keyframe_indices
    assert a.num_tracked == b.num_tracked
    assert a.map_n == b.map_n
    for x, y in ((a.trajectory, b.trajectory), (a.map_points, b.map_points),
                 (a.map_mask, b.map_mask), (a.map_anchor, b.map_anchor)):
        assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8))
    assert [(i, j, w) for i, j, _, w, _ in a.loop_edges] == \
        [(i, j, w) for i, j, _, w, _ in b.loop_edges]
    for ea, eb in zip(a.loop_edges, b.loop_edges):
        assert np.array_equal(ea[2], eb[2]) and np.array_equal(ea[4], eb[4])
    assert [(i, j) for i, j, _ in a.odo_edges] == [(i, j) for i, j, _ in b.odo_edges]
    for ea, eb in zip(a.odo_edges, b.odo_edges):
        assert np.array_equal(ea[2], eb[2])
    for ka, kb in zip(a.keyframes, b.keyframes):
        assert np.array_equal(ka.pose, kb.pose) and np.array_equal(ka.pt_ids, kb.pt_ids)


@pytest.mark.parametrize("path", ["own", "pre"])
def test_run_equals_the_eager_patched_run(path, own, pre):
    (res, refit, _), (eager, eager_refit) = own if path == "own" else pre
    _same_run(res, eager)
    assert np.array_equal(refit.view(np.uint8), eager_refit.view(np.uint8))
    assert not np.array_equal(refit, res.map_points), "the refit moved no point"
