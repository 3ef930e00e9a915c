"""Which entry points config 5 (`parallel/sequence.py`) calls: where the
reference's `extract_sequence_dp` and `ResidentBA` run compiled programs,
the port's call the captured counterparts (`core/graphs.py`).  One process,
no spawned rank, on the CPU at tests/test_torch_sequence.py's scene (T = 8,
96x128, K = 256).  No JAX: the reference is not run here.

- `extract_sequence_dp` calls `dp.extract_features_dp_jit` once per chunk
  (chunks of 3, 3 and a tail of 2: two signatures) and never
  `dp.extract_features_dp`;
- `resident_ba_class` maps (cuda, nccl) and (cuda, one process) to
  `ResidentBAJit`, (cuda, gloo) to `ResidentBA`, and the CPU on any
  backend to `ResidentBAJit`;
- `run_slam_distributed(resident_map=True)` runs every windowed BA through
  `ResidentBAJit`'s programs (`_solve_jit` once a solve, `_scatter_jit`
  for the dirty uploads, `_gather_jit` for the free points) and never
  through `ResidentBA`'s eager ones;
- the store and the run each equal bit for bit the run with the eager
  functions patched back in (`unittest.mock.patch.object`, as chip_smoke.py
  phase 4f's NCCL rank does on the card).

On CPU tensors a captured entry point calls its eager function, so these
tests pin the dispatch, not the captures: phase 4f holds the replayed run
to the eager-patched run on the card.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from siftgpu_tpu_torch.parallel import dp, resident_ba, sequence
from torch_threads import one_thread  # noqa: F401 (autouse)

CHUNK = 3   # 8 frames: chunks of 3, 3 and 2


class Counted:
    """A pass-through that records the shape of each call's first argument
    (its length where it has no shape): the block, or the cameras."""

    def __init__(self, fn):
        self.fn, self.keys = fn, []

    def __call__(self, *args, **kwargs):
        self.keys.append(args[0].shape if hasattr(args[0], "shape") else len(args[0]))
        return self.fn(*args, **kwargs)


def _refuse(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"{name} was called")
    return fn


@contextlib.contextmanager
def _eager():
    """Config 5's captured entry points patched back to the eager functions."""
    with mock.patch.object(dp, "extract_features_dp_jit", dp.extract_features_dp), \
            mock.patch.object(resident_ba.ResidentBAJit, "scatter",
                              staticmethod(resident_ba._scatter)), \
            mock.patch.object(resident_ba.ResidentBAJit, "solver",
                              staticmethod(resident_ba._solve)), \
            mock.patch.object(resident_ba.ResidentBAJit, "gather",
                              staticmethod(resident_ba._gather)):
        yield


@contextlib.contextmanager
def _counted():
    """Count the calls of config 5's captured entry points; the eager
    extraction and `ResidentBA`'s eager programs raise if called."""
    counts = {"dp": Counted(dp.extract_features_dp_jit)}
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(dp, "extract_features_dp_jit", counts["dp"]))
        stack.enter_context(mock.patch.object(dp, "extract_features_dp",
                                              _refuse("extract_features_dp")))
        for name in ("scatter", "solver", "gather"):
            counts[name] = Counted(getattr(resident_ba.ResidentBAJit, name))
            stack.enter_context(mock.patch.object(resident_ba.ResidentBAJit, name,
                                                  staticmethod(counts[name])))
            stack.enter_context(mock.patch.object(resident_ba.ResidentBA, name,
                                                  staticmethod(_refuse(f"ResidentBA.{name}"))))
        yield counts


def _store(frames, cfg):
    seq = sequence.extract_sequence_dp(frames, cfg, None, "cpu", chunk=CHUNK)
    return [np.asarray(a) for a in (seq.desc, seq.mask_dev, seq.x, seq.y, seq.mask)]


def _run(frames, intr, cfg, mcfg, scfg):
    return worker._summary(sequence.run_slam_distributed(frames, intr, cfg, mcfg, scfg, None,
                                                         "cpu"))


@pytest.fixture(scope="module")
def scene():
    return worker.scene()


@pytest.fixture(scope="module")
def stores(scene):
    frames, _, _, cfg, _, _ = scene
    with _counted() as counts:
        got = _store(frames, cfg)
    with _eager():
        eager = _store(frames, cfg)
    return got, eager, counts


@pytest.fixture(scope="module")
def runs(scene):
    frames, _, intr, cfg, mcfg, scfg = scene
    with _counted() as counts:
        got = _run(frames, intr, cfg, mcfg, scfg)
    with _eager():
        eager = _run(frames, intr, cfg, mcfg, scfg)
    return got, eager, counts


def test_extraction_calls_the_captured_program_once_per_chunk(stores, scene):
    frames, _, _, cfg, _, _ = scene
    _, _, counts = stores
    h, w = cfg.height, cfg.width
    assert len(frames) == 8
    assert counts["dp"].keys == [(3, h, w), (3, h, w), (2, h, w)]


def test_extraction_equals_the_eager_store(stores):
    got, eager, _ = stores
    assert len(got) == len(eager) == 5
    for a, b in zip(got, eager):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("device, backend, cls", [
    ("cuda", "nccl", resident_ba.ResidentBAJit),
    ("cuda", None, resident_ba.ResidentBAJit),
    ("cuda:0", "gloo", resident_ba.ResidentBA),
    ("cpu", "gloo", resident_ba.ResidentBAJit),
    ("cpu", "nccl", resident_ba.ResidentBAJit),
    ("cpu", None, resident_ba.ResidentBAJit),
])
def test_resident_ba_class(device, backend, cls):
    assert resident_ba.resident_ba_class(torch.device(device), backend) is cls
    assert resident_ba.resident_ba_class(device, backend) is cls


def test_resident_solves_go_through_the_captured_programs(runs):
    got, _, counts = runs
    solves = len(counts["solver"].keys)
    assert solves > 0 and len(got["keyframe_indices"]) >= 2
    # every solve after the first uploads the slots the loop changed, and
    # every solve gathers its window's free points back
    assert 0 < len(counts["scatter"].keys) <= solves
    assert len(counts["gather"].keys) == solves
    assert len(counts["dp"].keys) == 2   # 8 frames, the default chunks of 4


def test_run_equals_the_eager_patched_run(runs):
    got, eager, _ = runs
    assert got["keyframe_indices"] == eager["keyframe_indices"]
    assert got["num_tracked"] == eager["num_tracked"]
    assert got["loop_edges"] == eager["loop_edges"]
    for k in ("trajectory", "map_points", "map_mask"):
        assert got[k].dtype == eager[k].dtype and np.array_equal(got[k], eager[k]), k
