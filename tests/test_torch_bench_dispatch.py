"""Which entry points bench_torch.py's timed sections call: as bench.py
times compiled programs, the 640, 1080p, 4k and 16k sections time and gate
replays of their captures (`bench_torch.BENCH`).  One process, on the CPU,
at the small sizes of tests/test_torch_bench*.py (`bench_torch.SMALL`).

Each section runs with its timed loops on: the card's bookkeeping (syncs,
memory readings, CUDA events) is faked, so the queued reps and the
event-timed calls run on the CPU.  Each captured entry point is wrapped by
a counting pass-through, and each eager function by a recorder of the
calls made outside a captured one.  Then:

- every timed and gated call of a section goes through its captured entry
  points, one signature each (the 16k section's random and permuted pairs
  share one); the 640 section's match slices the pairs inside the program;
- the only eager call outside them is the 1080p and 4k sections' one
  `extract_features`, made while the kernels' calls are recorded for the
  gate against their plain versions;
- every output of the section equals bit for bit the output of the same
  call with the eager functions patched in for the captured ones.

On CPU tensors a captured entry point calls its eager function, so these
tests pin the dispatch, not the captures: chip_smoke.py phase 5b runs the
sections through their captures on the card.
"""

from unittest import mock

import pytest
import torch

import bench_torch as bt
import chip_smoke as cs
from torch_threads import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
# captured entry point -> the eager function it captures
CAPTURED = {"extract_features_jit": bt.extract_features,
            "match_sliced_jit": bt._match_sliced,
            "match_descriptors_jit": bt.match_descriptors}
# the eager functions by the names bench_torch calls them by
EAGER = ("extract_features", "match_descriptors_batch", "match_descriptors")
USES = {"640": {"extract_features_jit", "match_sliced_jit"},
        "1080p": {"extract_features_jit"}, "4k": {"extract_features_jit"},
        "16k": {"match_descriptors_jit"}}


class Tracker:
    """Counts each captured entry point's calls, their signatures and
    outputs, and the eager calls made outside any of them (with whether
    `kernel_calls` was recording)."""

    def __init__(self):
        self.depth, self.recording = 0, False
        self.calls = {name: 0 for name in CAPTURED}
        self.keys = {name: set() for name in CAPTURED}
        self.outputs, self.outside = [], []

    def captured(self, name, fn, key_of):
        def call(*args, **kwargs):
            self.calls[name] += 1
            self.keys[name].add(key_of(*args, **kwargs))
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            self.outputs.append((name, out))
            return out
        return call

    def eager(self, name, fn):
        def call(*args, **kwargs):
            if not self.depth:
                self.outside.append((name, self.recording))
            return fn(*args, **kwargs)
        return call

    def kernel_calls(self, fn):
        def start(*args, **kwargs):
            calls, restore = fn(*args, **kwargs)
            self.recording = True

            def stop():
                self.recording = False
                return restore()
            return calls, stop
        return start


def fake_event_stats(fn, n):
    for _ in range(n):
        fn()
    return {"n": n, "median_ms": 0.0, "p90_ms": 0.0, "min_ms": 0.0, "max_ms": 0.0}


class CpuTimed(bt.Section):
    """A section timed on the CPU: made as on the card, then given the
    CPU's device (the card's calls are faked by `timed_on_cpu`)."""

    def __init__(self, name, dev, timed=True):
        super().__init__(name, torch.device("cuda"), timed)
        self.dev = dev


def timed_on_cpu(mp):
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        mp.setattr(torch.cuda, name, lambda *a, **kw: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        mp.setattr(torch.cuda, name, lambda *a, **kw: 0)
    mp.setattr(bt, "event_stats", fake_event_stats)
    mp.setattr(bt, "Section", CpuTimed)


def run_section(name, eager_patched: bool):
    """The section at its small size with its timed loops on: (its record,
    the Tracker).  `eager_patched`: the eager functions stand in for the
    captured entry points."""
    t = Tracker()
    with pytest.MonkeyPatch.context() as mp:
        timed_on_cpu(mp)
        for cap, eager in CAPTURED.items():
            if eager_patched:
                fn, key_of = eager, (lambda *a, **kw: None)
            else:
                fn = getattr(bt, cap)
                key_of = lambda *a, _fn=fn, **kw: _fn.signature(*a, **kw)[0]
            mp.setattr(bt, cap, t.captured(cap, fn, key_of))
        for name_ in EAGER:
            mp.setattr(bt, name_, t.eager(name_, getattr(bt, name_)))
        mp.setattr(bt, "kernel_calls", t.kernel_calls(bt.kernel_calls))
        out = bt.SECTION_FNS[name](CPU, bt.SMALL[name], bt.SEEDS[name])
    return out, t


@pytest.fixture(scope="module", params=sorted(USES))
def section(request):
    name = request.param
    return name, run_section(name, False), run_section(name, True)


def test_timed_and_gated_calls_replay(section):
    name, (out, t), _ = section
    s = bt.SMALL[name]
    timed = s.reps * s.iters + s.events
    assert out["reps_s"] is not None and out["events"] is not None   # the loops ran
    gated = {"640": 1, "1080p": 2, "4k": 2, "16k": 2}[name]   # first call(s) and gates
    want = {cap: (gated + timed if cap in USES[name] else 0) for cap in CAPTURED}
    if name == "640":
        want["match_sliced_jit"] = 1 + timed
    assert t.calls == want
    assert all(len(t.keys[cap]) == (cap in USES[name]) for cap in CAPTURED), t.keys
    if name in ("1080p", "4k"):
        assert t.outside == [("extract_features", True)]
    else:
        assert t.outside == []
    assert out["captures"] == {"count": 0, "seconds": 0, "pool_bytes": 0}   # none on the CPU


def test_outputs_equal_the_eager_patched_section(section):
    name, (out, t), (out_e, t_e) = section
    assert [n for n, _ in t.outputs] == [n for n, _ in t_e.outputs] and t.outputs
    for (n, a), (_, b) in zip(t.outputs, t_e.outputs):
        assert cs.same_tree(a, b), n
    keys = ("kp_per_frame", "matches_per_pair", "kp", "max_abs_err", "matches",
            "permutation_recovered", "launches")
    assert {k: out.get(k) for k in keys} == {k: out_e.get(k) for k in keys}
    assert t_e.outside == t.outside


def test_the_match_slices_inside_the_program():
    """bench.py:77-84: `match_sliced_jit` takes the whole batch and matches
    its consecutive pairs, as `match_descriptors_batch` on the slices."""
    g = torch.Generator().manual_seed(0)
    desc = torch.randint(0, 256, (3, 64, 128), generator=g, dtype=torch.uint8)
    mask = torch.rand(3, 64, generator=g) < 0.9
    cfg = bt.MatchConfig(max_sift=64, max_match=64)
    got = bt.match_sliced_jit(desc, mask, cfg)
    want = bt.match_descriptors_batch(desc[:-1], desc[1:], mask[:-1], mask[1:], cfg)
    assert cs.same_tree(got, want)
    with mock.patch.object(bt, "match_descriptors_batch", side_effect=AssertionError("called")):
        with pytest.raises(AssertionError, match="called"):
            bt.match_sliced_jit(desc, mask, cfg)
