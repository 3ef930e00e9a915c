"""bench_torch.py, the port's counterpart of bench.py, on the CPU: its
workloads and its line.

Its workload generators against bench.py's recipe built with the
reference's own fixtures (bit for bit); the 640 section at a small size
against the reference's `extract_features_jit` + `match_descriptors_batch`
on the same frames (keypoints per frame equal and within the extraction
budgets of tests/test_torch_extract.py; matches per pair and matched index
pairs equal, measured at this size); the 640 and pairing gates raising on
bad output; no run without a card; and the last line's keys against
bench.py's own.  The other sections: tests/test_torch_bench_frames.py
(1080p and 4k) and tests/test_torch_bench_phase.py (16k, the stage table,
chip_smoke.py's phase 5b)."""

import ast
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
import chip_smoke as cs
from siftgpu_tpu import MatchConfig as JMatch
from siftgpu_tpu import SiftConfig as JConfig
from siftgpu_tpu import extract_features_jit
from siftgpu_tpu.frontend.match import match_descriptors_batch as jmatch_batch
from siftgpu_tpu.oracle import fixtures as jfix
from siftgpu_tpu_torch import MatchConfig, SiftConfig, extract_features, match_descriptors_batch
from siftgpu_tpu_torch.frontend.match import match_descriptors
from siftgpu_tpu_torch.oracle import fixtures

from test_torch_extract import check_features
from torch_threads import one_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# The 640 section at a small size.  bench.py's 96x128 frames hold 66-85
# keypoints each, under the section's floor of 100 per frame (phase 4's
# gate, kept), so the parity run takes 120x160, where they hold 143-150.
SMALL_640 = bt.SMALL["640"]
# matches per pair, port against reference (measured: equal, and the
# matched index pairs too, since both order the keypoints alike)
MATCH_TOL = 0


def bench_py_keys():
    """The keys of bench.py's JSON line (bench.py:248-262), read from its
    source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                return keys
    raise AssertionError("bench.py has no JSON line")


def bench_py_frames(h, w, b, seed):
    """bench.py:66-72's frames with the reference's fixtures, as float32."""
    base = jfix.random_texture(h, w, seed=seed, smooth=3)
    frames = [base] + [jfix.warp_affine(base, np.eye(2), np.array([3.0 * i, -2.0 * i]))
                       for i in range(1, b)]
    return np.stack(frames).astype(np.float32)


@pytest.mark.parametrize("name", ["640", "1080p", "4k"])
def test_frames_are_bench_py_frames(name):
    s, seed = bt.SIZES[name], bt.SEEDS[name]
    if s.b > 1:
        got, want = bt.make_frames(s.h, s.w, s.b, seed), bench_py_frames(s.h, s.w, s.b, seed)
    else:   # bench.py:139-141, :171-172
        got = bt.spatial_frame(s.h, s.w, seed)
        want = jfix.random_texture(s.h, s.w, seed=seed, smooth=3)[None]
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_16k_sets_are_bench_py_sets():
    rng = np.random.default_rng(3)   # bench.py:198-205
    n = bt.SIZES["16k"].k
    want = [rng.integers(0, 256, (n, 128), dtype=np.uint8) for _ in range(2)]
    got = bt.large_sets(n, bt.SEEDS["16k"])[:2]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@functools.lru_cache(maxsize=None)
def reference_640(h, w, b, k, seed):
    """The reference's features and matches on bench.py's recipe (its
    matcher jitted over the pair slices, as bench.py:78-82)."""
    frames = bench_py_frames(h, w, b, seed)
    f = extract_features_jit(jnp.asarray(frames), JConfig(height=h, width=w, max_keypoints=k))
    mcfg = JMatch(max_sift=k, max_match=k)
    r = jax.jit(lambda d, m: jmatch_batch(d[:-1], d[1:], m[:-1], m[1:], mcfg))(f.desc, f.mask)
    return f, r


@pytest.fixture(scope="module")
def section_640():
    """The section's record, and the features and matches of its first
    iteration."""
    seen = {}

    def keep(fn, key):
        def run(*a):
            seen.setdefault(key, fn(*a))
            return seen[key]
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bt, "extract_features_jit", keep(bt.extract_features_jit, "feats"))
        mp.setattr(bt, "match_descriptors_batch", keep(bt.match_descriptors_batch, "res"))
        out = bt.section_640(CPU, SMALL_640, 0)
    return out, seen["feats"], seen["res"]


def test_640_section_matches_reference(section_640):
    s = SMALL_640
    out, feats, res = section_640
    ref_f, ref_r = reference_640(s.h, s.w, s.b, s.k, 0)
    assert out["kp_per_frame"] == np.asarray(ref_f.count).tolist()
    check_features(ref_f, feats)
    ref_matches = np.asarray(ref_r.count)
    assert np.abs(np.subtract(out["matches_per_pair"], ref_matches)).max() <= MATCH_TOL
    for i, c in enumerate(ref_matches):
        got = res.pairs[i, : int(res.count[i])].numpy()
        assert {tuple(p) for p in got} == {tuple(p) for p in np.asarray(ref_r.pairs[i, :c])}
    # a CPU run times nothing and reads no device memory
    assert all(out[key] is None for key in
               ("warmup_s", "reps_s", "events", "peak_call_bytes", "peak_bytes"))


def _small_run(frames, k):
    h, w = frames.shape[1:]
    cfg = SiftConfig(height=h, width=w, max_keypoints=k)
    f = extract_features(torch.from_numpy(frames), cfg)
    r = match_descriptors_batch(f.desc[:-1], f.desc[1:], f.mask[:-1], f.mask[1:],
                                MatchConfig(max_sift=k, max_match=k))
    return cfg, f, r


def test_640_gates_pass_then_raise_on_a_wrong_shift():
    s = SMALL_640
    frames = bt.make_frames(s.h, s.w, s.b, 0)
    cfg, f, r = _small_run(frames, s.k)
    cs.main_path_gates(frames, f, r, cfg)
    base = frames[0]   # frame i shifted by (5i, -2i), not the (3i, -2i) the gate expects
    wrong = np.stack([base] + [fixtures.warp_affine(base, np.eye(2), np.array([5.0 * i, -2.0 * i]))
                               for i in range(1, s.b)]).astype(np.float32)
    cfg, f, r = _small_run(wrong, s.k)
    with pytest.raises(AssertionError, match="inlier rate"):
        cs.main_path_gates(wrong, f, r, cfg)


def test_640_section_raises_under_the_keypoint_floor():
    with pytest.raises(AssertionError, match="too few keypoints"):
        bt.section_640(CPU, SMALL_640._replace(h=96, w=128), 0)


def test_cpu_pairing_gate_raises_on_another_frame():
    s = bt.SMALL["1080p"]
    cfg = SiftConfig(height=s.h, width=s.w, max_keypoints=s.k)
    frame = bt.spatial_frame(s.h, s.w, 7)
    cs.cpu_pairing_gate(frame, extract_features(torch.from_numpy(frame), cfg), cfg, "same")
    other = extract_features(torch.from_numpy(bt.spatial_frame(s.h, s.w, 8)), cfg)
    with pytest.raises(AssertionError, match="paired share"):
        cs.cpu_pairing_gate(frame, other, cfg, "other")


def test_permutation_gate_at_512():
    d0, _, d1k, perm, _, _ = (torch.from_numpy(a) for a in bt.large_sets(512, 3))
    res = match_descriptors(d0, d1k, cfg=MatchConfig(max_sift=512, max_match=512))
    assert bt.permutation_gate(res, perm) >= 0.99 * 512
    shuffled = perm[torch.from_numpy(np.random.default_rng(0).permutation(512))]
    with pytest.raises(AssertionError, match="permuted pairs recovered"):
        bt.permutation_gate(res, shuffled)


def test_line_keys_and_values():
    keys = bench_py_keys()
    assert len(keys) == 12
    empty = bt.bench_line({})
    assert set(keys) <= set(empty) and all(empty[k] is None for k in keys
                                           if k not in ("metric", "unit"))
    # bench.py:116-123's arithmetic on given rep times
    results = {"640": {"reps_s": {"extract": [0.02, 0.016], "match": [0.003, 0.002]},
                       "kp_per_frame": [2048] * 4, "matches_per_pair": [1950, 1960, 1940]},
               "1080p": {"reps_s": {"extract": [0.025, 0.024]}},
               "4k": {"reps_s": {"extract": [0.04]}},
               "16k": {"reps_s": {"match": [0.0017, 0.0016]}},
               "stages": {"stages_s": {"pyramid": 0.0011, "TOTAL": 0.015}}}
    line = bt.bench_line(results, {"name": "card", "power_limit": "700.00 W", "count": 1}, 0)
    value = (8192 + 5850) / 0.018
    assert line["value"] == round(value, 1)
    assert line["vs_baseline"] == round(value / 60000.0, 3)
    assert (line["extract_640_ms"], line["match_640_ms"]) == (16.0, 2.0)
    assert line["reps_640_ms"] == [20.0, 16.0] and line["reps_match_ms"] == [3.0, 2.0]
    assert (line["ms_1080p"], line["ms_4k"], line["ms_match16k_stream"]) == (24.0, 40.0, 1.6)
    assert line["stages_640_ms"] == {"pyramid": 1.1, "TOTAL": 15.0}
    assert line["device"]["power_limit"] == "700.00 W" and line["sections"] is results
    json.dumps(line)


def test_cpu_run_line_has_bench_py_keys_without_timings():
    line = bt.run("cpu", only=("16k",), sizes=bt.SMALL)
    assert set(bench_py_keys()) <= set(line)
    assert line["device"] is None and line["ms_match16k_stream"] is None
    assert list(line["sections"]) == ["16k"]


def test_main_exits_1_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bt.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.skipif(torch.cuda.is_available(), reason="the command runs its sections on a card")
def test_command_exits_1_without_a_card():
    out = subprocess.run([sys.executable, "bench_torch.py", "--only", "16k"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == ""
