"""A configuration, a traffic mix, an input kind, a cell and a per-layer
metric are added as new files and entries alone: in a copy of the
benchmark, a throwaway set of them runs without an edit to any file that
was there.  One new cell is a new mix of a kind that exists (a data file);
the other a mix of a new kind (`kinds/<kind>.py`, with its own inputs,
entry point, reference check and control)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.sizes import ROOT

NEW_KIND = '''"""Pairs of uint8 sets, one pair a call through `match`."""
from types import SimpleNamespace

import torch

from benchmark.lib import compare, inputs
from benchmark.reference import match as ref_match

ENTRIES = {"MatchConfig": "siftgpu_tpu_torch:MatchConfig",
           "match": "siftgpu_tpu_torch.frontend.match:match_descriptors_jit"}


class Loop:
    batch, pairs_per_call = 0, 1

    def __init__(self, traffic, config, entries, device, seed):
        self.t, self.config, self.e = traffic, config, entries
        self.device, self.seed = torch.device(device), int(seed)
        self.mcfg = entries.MatchConfig(**config["match"])

    def setup(self):
        K = self.config["sift"]["max_keypoints"]
        g = inputs.generator(self.device, self.seed)
        self.sets = inputs.descriptor_sets(self.t["sets"], K, self.t["overlap"], 0.1, 2, g,
                                           self.device)
        self.m = torch.ones(K, dtype=torch.bool, device=self.device)

    def pair(self, i):
        n = self.sets.shape[0]
        return i % n, (i + 1) % n

    def step(self, i):
        a, b = self.pair(i)
        return self.e.match(self.sets[a], self.sets[b], self.m, self.m, self.mcfg)

    def work(self, out):
        return 0, 1

    def check(self, kept, precision):
        n = 0
        for i, res in kept:
            a, b = self.pair(i)
            r = ref_match.match_pair(self.sets[a], self.sets[b], self.m, self.m,
                                     self.config["match"], precision["match"])
            n += compare.match_sets_differing(type(res)(*(t[None] for t in res)), [r])
        return {"match_entries_differing": float(n)}


def control(precision):
    return SimpleNamespace(
        MatchConfig=lambda **kw: dict(kw),
        match=lambda d0, d1, m0, m1, cfg: ref_match.match_pair(d0, d1, m0, m1, cfg,
                                                               precision["match"]))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_adding_cells_needs_no_edit(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "siftgpu_tpu_torch").symlink_to(ROOT / "siftgpu_tpu_torch")
    before = _digests(tmp_path)
    b = tmp_path / "benchmark"

    cfg = json.loads((b / "configs" / "tum-vga.json").read_text())
    cfg.update(name="toy-qvga", reduced=[])
    cfg["sift"].update(height=80, width=112, max_keypoints=128)
    cfg["match"].update(max_sift=128, max_match=128)
    (b / "configs" / "toy-qvga.json").write_text(json.dumps(cfg))
    (b / "traffic" / "pairs-b3.json").write_text(json.dumps(
        {"kind": "sequence", "ring": 12, "shift_px": [1, 1], "smooth": 2,
         "extract_per_call": 3, "match": "consecutive", "check_calls": 1}))
    (b / "limits" / "toy.pairs.json").write_text(json.dumps({"limits": {"kp_unpaired_pct": 0.0}}))
    (b / "metrics" / "keypoints_per_frame.py").write_text(
        "def read(run):\n"
        "    t = run.trace\n"
        "    if t is None:\n"
        "        return None\n"
        "    return sum(int(o.feats.mask.sum()) for _, o in t.outputs) / t.frames\n")
    (b / "kinds" / "pair_sets.py").write_text(NEW_KIND)
    (b / "traffic" / "pair-ring.json").write_text(json.dumps(
        {"kind": "pair_sets", "sets": 6, "overlap": 0.5, "check_calls": 2}))
    (b / "limits" / "toy.single.json").write_text(
        json.dumps({"limits": {"match_entries_differing": 0.0}}))

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toy-qvga", "source": "a test", "reduced": [],
                                "file": "benchmark/configs/toy-qvga.json", "why": "a test"})
    manifest["workloads"] += [
        {"name": "toy.pairs", "config": "toy-qvga", "traffic": "pairs-b3", "chips": 1,
         "why": "a test"},
        {"name": "toy.single", "config": "toy-qvga", "traffic": "pair-ring", "chips": 1,
         "why": "a test"}]
    manifest["per_layer"].append({"name": "keypoints_per_frame", "unit": "count",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "extraction front end", "moves": "frames_per_s",
                                  "workloads": ["toy.pairs"]})
    for m in manifest["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("toy.pairs")
        if m["name"] == "pairs_per_s":
            m["workloads"].append("toy.single")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = ("import sys, json; sys.path.insert(0, '.'); from benchmark.lib import runner;"
            "M = runner.load_manifest(); out = {};"
            "out['pairs'] = runner.run_cell('toy.pairs', 5, 0.3, True, 'cpu', settle=0)[0];"
            "out['single'] = runner.run_cell('toy.single', 5, 0.3, False, 'cpu', settle=0)[0];"
            "parts = runner.cell(M, 'toy.single');"
            "ctl = parts['kind'].control(runner.lowered(parts['config']));"
            "out['control'] = runner.run_cell('toy.single', 5, 0.3, False, 'cpu', entries=ctl,"
            " settle=0)[0];"
            "print(json.dumps(out))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["pairs"]["correct"] is True
    assert out["pairs"]["metrics"]["keypoints_per_frame"]["value"] > 0
    assert out["single"]["correct"] is True
    assert set(out["single"]["metrics"]) == {"pairs_per_s", "call_ms_p95", "setup_s"}
    assert out["control"]["correct"] is False
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
