"""BENCHMARK.json against the benchmark's contract, and every part of every
cell found by its name."""

import json
import re

import pytest

from benchmark.lib import runner

M = runner.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(M) == TOP
    assert M["command"][:2] == ["python3", "benchmark/run.py"] and len(M["command"]) <= 32
    assert M["paths"] == ["benchmark"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((runner.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in M["command"]:
        assert _text(word) and not word.startswith("/") and ".." not in word


def test_names_units_and_texts():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _text(w["why"])
        assert w["chips"] == 1
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in M[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(ms) == len(set(ms))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in M["workloads"]:
        mine = [m["name"] for m in runner.metrics_for(M, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert runner.metrics_for(M, w["name"], True), w["name"]


def test_per_layer_metrics_name_layer_moves_and_cells():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in cells
            assert w in moved.get("workloads", [w]), (m["name"], w)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in M["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].startswith("roofline_pct.") and m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(workload):
    parts = runner.cell(M, workload)
    assert parts["config"]["sift"] and parts["config"]["match"]
    kind = parts["kind"]
    assert kind.__file__ == str(runner.HERE / "kinds" / f"{parts['traffic']['kind']}.py")
    assert kind.ENTRIES and callable(kind.Loop) and callable(kind.control)
    assert all(v.startswith("siftgpu_tpu_torch") for v in kind.ENTRIES.values())
    assert parts["limits"]
    for traced in (False, True):
        for m in runner.metrics_for(M, workload, traced):
            assert (runner.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_configuration_files(config):
    c = next(x for x in M["configs"] if x["name"] == config)
    data = json.loads((runner.ROOT / c["file"]).read_text())
    assert data["name"] == config
    assert data["reduced"] == c["reduced"]
    assert set(data["precision"]) == {"extract", "match"}
    assert data["match"]["max_sift"] == data["sift"]["max_keypoints"]
