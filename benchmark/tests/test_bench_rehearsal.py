"""Each cell rehearsed on the CPU at a small size through the program's
plain routes: a well-formed result line, correct, and the metrics the
manifest gives the cell; and the command line's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import runner
from benchmark.tests.sizes import ROOT, SMALL

M = runner.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearsal_prints_a_well_formed_line(workload, traced):
    res, numbers, records = runner.run_cell(workload, 2**31 + 77, 0.5, traced, "cpu",
                                            sizes=SMALL[workload], settle=0.2)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["count"] == 1
    for name, c in line["compared"].items():
        assert c["value"] == numbers[name] and c["limit"] is not None
    units = {m["name"]: m["unit"] for m in M["end_to_end"] + M["per_layer"]}
    wanted = {m["name"] for m in runner.metrics_for(M, workload, traced)}
    assert set(line["metrics"]) <= wanted
    for name, v in line["metrics"].items():
        assert v["unit"] == units[name] and v["value"] > 0
    if traced:
        assert "dispatch_us_per_call" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert records == {}            # no device records on the CPU
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 3


def test_the_same_seed_makes_the_same_inputs():
    from benchmark.lib import inputs
    import torch

    a = inputs.sequence(4, 40, 48, (3, -2), 3, inputs.generator("cpu", 2**31 + 5), "cpu")
    b = inputs.sequence(4, 40, 48, (3, -2), 3, inputs.generator("cpu", 2**31 + 5), "cpu")
    c = inputs.sequence(4, 40, 48, (3, -2), 3, inputs.generator("cpu", 2**31 + 6), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the camera moves (3, -2) px a frame
    assert torch.equal(a[1, :-2, 3:], a[0, 2:, :-3])


def _cli(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


ARGS = ["--workload", "vga-stream", "--seed", "3", "--seconds", "1", "--trace", "0"]


def test_without_a_card_the_command_prints_no_result():
    p = _cli(ARGS, ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_without_the_program_the_harness_cannot_run(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _cli(ARGS, tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    q = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
                        "from benchmark.lib import program, runner; "
                        "program.entries(runner.cell(runner.load_manifest(), 'vga-stream')"
                        "['kind'].ENTRIES)"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert q.returncode != 0 and "siftgpu_tpu_torch" in q.stderr
