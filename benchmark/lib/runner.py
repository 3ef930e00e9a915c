"""One run of one cell: load, warm up, measure, check, report.

Everything a cell is made of is found by its name in BENCHMARK.json: the
configuration's file, `traffic/<mix>.json` (the mix's parameters), the
kind it names (`kinds/<kind>.py`: inputs, calls and the reference's side of
the check), `limits/<cell>.json` (the limit of each number compared) and
`metrics/<metric>.py` for every metric the cell reports.  Adding a
configuration, a mix, an input kind, a cell or a metric is adding files
and entries.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from . import compare, program, trace

__all__ = ["HERE", "ROOT", "FORBIDDEN", "LOWER", "Call", "Run", "load_manifest", "cell",
           "metrics_for", "lowered", "run_cell", "main"]

HERE = Path(__file__).resolve().parent.parent     # benchmark/
ROOT = HERE.parent                                # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "siftgpu_tpu")
# the nearest precision below each that a configuration states: the control's
LOWER = {"f32": "tf32", "int8": "int4"}
WARMUP_CALLS = 3        # call 0 captures extraction; 1 captures a match; 2 replays both
# then calls for this long before the window, counted in neither: on the
# H100 machines a process starts in a state in which the card takes 8-14%
# longer over each call (CUDA events; the same 1980 MHz SM clock) and
# leaves it, for good, after 0 to over 40 s of calls; 20 s of calls leave
# most runs past it
SETTLE_SECONDS = 20.0
PROFILED_CALLS = 16     # the window's last calls, under the profiler in a --trace 1 run


@dataclasses.dataclass
class Call:
    dispatch_s: float   # entry to return, before the synchronise
    latency_s: float    # issue to outputs ready


@dataclasses.dataclass
class Run:
    loop: object        # the kind's Loop
    calls: list
    window_s: float
    frames: int
    pairs: int
    setup_s: float
    trace: Optional[trace.Trace]


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _by_name(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _module(folder: str, name: str):
    """`benchmark/<folder>/<name>.py`, loaded once."""
    key = f"benchmark.{folder}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, HERE / folder / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def cell(manifest: dict, workload: str) -> dict:
    """The cell's parts: its manifest entry, configuration, traffic, the
    traffic's kind and the limits."""
    w = _by_name(manifest["workloads"], workload, "workload")
    c = _by_name(manifest["configs"], w["config"], "config")
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return dict(
        workload=w,
        config=json.loads((ROOT / c["file"]).read_text()),
        traffic=traffic,
        kind=_module("kinds", traffic["kind"]),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"],
    )


def metrics_for(manifest: dict, workload: str, traced: bool) -> list:
    """The metrics a cell reports: with --trace 0 the end-to-end metrics
    that name it or name no cell, with --trace 1 the per-layer metrics
    that name it."""
    if not traced:
        return [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    return [m for m in manifest["per_layer"] if workload in m["workloads"]]


def lowered(config: dict) -> dict:
    """The configuration's precisions, each one step lower: the control's."""
    return {k: LOWER[v] for k, v in config["precision"].items()}


def _sync(device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def _apply(d: dict, over: Optional[dict]) -> dict:
    out = json.loads(json.dumps(d))
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _apply(out[k], v)
        else:
            out[k] = v
    return out


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             entries=None, t_start: Optional[float] = None, sizes: Optional[dict] = None,
             settle: float = SETTLE_SECONDS) -> tuple:
    """Run one cell once -> (the result object, the compared numbers, the
    record check or None).  `entries` stand in for the program's (the
    control, the tests' faults); `sizes` overrides parts of the
    configuration and the traffic ({"config": {...}, "traffic": {...}}; the
    CPU tests' small shapes); `settle` is the seconds of calls between the
    warm-up calls and the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest()
    parts = cell(manifest, workload)
    config = _apply(parts["config"], (sizes or {}).get("config"))
    traffic = _apply(parts["traffic"], (sizes or {}).get("traffic"))
    device = torch.device(device)
    sync = _sync(device)
    if device.type == "cuda":
        program.build_all()     # found built after the first run of a checkout
    entries = entries or program.entries(parts["kind"].ENTRIES)

    loop = parts["kind"].Loop(traffic, config, entries, device, seed)
    with torch.no_grad():
        loop.setup()
        for i in range(WARMUP_CALLS):
            loop.step(i)
            sync()
        i = WARMUP_CALLS
        keep_n = int(traffic["check_calls"])
        # then calls that hold as many outputs as the window will (those kept
        # for the check, and the profiled calls'), so that the caching
        # allocator holds their blocks and no window call allocates anew;
        # twice as many, since consecutive outputs share the previous call's
        # features where the mix matches with them and kept ones do not
        held = collections.deque(maxlen=2 * (keep_n + 1 + (PROFILED_CALLS if traced else 0)))
        while len(held) < held.maxlen:
            held.append(loop.step(i))
            sync()
            i += 1
        setup_s = time.perf_counter() - t_start
        # settling: calls for a fixed time, counted in neither set-up nor
        # the window
        t_settle = time.perf_counter() + settle
        while time.perf_counter() < t_settle:
            held.append(loop.step(i))
            sync()
            i += 1
        held.clear()
        hand = program.hand_kernels() if traced else {}
        rng = random.Random(int(seed))
        kept, calls, tr = [], [], None
        frames = pairs = 0
        t_win = time.perf_counter()
        t_stop, t_last = t_win + seconds, t_win
        while time.perf_counter() < t_stop:
            t0 = time.perf_counter()
            out = loop.step(i)
            t1 = time.perf_counter()
            sync()
            t_last = time.perf_counter()
            calls.append(Call(t1 - t0, t_last - t0))
            f, p = loop.work(out)
            frames, pairs = frames + f, pairs + p
            if len(kept) < keep_n:          # a reservoir sample of the window's calls
                kept.append((i, out))
            else:
                j = rng.randrange(len(calls))
                if j < keep_n:
                    kept[j] = (i, out)
            i += 1
        if traced:                          # the window's last calls, under the profiler
            tr = trace.profile_calls(loop, i, PROFILED_CALLS, sync, hand, program.launch_counts)
            frames, pairs = frames + tr.frames, pairs + tr.pairs
            t_last = time.perf_counter()
        window_s = t_last - t_win
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

        kept.sort(key=lambda c: c[0])
        numbers = loop.check(kept, config["precision"])
    correct, compared = compare.judge(numbers, parts["limits"])

    run = Run(loop, calls, window_s, frames, pairs, setup_s, tr)
    metrics = {}
    for m in metrics_for(manifest, workload, traced):
        v = _module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    attempted = len(calls) + (PROFILED_CALLS if tr is not None else 0)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": 0 if correct else len(kept), "metrics": metrics, "device": dev}
    if traced and tr is not None:
        dev["busy_s"] = tr.busy_us * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = tr.breakdown()
    result["compared"] = compared
    return result, numbers, (tr.record_check() if tr is not None else None)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_manifest()
    chips = _by_name(manifest["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, numbers, records = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                        "cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; it may load none of {list(FORBIDDEN)}",
              file=sys.stderr)
        return 3
    if records is not None:
        for k, (seen, expected) in records.items():
            print(f"records {k}: {seen} in the trace, {expected} launches expected"
                  f"{'' if seen == expected else '  (RECORDS LOST)'}", file=sys.stderr)
    for k, v in sorted(numbers.items()):
        if k not in result["compared"]:
            print(f"not compared {k}: {v!r}", file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
