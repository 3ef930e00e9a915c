"""The traced part of a `--trace 1` run: `torch.profiler` over a fixed
number of steady calls inside the window, read back from its Chrome trace.

`Trace` holds the device records (kernels, copies and sets) and the host
events of the profiled calls, the profiled window (first call's start to
last call's end, host annotations `bench.call`) and the busy time (the
union of the device records' intervals).  A hand kernel is a `__global__`
function of the program's CUDA sources; `record_check` holds the records of
each against the launches the program's counters say the profiled calls
made.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

__all__ = ["CALL_SPAN", "Trace", "profile_calls"]

CALL_SPAN = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def _base_name(name: str) -> str:
    """A kernel record's function name without return type, namespace,
    template arguments or parameters."""
    s = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    s = re.sub(r"<.*>", "", s)
    return s.split("::")[-1].split()[-1] if s.split("::")[-1].strip() else name


class Trace:
    def __init__(self, events: list, hand: dict, counts_before: dict, counts_after: dict,
                 frames: int, pairs: int, outputs: list):
        self.frames, self.pairs, self.outputs = frames, pairs, outputs
        spans = [e for e in events
                 if e.get("name") == CALL_SPAN and e.get("cat") == "user_annotation"]
        if spans:
            self.t0 = min(e["ts"] for e in spans)
            self.t1 = max(e["ts"] + e["dur"] for e in spans)
        else:
            self.t0 = self.t1 = 0.0
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e["dur"]), e.get("cat"))
             for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
             and self.t0 <= e["ts"] <= self.t1),
            key=lambda r: r[1])
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                     if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                     and e.get("name") != CALL_SPAN]
        self.hand = hand
        self.launches = {src: counts_after.get(src, 0) - counts_before.get(src, 0)
                         for src in set(counts_after) | set(counts_before)}
        self.window_us = self.t1 - self.t0
        self.busy_us, self._merged = self._union()

    def _union(self):
        merged = []
        for _, ts, dur, _ in self.device:
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ts + dur)
            else:
                merged.append([ts, ts + dur])
        return sum(b - a for a, b in merged), merged

    def kernel_us(self, base: str) -> float:
        """Device microseconds of the records of kernel function `base`."""
        return sum(d for n, _, d, c in self.device if c == "kernel" and _base_name(n) == base)

    def records(self, base: str) -> int:
        return sum(1 for n, _, _, c in self.device if c == "kernel" and _base_name(n) == base)

    def other_us(self, exclude) -> float:
        """Device microseconds of every record whose function is not in
        `exclude` (copies and sets included)."""
        return sum(d for n, _, d, c in self.device
                   if not (c == "kernel" and _base_name(n) in exclude))

    def record_check(self) -> dict:
        """{hand kernel: (records, launches expected)} for the hand kernels
        that ran or were expected."""
        out = {}
        for base, src in sorted(self.hand.items()):
            expected, seen = self.launches.get(src, 0), self.records(base)
            if expected or seen:
                out[base] = (seen, expected)
        return out

    def records_sound(self, *bases) -> bool:
        """Every record of these kernels is there (none lost by the profiler)."""
        chk = self.record_check()
        return all(b in chk and chk[b][0] == chk[b][1] and chk[b][0] > 0 for b in bases)

    def breakdown(self) -> dict:
        """The 10 device functions that took most time, and the 10 longest
        idle gaps of the profiled window by what the host was doing."""
        by_name: dict = {}
        for n, _, d, c in self.device:
            key = _base_name(n) if c == "kernel" else n
            by_name[key] = by_name.get(key, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, prev = [], self.t0
        for a, b in self._merged + [[self.t1, self.t1]]:
            if a > prev:
                gaps.append((prev, a - prev))
            prev = max(prev, b)
        gaps = sorted(gaps, key=lambda g: -g[1])[:10]
        named = []
        for start, dur in gaps:
            cover = [h for h in self.host if h[1] <= start < h[1] + h[2]]
            inner = min(cover, key=lambda h: h[2])[0] if cover else "host: between calls"
            named.append([inner, dur * 1e-6])
        return {"device_ops": [[n[:160], us * 1e-6] for n, us in ops], "idle_gaps": named}


def profile_calls(loop, first: int, n: int, sync, hand: dict, counts) -> Trace:
    """Run calls first .. first + n - 1 of `loop` under the profiler, each
    in a `bench.call` range and synchronised, and read the trace back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = counts()
    outputs, frames, pairs = [], 0, 0
    with profile(activities=acts) as prof:
        for i in range(first, first + n):
            with record_function(CALL_SPAN):
                out = loop.step(i)
                sync()
            f, p = loop.work(out)
            frames, pairs = frames + f, pairs + p
            outputs.append((i, out))
    after = counts()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return Trace(events, hand, before, after, frames, pairs, outputs)
