#!/usr/bin/env python3
"""bench.py's measurements of the PyTorch/CUDA port (`siftgpu_tpu_torch`) on
one GPU.

    python3 bench_torch.py [--seed S] [--only SECTION ...]

The counterpart of bench.py: its workloads at its sizes, in its order, and its
JSON line (every key of bench.py:248-262, with bench.py's meaning) as the last
line of standard output.  Sections, with bench.py's lines:

  640     (:60-133) 4 frames of 480x640 (`random_texture(seed=0, smooth=3)`,
          frame i shifted by (3i, -2i)), `extract_features` at K = 2048, then
          `match_descriptors_batch` on the 3 consecutive pairs, the pairs
          sliced inside the program (bench.py:77-84's `_match_sliced`); 40
          queued iterations a rep.  `value` = (keypoints + matches) per second of
          extract + match, `vs_baseline` = value / 60000, as bench.py:116-123.
  1080p   (:136-159) one 1088x1920 frame (seed 7), K = 4096; 32 queued calls.
  4k      (:163-189) one 2160x3840 frame (seed 9), K = 8192; 24 queued calls.
  16k     (:194-228) two uint8 16384 x 128 sets from default_rng(3),
          `match_descriptors` with MatchConfig(max_sift=16384,
          max_match=16384); 32 queued calls.  The key `ms_match16k_stream` is
          kept for parity: the port has no streaming matcher, so it times the
          port's one fused best-2 reduction over the whole 16384 x 16384
          product (kernel 4) and its compaction, the call `match_descriptors`
          makes at every size.  The timed call and the permutation gate
          replay one capture (both pairs have one signature).
  stages  (:230-244) `pipeline/profile.py::profile_extraction` on the 640
          section's frames, 40 iterations a stage.  Its rows are the port's:
          one `orient+desc` row where the reference's CPU run shows `orient`
          and `describe`, and `detect` includes the prefilter.  As the
          reference's rows time compiled stages, each row times replays of
          its stage captured as a CUDA graph for the call (input copies and
          output clones included), not eager calls.

As bench.py times compiled programs (`extract_features_jit`, a jitted
matcher), the 640, 1080p, 4k and 16k sections time and gate replays of
captures (`core/graphs.py`) held in this script's own `GraphFamily`
(`BENCH`: `extract_features_jit`, `match_sliced_jit`,
`match_descriptors_jit`), one pool, released with the allocator's cache
emptied at the end of every section.  On the CPU the captured entry
points call the eager functions.

Protocol: bench.py's, on the card.  A warm-up call (its seconds on stderr),
then 5 reps of N calls queued back to back, each rep ending in one
torch.cuda.synchronize() (where bench.py reads one element back to the host),
and the minimum over the reps per call.  Then a second loop of EVENT_CALLS
calls, one CUDA-event pair around each, for the median and p90 (at least ten
samples lie beyond it).  The peak device memory of each section
(`max_memory_allocated` after `reset_peak_memory_stats`, less what was
allocated when the section began), of its first call and of the whole
section.  The kernel launches of each section's first
iteration (`ops/_build.py`'s counters).  The first call makes the
captures: `warmup_s` holds its 2 warm-up calls a capture and the capture
(`graphs.WARMUPS`), `peak_call_bytes` and `peak_bytes` include what the
warm-ups and the capture allocate (in the capture's pool too), and
`launches` counts the warm-up calls with the first replay.  Each
section's record has `captures`: their count, seconds and the reserved
memory of their pool (`Capture.seconds`, `Capture.pool_bytes`).

Gates, each raising: 640, chip_smoke.py's phase-4 gates (>= 90% known-shift
inliers at < 1 px per pair, >= 100 keypoints per frame, frame 0 through the
port on the CPU pairing >= 99% of its keypoints within 0.5 px with the
card's); 1080p and 4k, the K cap binds, one eager `extract_features` call
is recorded and each of its calls of kernels 1-3 and of the octave kernel
holds against its plain version on the card (chip_smoke.py's `Parity`, at
the frame's shapes; these launches do not count, nor does their memory in
the peaks; a replay calls no wrapper, so the record comes from the eager
call), the first replay and a second one equal that eager call bit for
bit, and the
frame through the port on the CPU pairs with the card's as frame 0 does;
16k, before the random sets are timed, >= 99% of
`chip_smoke.large_sets`' known permutation recovered (the random sets match
nothing, so they gate nothing).  Unlike bench.py no section's failure is
caught: a failed section fails the run, which then prints no JSON line.

Arguments: `--seed S` adds S to each section's seed (0, 7, 9 and 3: S = 0 is
bench.py's data); `--only SECTION ...` runs those sections (the others' keys
are null).  Without a CUDA device it exits 1: its times are the card's only.
The section functions take (device, sizes, seed), so the tests run them on the
CPU at a small size, where they time nothing.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from chip_smoke import (card_line, cpu_pairing_gate, hold_calls, kernel_calls, large_sets,
                        main_path_gates, make_frames, on_permutation, spatial_frame,
                        torch_equal_bits)
from siftgpu_tpu_torch import MatchConfig, SiftConfig, extract_features, match_descriptors_batch
from siftgpu_tpu_torch.core.graphs import GraphFamily, graphed
from siftgpu_tpu_torch.frontend.match import match_descriptors
from siftgpu_tpu_torch.ops import _build
from siftgpu_tpu_torch.pipeline.profile import profile_extraction

SECTIONS = ("640", "1080p", "4k", "16k", "stages")
SEEDS = {"640": 0, "1080p": 7, "4k": 9, "16k": 3, "stages": 0}
EVENT_CALLS = 120    # calls timed one by one: 12 samples lie beyond the p90


class Sizes(NamedTuple):
    """A section's shapes and counts: frame height and width, the cap k
    (keypoints per frame; descriptors per set in the 16k section), frames b,
    calls queued per rep, reps, and calls timed one by one."""
    h: int
    w: int
    k: int
    b: int = 1
    iters: int = 40
    reps: int = 5
    events: int = EVENT_CALLS


SIZES = {   # bench.py's
    "640": Sizes(480, 640, 2048, b=4, iters=40),
    "1080p": Sizes(1088, 1920, 4096, iters=32),
    "4k": Sizes(2160, 3840, 8192, iters=24),
    "16k": Sizes(0, 0, 16384, iters=32),
    "stages": Sizes(480, 640, 2048, b=4, iters=40),
}
SMALL = {   # a CPU rehearsal's: one call, nothing timed
    "640": Sizes(120, 160, 256, b=4, iters=1, reps=1, events=1),
    "1080p": Sizes(96, 160, 64, iters=1, reps=1, events=1),
    "4k": Sizes(120, 160, 96, iters=1, reps=1, events=1),
    "16k": Sizes(0, 0, 512, iters=1, reps=1, events=1),
    "stages": Sizes(120, 160, 256, b=4, iters=1, reps=1, events=1),
}
# bench.py's shapes, nothing timed: each section's gates and its first
# call's launches (chip_smoke.py's phase 5b on the card)
COUNTS = {name: s._replace(iters=1, reps=0, events=0) for name, s in SIZES.items()}


def _match_sliced(desc, mask, mcfg: MatchConfig):
    """bench.py:77-84: the batch's consecutive pairs, sliced inside the
    program, matched in one call."""
    return match_descriptors_batch(desc[:-1], desc[1:], mask[:-1], mask[1:], mcfg)


# the programs the sections time and gate (see the module's docstring)
BENCH = GraphFamily("bench")
extract_features_jit = graphed(extract_features, "bench extract_features_jit", BENCH)
match_sliced_jit = graphed(_match_sliced, "bench match_sliced_jit", BENCH)
match_descriptors_jit = graphed(match_descriptors, "bench match_descriptors_jit", BENCH)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def counted(fn):
    """fn() and the kernel launches it made, by kernel name."""
    before = {name: kern.launches for name, kern in _build.KERNELS.items()}
    out = fn()
    return out, {name: kern.launches - before[name] for name, kern in _build.KERNELS.items()}


class Section:
    """One section's run on `dev`: its sync, whether it is timed (on the card
    only, and not with `timed` False), its peak device memory (above what
    was allocated when it began), and its results."""

    def __init__(self, name: str, dev: torch.device, timed: bool = True):
        self.dev, self.timed = dev, timed and dev.type == "cuda"
        self.sync = torch.cuda.synchronize if self.timed else (lambda: None)
        self.out = {"name": name, "warmup_s": None, "reps_s": None, "events": None,
                    "peak_call_bytes": None, "peak_bytes": None}
        self.peak = 0
        if self.timed:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            self.base = torch.cuda.memory_allocated(dev)

    def first_call(self, fn):
        """The warm-up call, counted; its seconds and peak memory kept."""
        t0 = time.perf_counter()
        out, self.out["launches"] = counted(fn)
        self.sync()
        if self.timed:
            self.out["warmup_s"] = time.perf_counter() - t0
            self.out["peak_call_bytes"] = torch.cuda.max_memory_allocated(self.dev) - self.base
            say(f"{self.out['name']}: warm-up (first call): {self.out['warmup_s']:.1f}s")
        return out

    def queued(self, fn, sizes: Sizes) -> list:
        """bench.py's reps: `sizes.iters` calls queued, one sync; s per call."""
        reps = []
        for _ in range(sizes.reps):
            t0 = time.perf_counter()
            outs = [fn() for _ in range(sizes.iters)]
            self.sync()
            reps.append((time.perf_counter() - t0) / sizes.iters)
            del outs
        return reps

    @contextlib.contextmanager
    def unmeasured(self):
        """Work inside (a gate's comparisons) leaves the section's peak
        memory as it was; free what it allocated before it ends."""
        if self.timed:
            torch.cuda.synchronize()
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev) - self.base)
        yield
        if self.timed:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.dev)

    def finish(self) -> dict:
        caps = [c for g in BENCH.members for c in g.captures.values()]
        self.out["captures"] = {"count": len(caps), "seconds": sum(c.seconds for c in caps),
                                "pool_bytes": sum(c.pool_bytes for c in caps)}
        if self.timed:
            torch.cuda.synchronize()
            self.out["peak_bytes"] = max(
                self.peak, torch.cuda.max_memory_allocated(self.dev) - self.base)
        return self.out


def event_stats(fn, n: int) -> dict:
    """ms of each of n calls of fn queued back to back, one CUDA-event pair
    around each, one synchronize at the end: n, median, p90, min, max."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(n)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    t = np.array([start.elapsed_time(end) for start, end in pairs])
    return {"n": n, "median_ms": float(np.median(t)), "p90_ms": float(np.percentile(t, 90)),
            "min_ms": float(t.min()), "max_ms": float(t.max())}


def section_640(dev, sizes: Sizes = SIZES["640"], seed: int = SEEDS["640"]) -> dict:
    """bench.py:60-133: extract a batch of shifted frames, match its
    consecutive pairs; chip_smoke.py's phase-4 gates."""
    sec = Section("640", dev, sizes.reps > 0)
    cfg = SiftConfig(height=sizes.h, width=sizes.w, max_keypoints=sizes.k)
    mcfg = MatchConfig(max_sift=sizes.k, max_match=sizes.k)
    frames = make_frames(sizes.h, sizes.w, sizes.b, seed)
    images = torch.from_numpy(frames).to(dev)

    def extract():
        return extract_features_jit(images, cfg)

    def match(f):
        return match_sliced_jit(f.desc, f.mask, mcfg)

    def iteration():
        f = extract()
        return f, match(f)

    feats, res = sec.first_call(iteration)
    main_path_gates(frames, feats, res, cfg)
    kp, matches = feats.count.cpu().tolist(), res.count.cpu().tolist()
    sec.out.update(kp_per_frame=kp, matches_per_pair=matches)
    if sec.timed:
        reps_ex, reps_match = [], []
        for _ in range(sizes.reps):
            t0 = time.perf_counter()
            all_feats = [extract() for _ in range(sizes.iters)]
            sec.sync()
            t1 = time.perf_counter()
            all_rs = [match(f) for f in all_feats]
            sec.sync()
            reps_ex.append((t1 - t0) / sizes.iters)
            reps_match.append((time.perf_counter() - t1) / sizes.iters)
            del all_feats, all_rs
        sec.out["reps_s"] = {"extract": reps_ex, "match": reps_match}
        sec.out["events"] = {"extract": event_stats(extract, sizes.events),
                             "match": event_stats(lambda: match(feats), sizes.events)}
        t_ex, t_match = min(reps_ex), min(reps_match)
        say(f"{sizes.h}x{sizes.w}: extract {t_ex * 1e3:.1f} ms/iter ({sizes.b} frames), "
            f"match {t_match * 1e3:.1f} ms/iter ({sizes.b - 1} pairs), "
            f"{sizes.b / (t_ex + t_match):.1f} frames/s, {sum(kp)} kp/iter, "
            f"{sum(matches)} matches/iter "
            f"[reps ex {['%.1f' % (v * 1e3) for v in reps_ex]} "
            f"match {['%.1f' % (v * 1e3) for v in reps_match]}]")
    say(f"{sizes.h}x{sizes.w}: keypoints per frame {kp}, matches per pair {matches}")
    return sec.finish()


def _frame_section(name: str, dev, sizes: Sizes, seed: int) -> dict:
    """bench.py:136-189: one frame's extraction, replayed.  Gates: the K cap
    binds, an eager call's calls of kernels 1-3 and the octave kernel hold
    against their plain versions, two replays equal that eager call bit for
    bit, and the frame through the port on the CPU pairs with the card's."""
    sec = Section(name, dev, sizes.reps > 0)
    cfg = SiftConfig(height=sizes.h, width=sizes.w, max_keypoints=sizes.k)
    frame = spatial_frame(sizes.h, sizes.w, seed)
    image = torch.from_numpy(frame).to(dev)

    def extract():
        return extract_features_jit(image, cfg)

    feats = sec.first_call(extract)
    kp = int(feats.count[0])
    if kp != sizes.k:
        raise AssertionError(f"{name}: {kp} keypoints, the cap {sizes.k} does not bind")
    calls, restore = kernel_calls(octave=True)
    try:
        eager = extract_features(image, cfg)
    finally:
        restore()
    again = extract()
    for label, f in (("the first replay", feats), ("a second replay", again)):
        if not all(torch_equal_bits(a, b) for a, b in zip(f, eager)):
            raise AssertionError(f"{name}: {label} is not bit-identical to an eager call")
    with sec.unmeasured():
        t0 = time.perf_counter()
        sec.out["max_abs_err"] = hold_calls(calls, cfg, sec.sync, f"{name} frame")
        say(f"{name}: {sum(map(len, calls.values()))} calls of kernels 1-3 and 6 against "
            f"their plain versions, max abs err {sec.out['max_abs_err']} "
            f"({time.perf_counter() - t0:.1f} s)")
        del calls, eager, again
    cpu_pairing_gate(frame, feats, cfg, f"the {sizes.h}x{sizes.w} frame")
    sec.out["kp"] = kp
    if sec.timed:
        reps = sec.queued(extract, sizes)
        sec.out["reps_s"] = {"extract": reps}
        sec.out["events"] = {"extract": event_stats(extract, sizes.events)}
        say(f"{name}: {min(reps) * 1e3:.1f} ms/frame, {1 / min(reps):.1f} fps, {kp} kp "
            f"[reps {['%.2f' % (v * 1e3) for v in reps]}]")
    return sec.finish()


def section_1080p(dev, sizes: Sizes = SIZES["1080p"], seed: int = SEEDS["1080p"]) -> dict:
    return _frame_section("1080p", dev, sizes, seed)


def section_4k(dev, sizes: Sizes = SIZES["4k"], seed: int = SEEDS["4k"]) -> dict:
    return _frame_section("4k", dev, sizes, seed)


def permutation_gate(res, perm) -> int:
    """>= 99% of a known permutation (d1k = d0[perm]) recovered by `res`;
    returns the pairs on it."""
    n = len(perm)
    true = on_permutation(res, torch.argsort(perm).to(torch.int64))
    if true < 0.99 * n:
        raise AssertionError(f"16k: {true} of {n} permuted pairs recovered")
    return true


def section_16k(dev, sizes: Sizes = SIZES["16k"], seed: int = SEEDS["16k"]) -> dict:
    """bench.py:194-228: brute-force matching of two random uint8 sets, gated
    first on a known permutation of the first set."""
    sec = Section("16k", dev, sizes.reps > 0)
    n = sizes.k
    d0, d1, d1k, perm, _, _ = (torch.from_numpy(a).to(dev) for a in large_sets(n, seed))
    mcfg = MatchConfig(max_sift=n, max_match=n)
    res = sec.first_call(lambda: match_descriptors_jit(d0, d1, cfg=mcfg))
    true = permutation_gate(match_descriptors_jit(d0, d1k, cfg=mcfg), perm)
    sec.out.update(matches=int(res.count), permutation_recovered=true)
    say(f"16k: the known permutation: {true} of {n} recovered; the random sets: "
        f"{int(res.count)} matches")
    if sec.timed:
        reps = sec.queued(lambda: match_descriptors_jit(d0, d1, cfg=mcfg), sizes)
        sec.out["reps_s"] = {"match": reps}
        sec.out["events"] = {"match": event_stats(
            lambda: match_descriptors_jit(d0, d1, cfg=mcfg), sizes.events)}
        say(f"16k x 16k match (kernel 4, no streaming): {min(reps) * 1e3:.2f} ms/pair "
            f"[reps {['%.3f' % (v * 1e3) for v in reps]}]")
    return sec.finish()


def section_stages(dev, sizes: Sizes = SIZES["stages"], seed: int = SEEDS["stages"]) -> dict:
    """bench.py:230-244: the per-stage table on the 640 section's frames."""
    sec = Section("stages", dev, sizes.reps > 0)
    cfg = SiftConfig(height=sizes.h, width=sizes.w, max_keypoints=sizes.k)
    mcfg = MatchConfig(max_sift=sizes.k, max_match=sizes.k)
    images = torch.from_numpy(make_frames(sizes.h, sizes.w, sizes.b, seed)).to(dev)
    times = sec.first_call(lambda: profile_extraction(images, cfg, iters=sizes.iters, mcfg=mcfg))
    sec.out["stages_s"] = times if sec.timed else None
    if sec.timed:
        say(f"stage table ({sizes.h}x{sizes.w} b{sizes.b}, ms/iter): "
            + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in times.items()))
    return sec.finish()


SECTION_FNS = {"640": section_640, "1080p": section_1080p, "4k": section_4k,
               "16k": section_16k, "stages": section_stages}


def _best_ms(results: dict, name: str, label: str):
    reps = (results.get(name) or {}).get("reps_s")
    return None if reps is None else round(min(reps[label]) * 1e3, 2)


def bench_line(results: dict, device=None, seed: int = 0) -> dict:
    """bench.py's JSON line from the sections' results (a section not run,
    or run where nothing is timed, leaves its keys null), then the card
    (`device`), the seed offset and every section's own record."""
    s640 = results.get("640") or {}
    value = None
    if s640.get("reps_s"):
        t = min(s640["reps_s"]["extract"]) + min(s640["reps_s"]["match"])
        value = (sum(s640["kp_per_frame"]) + sum(s640["matches_per_pair"])) / t
    stages = (results.get("stages") or {}).get("stages_s")
    rounded = lambda xs: [round(v * 1e3, 2) for v in xs]
    return {
        "metric": "keypoints+matches/s per chip",
        "value": None if value is None else round(value, 1),
        "unit": "items/s",
        "vs_baseline": None if value is None else round(value / 60000.0, 3),
        "extract_640_ms": _best_ms(results, "640", "extract"),
        "match_640_ms": _best_ms(results, "640", "match"),
        "reps_640_ms": rounded(s640["reps_s"]["extract"]) if s640.get("reps_s") else None,
        "reps_match_ms": rounded(s640["reps_s"]["match"]) if s640.get("reps_s") else None,
        "ms_1080p": _best_ms(results, "1080p", "extract"),
        "ms_4k": _best_ms(results, "4k", "extract"),
        "ms_match16k_stream": _best_ms(results, "16k", "match"),
        "stages_640_ms": None if stages is None else {k: round(v * 1e3, 2)
                                                      for k, v in stages.items()},
        "device": device,
        "seed": seed,
        "sections": results,
    }


def card() -> dict:
    name, limit = (s.strip() for s in card_line().split(",", 1))
    return {"name": name, "power_limit": limit, "count": torch.cuda.device_count()}


def run(device: str = "cuda", seed: int = 0, only=SECTIONS, sizes=SIZES) -> dict:
    """The sections named in `only`, in bench.py's order, on `device`; each
    section's seed is its bench.py seed plus `seed`, and `BENCH`'s captures
    are released after it.  Returns bench_line."""
    dev = torch.device(device)
    results = {}
    for name in SECTIONS:
        if name in only:
            try:
                results[name] = SECTION_FNS[name](dev, sizes[name], SEEDS[name] + seed)
            finally:   # no section's pool outlives it
                BENCH.release()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    return bench_line(results, card() if dev.type == "cuda" else None, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="added to each section's seed (0: bench.py's data)")
    ap.add_argument("--only", nargs="+", choices=SECTIONS, default=list(SECTIONS),
                    metavar="SECTION", help=f"run only these of {', '.join(SECTIONS)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is False); its times "
              "are the card's only", file=sys.stderr)
        return 1
    # importing the ops modules registers their kernels in _build.KERNELS
    from siftgpu_tpu_torch.ops import (desc_sampler, detect_scores, grad_stencil,  # noqa: F401
                                       kp_engine, match_kernel, pyramid_kernel)

    say(f"device: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    say(f"kernels built in {time.perf_counter() - t0:.1f}s")
    with contextlib.redirect_stdout(sys.stderr):   # the gates' log lines
        line = run("cuda", args.seed, args.only)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
