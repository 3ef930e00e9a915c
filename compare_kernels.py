#!/usr/bin/env python3
"""Time the port's redesigned kernels against another checkout's, on one GPU.

    python3 compare_kernels.py --baseline DIR

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with `git archive` into a directory that
.gitignore lists).  The script loads that checkout's `detect_scores` and
`match_best2` wrappers and CUDA sources beside this checkout's, builds both,
and on the main path's inputs (4 x 480x640 frames, K = 2048: the 5 octaves'
DoG volumes, the 3 consecutive pairs) and the facade's 3 guided calls
(4096-padded sets, gates H, F, H+F) it:

  1. checks that both give the same outputs bit for bit;
  2. times each call by device time (torch.profiler, the sum of the CUDA
     kernels' own time, mean of 5 rounds) in the order baseline, this,
     this, baseline, with each call's bound (`siftgpu_tpu_torch/bounds.py`);
  3. times the host cost of one launch through each checkout's
     `ops/_build.py::Kernel.launch`: a host clock over 2,000 launches of the
     `grad_stencil` kernel on a 1 x 4 x 8 x 8 volume, synchronised once at
     the end, in the order baseline, this, this, baseline.

Prints one JSON line with every number as its last line.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import K, SHIFT, card_line, device_ms, make_frames, recording, torch_equal_bits
from siftgpu_tpu_torch import MatchConfig, SiftConfig, bounds, extract_features
from siftgpu_tpu_torch.frontend import match as fmatch
from siftgpu_tpu_torch.frontend import pyramid
from siftgpu_tpu_torch.ops import _build, detect_scores, grad_stencil, match_kernel
from siftgpu_tpu_torch.pipeline.api import SiftMatchTPU, SiftTPU


def log(msg: str) -> None:
    print(msg, flush=True)


def load_module(name: str, path: Path, package: str | None = None):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    if package:
        mod.__package__ = package
    spec.loader.exec_module(mod)
    return mod


def baseline_wrapper(root: Path, module: str):
    """The baseline checkout's `ops/<module>.py`, loaded beside this one's:
    its relative imports resolve to this checkout's package, and its
    kernels are rebound to the baseline's CUDA source (this checkout's
    kernel registry is left as it was)."""
    saved = dict(_build.KERNELS)
    mod = load_module(f"siftgpu_tpu_torch.ops._baseline_{module}",
                      root / "siftgpu_tpu_torch" / "ops" / f"{module}.py", "siftgpu_tpu_torch.ops")
    for v in vars(mod).values():
        if isinstance(v, _build.Kernel):
            v.source = root / "siftgpu_tpu_torch" / "csrc" / v.source.name
            v.name = f"baseline {v.name}"
    _build.KERNELS.clear()
    _build.KERNELS.update(saved)
    return mod


def main_inputs(device):
    """The 5 octaves' DoG volumes and the 3 pairs' descriptor sets of the
    main path, and the 3 guided calls of the facade path."""
    frames = make_frames()
    images = torch.from_numpy(frames).to(device)
    cfg = SiftConfig(height=frames.shape[1], width=frames.shape[2], max_keypoints=K)
    pyr = pyramid.build_pyramid(images, cfg)
    feats = extract_features(images, cfg)
    d0, d1 = feats.desc[:-1].contiguous(), feats.desc[1:].contiguous()
    m0, m1 = feats.mask[:-1].contiguous(), feats.mask[1:].contiguous()
    match = (d0, d1, match_kernel.recip_norms(d0), match_kernel.recip_norms(d1), m0, m1)

    sift = SiftTPU(device=device, max_keypoints=K)
    locs, descs = [], []
    for f in frames[:2]:
        sift.run_sift(f)
        k, d = sift.get_feature_vector()
        locs.append(k)
        descs.append(d)
    matcher = SiftMatchTPU(max_sift=4096, device=device)
    for i in range(2):
        matcher.set_descriptors(i, descs[i])
        matcher.set_feature_location(i, locs[i])
    Hm = np.array([[1, 0, SHIFT[0]], [0, 1, SHIFT[1]], [0, 0, 1]], np.float32)
    F = np.array([[0, 0, SHIFT[1]], [0, 0, -SHIFT[0]], [-SHIFT[1], SHIFT[0], 0]], np.float32)
    gated = []
    with recording(fmatch, "match_best2_gated", gated):
        for kw in (dict(H=Hm, hdistmax=3.0), dict(F=F, fdistmax=2.0),
                   dict(H=Hm, F=F, hdistmax=3.0, fdistmax=2.0)):
            matcher.get_guided_sift_match(**kw)
    return cfg, [oc.dog for oc in pyr], match, gated


def same(a, b) -> bool:
    return all(torch_equal_bits(x, y) for x, y in zip(a, b))


def compare(label, calls, work, sync):
    """calls: (baseline fn, this fn) of one kernel call.  Checks both give
    the same outputs, then device ms, baseline / this / this / baseline."""
    old, new = calls
    if not same(old(), new()):
        raise AssertionError(f"{label}: the two checkouts' outputs differ")
    t = [device_ms([fn], sync, 5) for fn in (old, new, new, old)]
    b = bounds.bound([work])[0]
    log(f"  {label}: device ms baseline {t[0]:.4f} / this {t[1]:.4f} / this {t[2]:.4f} / "
        f"baseline {t[3]:.4f}; bound {b:.4f} ms")
    return {"call": label, "device_ms": t, "bound_ms": b}


def host_us(kern, fn_name, args, ptr, sync, n=2000):
    """Host microseconds per `kern.launch` over n launches, synchronised once."""
    kern.launch(fn_name, torch.device("cuda"), *(ptr(a) if isinstance(a, torch.Tensor) else a
                                                 for a in args))
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        kern.launch(fn_name, torch.device("cuda"), *(ptr(a) if isinstance(a, torch.Tensor) else a
                                                     for a in args))
    sync()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout to compare against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    root = args.baseline.resolve()
    sync = torch.cuda.synchronize
    log(card_line())
    old_ds = baseline_wrapper(root, "detect_scores")
    old_mk = baseline_wrapper(root, "match_kernel")
    for kern in (old_ds.KERNEL, old_mk.KERNEL, old_mk.GATED, detect_scores.KERNEL,
                 match_kernel.KERNEL, match_kernel.GATED):
        kern.lib()
    cfg, dogs, match, gated = main_inputs("cuda")
    sync()
    out = {"card": card_line(), "detect_scores": [], "match_best2": [], "match_best2_gated": []}

    log("detect_scores, per octave of the main path")
    for o, dog in enumerate(dogs):
        B, L, Hd, Wd = dog.shape
        out["detect_scores"].append(compare(
            f"octave {o} {tuple(dog.shape)}",
            (lambda d=dog: old_ds.detect_scores(d, cfg), lambda d=dog: detect_scores.detect_scores(d, cfg)),
            bounds.detect_scores_work(B, L - 2, Hd, Wd), sync))
    log("match_best2, the main path's call (3 pairs)")
    out["match_best2"].append(compare(
        f"{tuple(match[0].shape)} x {tuple(match[1].shape)}",
        (lambda: old_mk.match_best2(*match), lambda: match_kernel.match_best2(*match)),
        bounds.match_best2_work(*match[0].shape[:2], match[1].shape[1]), sync))
    log("match_best2_gated, the facade's guided calls")
    for a in gated:
        out["match_best2_gated"].append(compare(
            f"gate {a[6]!r} {tuple(a[0].shape)} x {tuple(a[1].shape)}",
            (lambda a=a: old_mk.match_best2_gated(*a), lambda a=a: match_kernel.match_best2_gated(*a)),
            bounds.match_best2_work(*a[0].shape[:2], a[1].shape[1], gate=a[6]), sync))
    for name in ("detect_scores", "match_best2", "match_best2_gated"):
        t = np.array([r["device_ms"] for r in out[name]]).sum(0)
        out[name + "_sum"] = t.tolist()
        log(f"  {name}, summed over the path's calls: baseline {t[0]:.4f} / this {t[1]:.4f} / "
            f"this {t[2]:.4f} / baseline {t[3]:.4f} ms")

    log("host cost of one launch (grad_stencil on 1 x 4 x 8 x 8)")
    old_build = load_module("_baseline_build", root / "siftgpu_tpu_torch" / "ops" / "_build.py")
    entry = grad_stencil.KERNEL.entry
    kern_old = old_build.Kernel("grad_stencil (baseline launch)", "grad_stencil.cu", entry)
    kern_old.source = grad_stencil.KERNEL.source
    kern_new = _build.Kernel("grad_stencil (this launch)", "grad_stencil.cu", entry)
    _build.KERNELS.pop(kern_new.name)
    g = torch.rand((1, 4, 8, 8), device="cuda")
    o = torch.empty((2, 1, 3, 8, 8), dtype=torch.bfloat16, device="cuda")
    largs = (g, o[0], o[1], 1, 4, 3, 8, 8, 8, 8)
    us = [host_us(k, "grad_stencil_launch", largs, p, sync)
          for k, p in ((kern_old, old_build.ptr), (kern_new, _build.ptr),
                       (kern_new, _build.ptr), (kern_old, old_build.ptr))]
    out["launch_host_us"] = us
    log(f"  host us per launch: baseline {us[0]:.2f} / this {us[1]:.2f} / this {us[2]:.2f} / "
        f"baseline {us[3]:.2f}")
    log(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
