#!/usr/bin/env python3
"""Time the port's redesigned kernels against another checkout's, on one GPU.

    python3 compare_kernels.py --baseline DIR [--small-eig-only] [--boot BOOT]

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with `git archive` into a directory that
.gitignore lists).  The script loads that checkout's `detect_scores`,
`match_best2`, `grad_stencil`, `sample_gradients` and `small_eig` wrappers
and CUDA sources beside this checkout's, builds both, and on the main path's inputs
(4 x 480x640 frames, K = 2048: the 5 octaves' DoG and Gaussian volumes, the 3
consecutive pairs), the facade's 3 guided calls (4096-padded sets, gates H,
F, H+F) and its descriptor-only call (`describe_at_keypoints` at frame 0's
own keypoints) it:

  1. checks that both give the same outputs bit for bit;
  2. times each call by device time (torch.profiler, the sum of the CUDA
     kernels' own time, mean of 5 rounds) in the order baseline, this,
     this, baseline, with each call's bound (`siftgpu_tpu_torch/bounds.py`);
     the descriptor-only call's samplers as each checkout calls them (the
     baseline's per octave and 512-keypoint chunk, this one's once per
     octave), by device time and by CUDA events, and the whole call
     (the baseline's `frontend/redetect.py`, `describe.py` and `orient.py`
     on its own kernels) by host clock, synchronised, and device time;
  3. runs each checkout's `optim/ba.py::run_ba` on the problem that
     `two_view_reconstruct` builds for chip_smoke.py's phase-4c pair:
     host ms (synchronised; the median of 8 rounds, the order alternating),
     device ms and kernel launches per call, and its synchronising calls
     (torch's sync debug mode);
  4. times the host cost of one launch through each checkout's
     `ops/_build.py::Kernel.launch`: a host clock over 2,000 launches of the
     `grad_stencil` kernel on a 1 x 4 x 8 x 8 volume, synchronised once at
     the end, in the order baseline, this, this, baseline;
  5. runs each checkout's `small_eig` on the calls `two_view_reconstruct`
     makes on chip_smoke.py's phase-4c pair (recorded with this checkout's
     kernel) and on the bootstrap normal matrices that `ransac_witness.py
     record` saved as BOOT/boot_<seed>.pt: per call the f32 outputs that are
     bit-identical, the largest difference among the rest (the eigh of n =
     3, 4 and the SVD must be identical throughout), and device ms in the
     order baseline, this, this, baseline.

`--small-eig-only` runs item 5 alone.

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

from chip_smoke import (H, K, RVEC, SHIFT, T_GT, W, card_line, device_ms, make_frames, recording,
                        sync_warnings, time_ms, torch_equal_bits)
from siftgpu_tpu_torch import MatchConfig, SiftConfig, bounds, extract_features
from siftgpu_tpu_torch.frontend import describe, pyramid, redetect
from siftgpu_tpu_torch.frontend import match as fmatch
from siftgpu_tpu_torch.ops import _build, desc_sampler, detect_scores, grad_stencil, match_kernel
from siftgpu_tpu_torch.optim import ba
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


def baseline_module(root: Path, sub: str, module: str):
    """The baseline checkout's `<sub>/<module>.py`, loaded beside this
    one's; its relative imports resolve to this checkout's package."""
    return load_module(f"siftgpu_tpu_torch.{sub}._baseline_{module}",
                       root / "siftgpu_tpu_torch" / sub / f"{module}.py", f"siftgpu_tpu_torch.{sub}")


def baseline_wrapper(root: Path, module: str):
    """The baseline checkout's `ops/<module>.py`, loaded beside this one's,
    its kernels rebound to the baseline's CUDA source (this checkout's
    kernel registry is left as it was)."""
    saved = dict(_build.KERNELS)
    mod = baseline_module(root, "ops", module)
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
    keys = torch.from_numpy(locs[0][None]).to(device)
    Hm = np.array([[1, 0, SHIFT[0]], [0, 1, SHIFT[1]], [0, 0, 1]], np.float32)
    F = np.array([[0, 0, SHIFT[1]], [0, 0, -SHIFT[0]], [-SHIFT[1], SHIFT[0], 0]], np.float32)
    gated = []
    with recording(fmatch, "match_best2_gated", gated):
        for kw in (dict(H=Hm, hdistmax=3.0), dict(F=F, fdistmax=2.0),
                   dict(H=Hm, F=F, hdistmax=3.0, fdistmax=2.0)):
            matcher.get_guided_sift_match(**kw)
    return cfg, pyr, match, gated, (images[:1], keys)


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


def profiled(fn, sync, iters=3):
    """(device ms, kernel launches) per call of fn, by torch.profiler."""
    fn()
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        sync()
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / 1e3 / iters,
            sum(e.count for e in kern) / iters)


def host_ms(fn, sync, n=5):
    """Host-clock ms per call of fn, each call synchronised, after a warm-up."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        sync()
    return (time.perf_counter() - t0) * 1e3 / n


def baseline_descriptor_only(root: Path, old_gs, old_ds):
    """The baseline's descriptor-only stack on its own kernels: its
    redetect, describe and orient modules, their kernel wrappers rebound to
    the baseline's."""
    old_orient = baseline_module(root, "frontend", "orient")
    old_orient.grad_stencil = old_gs.grad_stencil
    old_describe = baseline_module(root, "frontend", "describe")
    old_describe.sample_gradients = old_ds.sample_gradients
    old_redetect = baseline_module(root, "frontend", "redetect")
    old_redetect.orient, old_redetect.describe = old_orient, old_describe
    return old_redetect, old_describe


def descriptor_only(old_redetect, old_describe, old_ds, cfg, images, keys, sync):
    """The descriptor-only call, baseline against this checkout: the same
    descriptors; the samplers' device and events ms, as each calls them; the
    whole call's host and device ms."""
    old_calls, new_calls = [], []
    with recording(old_describe, "sample_gradients", old_calls):
        old = old_redetect.describe_at_keypoints(images, keys, cfg)
    with recording(describe, "sample_gradients", new_calls):
        new = redetect.describe_at_keypoints(images, keys, cfg)
    sync()
    if not (torch.equal(old.desc, new.desc) and torch.equal(old.mask, new.mask)):
        raise AssertionError("descriptor-only: the two checkouts' descriptors differ")
    bufs = [tuple(b.clone() for b in a[5]) for a in new_calls]
    old_fns = [lambda a=a: old_ds.sample_gradients(*a) for a in old_calls]
    new_fns = [lambda a=a, b=b: desc_sampler.sample_gradients(*a[:5], b)
               for a, b in zip(new_calls, bufs)]
    dev = [device_ms(fns, sync, 5) for fns in (old_fns, new_fns, new_fns, old_fns)]
    ev = [time_ms(lambda fns=fns: [f() for f in fns], sync, 20)
          for fns in (old_fns, new_fns, new_fns, old_fns)]
    works = lambda calls: [bounds.sample_gradients_work(*a[0].shape, *a[3].shape,
                                                        sampled=int((a[2] >= 0).sum()))
                           for a in calls]
    b_old, b_new = bounds.bound(works(old_calls))[0], bounds.bound(works(new_calls))[0]
    old_call = lambda: old_redetect.describe_at_keypoints(images, keys, cfg)
    new_call = lambda: redetect.describe_at_keypoints(images, keys, cfg)
    whole = [host_ms(fn, sync, 10) for fn in (old_call, new_call, new_call, old_call)]
    whole_dev = [profiled(fn, sync) for fn in (old_call, new_call, new_call, old_call)]
    log(f"  samplers: {len(old_calls)} calls ({sum(int(a[3].shape[0]) for a in old_calls)} rows "
        f"sampled) / {len(new_calls)} calls "
        f"({sum(int((a[2] >= 0).sum()) for a in new_calls)} rows sampled); device ms baseline "
        f"{dev[0]:.4f} / this {dev[1]:.4f} / this {dev[2]:.4f} / baseline {dev[3]:.4f}; events ms "
        f"{ev[0]:.4f} / {ev[1]:.4f} / {ev[2]:.4f} / {ev[3]:.4f}; bound {b_old:.4f} / {b_new:.4f} ms")
    log(f"  describe_at_keypoints ({int(new.mask.sum())} keypoints): host ms "
        + " / ".join(f"{t:.3f}" for t in whole) + "; device ms, launches "
        + " / ".join(f"{d:.4f}, {n:.0f}" for d, n in whole_dev))
    return {"calls": [len(old_calls), len(new_calls)], "sampler_device_ms": dev,
            "sampler_events_ms": ev, "sampler_bound_ms": [b_old, b_new],
            "call_host_ms": whole, "call_device_ms": [d for d, _ in whole_dev],
            "call_launches": [n for _, n in whole_dev]}


def bundle_adjustment(root: Path, sync):
    """run_ba of each checkout on the problem two_view_reconstruct builds
    for chip_smoke.py's phase-4c pair (480x640, K = 2048)."""
    from siftgpu_tpu_torch.oracle import fixtures
    from siftgpu_tpu_torch.pipeline import twoview

    f = 180.0 * W / 200.0
    intr = (f, f, W / 2.0, H / 2.0)
    img0, img1, _ = fixtures.two_plane_stereo(H, W, intr, RVEC, T_GT, d_near=5.0, d_far=10.0,
                                              seed=2)
    images = torch.from_numpy(np.stack([img0, img1])).cuda()
    intr_t = torch.tensor(intr, dtype=torch.float32, device="cuda")
    problems = []
    with recording(ba, "run_ba", problems):
        twoview.two_view_reconstruct(images, intr_t, SiftConfig(height=H, width=W, max_keypoints=K),
                                     MatchConfig(max_sift=K, max_match=K),
                                     torch.Generator(device="cuda").manual_seed(7))
    args = problems[0]
    old_ba = baseline_module(root, "optim", "ba")
    old, new = (lambda: old_ba.run_ba(*args)), (lambda: ba.run_ba(*args))
    a, b, c = old(), new(), new()
    sync()
    if not all(torch_equal_bits(x, y) for x, y in zip(b, c)):
        raise AssertionError("run_ba: two runs on the card differ")
    ms = ([], [])   # 8 rounds of 2 calls each, the order alternating
    for i in range(8):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            ms[j].append(host_ms((old, new)[j], sync, 2))
    med = [float(np.median(m)) for m in ms]
    dev = [profiled(fn, sync) for fn in (old, new, new, old)]
    syncs = [sync_warnings(fn) for fn in (old, new)]
    log(f"  run_ba (M = {args[0].cams.shape[0]}, P = {args[0].points.shape[0]}, N = "
        f"{args[0].cam_idx.shape[0]}): cost baseline {float(a.cost):.6g}, this {float(b.cost):.6g} "
        f"(this checkout's two runs bit-identical); host ms median baseline {med[0]:.3f} / this "
        f"{med[1]:.3f} (rounds {[round(t, 1) for t in ms[0]]} / {[round(t, 1) for t in ms[1]]}); "
        "device ms, launches " + " / ".join(f"{d:.3f}, {n:.0f}" for d, n in dev)
        + f"; synchronising calls baseline {syncs[0]} / this {syncs[1]}")
    return {"host_ms": ms, "host_ms_median": med, "device_ms": [d for d, _ in dev],
            "launches": [n for _, n in dev], "cost": [float(a.cost), float(b.cost)],
            "sync_warnings": syncs}


def small_eig_designs(root: Path, sync, boot: Path | None, dev: str = "cuda"):
    """small_eig, the baseline's design against this checkout's (item 5;
    `dev` "cpu" only to rehearse the control flow: both routes torch.linalg)."""
    from chip_smoke import stereo_pair
    from siftgpu_tpu_torch.ops import small_eig
    from siftgpu_tpu_torch.pipeline import twoview

    old = baseline_wrapper(root, "small_eig")
    if dev == "cuda":
        old.KERNEL.lib()
    images, intr_t, _ = stereo_pair(torch.device(dev))
    eighs, svds = [], []
    with recording(small_eig, "eigh_sym", eighs), recording(small_eig, "svd3", svds):
        twoview.two_view_reconstruct(images, intr_t, SiftConfig(height=H, width=W, max_keypoints=K),
                                     MatchConfig(max_sift=K, max_match=K),
                                     torch.Generator(device=dev).manual_seed(7))
    calls = ([(a[0], "eigh", "two-view") for a in eighs]
             + [(a[0], "svd3", "two-view") for a in svds])
    for path in sorted(boot.glob("boot_*.pt")) if boot else []:
        calls.append((torch.load(path)["M"].to(dev), "eigh", f"bootstrap {path.stem}"))
    rows = []
    for x, kind, label in calls:
        fo, fn = (old.eigh_sym, small_eig.eigh_sym) if kind == "eigh" else (old.svd3,
                                                                              small_eig.svd3)
        a, b = fo(x), fn(x)
        sync()
        same = [int((p.view(torch.int32) == q.view(torch.int32)).sum()) for p, q in zip(a, b)]
        size = [p.numel() for p in a]
        diff = max(float((p - q).abs().max()) for p, q in zip(a, b))
        if x.shape[-1] != 9 and same != size:
            raise AssertionError(f"small_eig {kind} {tuple(x.shape)}: the designs differ")
        t = [device_ms([lambda f=f: f(x)], sync, 5) for f in (fo, fn, fn, fo)]
        log(f"  small_eig {kind} ({label}, {tuple(x.shape)}): identical "
            + ", ".join(f"{s_}/{n_}" for s_, n_ in zip(same, size))
            + f" (largest difference {diff:.3g}); device ms baseline {t[0]:.4f} / this "
            f"{t[1]:.4f} / this {t[2]:.4f} / baseline {t[3]:.4f}")
        rows.append({"call": label, "kind": kind, "shape": list(x.shape), "identical": same,
                     "entries": size, "max_diff": diff, "device_ms": t})
    nine = [r for r in rows if r["kind"] == "eigh" and r["shape"][-1] == 9]
    same, size = (sum(sum(r[k]) for r in nine) for k in ("identical", "entries"))
    log(f"  n = 9: {same} of {size} f32 outputs bit-identical to the baseline's "
        f"({100.0 * same / max(size, 1):.4f}%)")
    return {"calls": rows, "n9_identical": same, "n9_entries": size}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--small-eig-only", action="store_true", help="run item 5 alone")
    ap.add_argument("--boot", type=Path, default=None,
                    help="directory of ransac_witness.py record's boot_<seed>.pt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    root = args.baseline.resolve()
    sync = torch.cuda.synchronize
    log(card_line())
    if args.small_eig_only:
        _build.build_all()
        log("small_eig, the baseline's design against this one's")
        out = {"card": card_line(), "small_eig": small_eig_designs(root, sync, args.boot)}
        print(json.dumps(out))
        return 0
    old_ds = baseline_wrapper(root, "detect_scores")
    old_mk = baseline_wrapper(root, "match_kernel")
    old_gs = baseline_wrapper(root, "grad_stencil")
    old_sm = baseline_wrapper(root, "desc_sampler")
    for kern in (old_ds.KERNEL, old_mk.KERNEL, old_mk.GATED, old_gs.KERNEL, old_sm.KERNEL):
        kern.lib()
    _build.build_all()
    cfg, pyr, match, gated, (img0, keys) = main_inputs("cuda")
    dogs = [oc.dog for oc in pyr]
    sync()
    out = {"card": card_line(), "detect_scores": [], "match_best2": [], "match_best2_gated": [],
           "grad_stencil": []}

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
    log("grad_stencil, per octave of the main path")
    win = 2 * cfg.orient_window_radius + 1
    S = cfg.dog_levels
    for o, oc in enumerate(pyr):
        B, _, Hg, Wg = oc.gauss.shape
        out["grad_stencil"].append(compare(
            f"octave {o} {tuple(oc.gauss.shape)}",
            (lambda g=oc.gauss: old_gs.grad_stencil(g, S, win, win),
             lambda g=oc.gauss: grad_stencil.grad_stencil(g, S, win, win)),
            bounds.grad_stencil_work(B, S, Hg, Wg, max(Hg, win), max(Wg, win)), sync))
    log("descriptor-only mode (frame 0's own keypoints)")
    old_redetect, old_describe = baseline_descriptor_only(root, old_gs, old_sm)
    out["descriptor_only"] = descriptor_only(old_redetect, old_describe, old_sm, cfg, img0, keys,
                                             sync)
    log("bundle adjustment (two-view, 10 LM x 30 CG)")
    out["run_ba"] = bundle_adjustment(root, sync)
    for name in ("detect_scores", "match_best2", "match_best2_gated", "grad_stencil"):
        t = np.array([r["device_ms"] for r in out[name]]).sum(0)
        out[name + "_sum"] = t.tolist()
        log(f"  {name}, summed over the path's calls: baseline {t[0]:.4f} / this {t[1]:.4f} / "
            f"this {t[2]:.4f} / baseline {t[3]:.4f} ms")

    log("small_eig, the baseline's design against this one's")
    out["small_eig"] = small_eig_designs(root, sync, args.boot)

    log("host cost of one launch (grad_stencil on 1 x 4 x 8 x 8)")
    old_build = load_module("_baseline_build", root / "siftgpu_tpu_torch" / "ops" / "_build.py")
    entry = grad_stencil.KERNEL.entry
    kern_old = old_build.Kernel("grad_stencil (baseline launch)", "grad_stencil.cu", entry)
    kern_old.source = grad_stencil.KERNEL.source
    kern_new = _build.Kernel("grad_stencil (this launch)", "grad_stencil.cu", entry)
    _build.KERNELS.pop(kern_new.name)
    g = torch.rand((1, 4, 8, 8), device="cuda")
    o = torch.empty((2, 1, 3, 8, 8), dtype=torch.bfloat16, device="cuda")
    largs = (g, o[0], o[1], 1, 4, 3, 8, 8, 8, 8, *grad_stencil.factor_rows())
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
