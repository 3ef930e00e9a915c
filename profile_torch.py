#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main, two-view and SLAM paths
goes, on one GPU.

    python3 profile_torch.py

Same workloads as chip_smoke.py (4 x 480x640 frames, K = 2048, 3 pairs; the
two-plane stereo pair of its phase 4c; the loop scene of its phase 4d).
Prints:
  1. host-clock stage times (each stage ends in torch.cuda.synchronize());
  2. a torch.profiler table of device time by kernel over 5 extract + match
     iterations, and the device busy share of that window; the same for
     `two_view_reconstruct` and for its bundle adjustment alone;
  2b. the SLAM loop (`run_slam` on the 24-frame loop scene): host seconds
     and frames/s, the device busy share, and kernel launches by stage
     (each launch counted in the innermost stage around it), per tracked
     frame and per keyframe;
  3. the FMA probes: the detect_scores and sample_gradients kernels built
     WITHOUT -fmad=false, against their plain versions — how many values
     change when nvcc contracts multiply-adds;
  4. the TF32 probe: the guided H-gate operands of frames 0 and 1 formed by a
     [N, 3] x [3, 3] matmul with TF32 allowed, against the elementwise f32
     operands the port uses — how far they move and how many gate decisions
     (3 px) flip.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from chip_smoke import H, K, RVEC, SHIFT, T_GT, W, card_line, make_frames, recording
from siftgpu_tpu_torch import MatchConfig, SiftConfig, extract_features, match_descriptors_batch
from siftgpu_tpu_torch.frontend import describe, detect, extract, fused, match, orient, pyramid, redetect
from siftgpu_tpu_torch.ops import _build, desc_sampler, detect_scores, match_kernel


def stage_times(images, cfg, mcfg, reps=10):
    """Mean host ms per stage, each stage synchronised."""
    sync = torch.cuda.synchronize
    acc = {}

    def t(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    for i in range(reps + 1):
        if i == 1:
            acc.clear()  # the first pass is the warm-up
        pyr = t("pyramid", lambda: pyramid.build_pyramid(images, cfg))
        kps = t("detect (scores, top-k, records)", lambda: detect.detect_pyramid(pyr, cfg))
        kps = t("prefilter", lambda: extract.prefilter_candidates(kps, cfg))
        parts = []
        for o, oc in enumerate(pyr):
            grads = t("gradient stack", lambda: orient.gradient_stack(oc.gauss, cfg))
            th, m, d = t("orient + sample + bin", lambda: fused.orient_describe_fused(grads, kps[o], cfg))
            n = cfg.max_orientations
            kp = kps[o]
            dup = lambda a: a[..., None].expand(*a.shape, n).reshape(a.shape[0], -1)
            cand = dict(y=dup(kp.y), x=dup(kp.x), sigma=dup(kp.sigma), theta=th,
                        response=dup(kp.response), mask=m, desc=d)
            parts.append(extract.to_image_coords(cand, cfg, o))
        f = t("assemble", lambda: extract.assemble_features(parts, cfg))
        t("match (3 pairs)", lambda: match_descriptors_batch(
            f.desc[:-1], f.desc[1:], f.mask[:-1], f.mask[1:], mcfg))
    return {k: v / reps for k, v in acc.items()}


def profile_window(label, step, iters, top=25):
    """Host ms per call of `step` (10 calls, no profiler), then device kernel
    time by kernel and the busy share over `iters` profiled calls."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    print(f"{label}: {wall:.3f} ms per iteration (host clock, no profiler); "
          f"device kernel time {busy:.3f} ms per iteration (torch.profiler, {iters} iterations), "
          f"busy share {100 * busy / wall:.1f}%, {sum(e.count for e in kernels) // iters} kernels")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3 / iters:9.4f} ms/iter  "
              f"{e.count // iters:5d} launches/iter  {e.key[:100]}")


def twoview_profile():
    """`two_view_reconstruct` on chip_smoke.py's phase-4c stereo pair, and
    its bundle adjustment (10 LM x 30 CG) on the problem that call built."""
    from siftgpu_tpu_torch.optim import ba
    from siftgpu_tpu_torch.oracle import fixtures
    from siftgpu_tpu_torch.pipeline import twoview

    f = 180.0 * W / 200.0
    intr = (f, f, W / 2.0, H / 2.0)
    img0, img1, _ = fixtures.two_plane_stereo(H, W, intr, RVEC, T_GT, seed=2)
    images = torch.from_numpy(np.stack([img0, img1])).cuda()
    intr_t = torch.tensor(intr, dtype=torch.float32, device="cuda")
    cfg = SiftConfig(height=H, width=W, max_keypoints=K)
    mcfg = MatchConfig(max_sift=K, max_match=K)
    gen = torch.Generator(device="cuda").manual_seed(7)
    run = lambda: twoview.two_view_reconstruct(images, intr_t, cfg, mcfg, gen)
    problems = []
    with recording(ba, "run_ba", problems):
        run()
    profile_window("two_view_reconstruct", run, 3, top=15)
    profile_window("run_ba (10 LM x 30 CG)", lambda: ba.run_ba(*problems[0]), 3, top=10)


SLAM_STAGES = {
    # module attribute wrapped -> stage name (launches go to the innermost)
    # (run_slam calls the captured entry points: a replay is one stage)
    ("slam", "_track_step_jit"): "track step (extract + live match)",
    ("slam", "extract_features_jit"): "extract (bootstrap)",
    ("slam", "_loop_match_jit"): "archive match",
    ("pnp", "pnp_gn"): "PnP",
    ("ba", "run_ba"): "windowed BA",
    ("P", "triangulate"): "triangulate",
    ("slam", "apply_pose_graph_sim3"): "pose graph + map repair",
    ("slam", "refit_map_points"): "refit",
}


def slam_profile():
    """`run_slam` on chip_smoke.py's phase-4d loop scene: host time, busy
    share, and kernel launches per stage, per tracked frame and per
    keyframe."""
    from contextlib import ExitStack
    from functools import wraps

    from chip_smoke import slam_config, slam_loop_scene
    from siftgpu_tpu_torch.oracle import fixtures
    from siftgpu_tpu_torch.pipeline import slam

    frames, _, intr = slam_loop_scene(fixtures)
    cfg = SiftConfig(height=H, width=W, max_keypoints=K)
    mcfg = MatchConfig(max_sift=K, max_match=K)
    scfg = slam_config(slam)
    run = lambda: slam.run_slam(frames, intr, cfg, mcfg, scfg, device="cuda")
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    T, n_kf = len(frames), len(res.keyframe_indices)

    def wrapped(fn, name):
        @wraps(fn)
        def inner(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return inner

    mods = {"slam": slam, "pnp": slam.pnp, "ba": slam.ba, "P": slam.P}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with ExitStack() as stack:
        for (m, attr), name in SLAM_STAGES.items():
            orig = getattr(mods[m], attr)
            setattr(mods[m], attr, wrapped(orig, name))
            stack.callback(setattr, mods[m], attr, orig)
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
    events = prof.events()
    names = set(SLAM_STAGES.values())
    # the stage ranges also appear on the device timeline (user annotations
    # spanning each range): neither their device time nor their count is work
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in names) / 1e3
    ranges = [e for e in events
              if e.name in names and e.device_type == torch.autograd.DeviceType.CPU]
    # (a replay is one cudaGraphLaunch, not counted: these are the host's launches)
    launches = [e for e in events if "aunch" in e.name and "Kernel" in e.name]
    per = {name: [0, 0] for name in names}      # stage -> [calls, launches]
    for r in ranges:
        per[r.name][0] += 1
    other = 0
    for ev in launches:
        t = ev.time_range.start
        inside = [r for r in ranges if r.thread == ev.thread
                  and r.time_range.start <= t <= r.time_range.end]
        if inside:
            per[min(inside, key=lambda r: r.time_range.elapsed_us()).name][1] += 1
        else:
            other += 1
    frame_side = sum(per[n][1] for n in ("track step (extract + live match)",
                                         "extract (bootstrap)", "PnP"))
    print(f"SLAM loop scene ({T} frames, {n_kf} keyframes, {len(res.loop_edges)} loop edges): "
          f"{wall:.3f} s, {T / wall:.2f} frames/s (host clock, no profiler); device time "
          f"{dev_ms:.3f} ms (torch.profiler), busy share {100 * dev_ms / 1e3 / wall:.1f}%; "
          f"{len(launches)} kernel launches, {len(launches) / T:.1f} per frame")
    for name, (calls, n) in sorted(per.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:36s} {calls:4d} calls {n:7d} launches ({n / max(calls, 1):.1f} per call)")
    print(f"  {'outside the stages':36s}      {other:7d} launches")
    print(f"  per tracked frame (track step + extract + PnP; the loop's PnPs included): "
          f"{frame_side / T:.1f} launches; per keyframe (the rest): "
          f"{(len(launches) - frame_side) / n_kf:.1f} launches")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    cfg = SiftConfig(height=480, width=640, max_keypoints=K)
    mcfg = MatchConfig(max_sift=K, max_match=K)
    images = torch.from_numpy(make_frames()).cuda()
    for kern in _build.KERNELS.values():
        kern.lib()

    print("stage times (host clock, synchronised, ms per batch of 4 frames):")
    st = stage_times(images, cfg, mcfg)
    for k, v in st.items():
        print(f"  {k:36s} {v:9.3f}")
    print(f"  {'sum':36s} {sum(st.values()):9.3f}")

    def step():
        f = extract_features(images, cfg)
        match_descriptors_batch(f.desc[:-1], f.desc[1:], f.mask[:-1], f.mask[1:], mcfg)

    profile_window("extract + match", step, 5)
    twoview_profile()
    slam_profile()

    # ---- FMA probe: detect_scores built with nvcc's default contraction ----
    probe = _build.Kernel("detect_scores_fmad", "detect_scores.cu", detect_scores.KERNEL.entry)
    _build.KERNELS.pop("detect_scores_fmad")
    main_kernel = detect_scores.KERNEL
    pyr = pyramid.build_pyramid(images, cfg)
    n_flip = n_px = 0
    rec_ulp = []
    try:
        detect_scores.KERNEL = probe
        for oc in pyr:
            got = detect_scores._detect_scores_cuda(oc.dog, cfg)
            ref = detect_scores.detect_scores_plain(oc.dog, cfg)
            for k in (0, 1):
                n_flip += int((got[k].view(torch.int32) != ref[k].view(torch.int32)).sum())
                n_px += got[k].numel()
            cand = torch.zeros_like(got[2], dtype=torch.bool)    # candidate pixels
            for plane in ref[:2]:
                b, s_, yp, x = torch.nonzero(plane > 0, as_tuple=True)
                y = 2 * yp + ((plane[b, s_, yp, x].view(torch.int32) & 3) >> 1)
                cand[b, s_, y, x] = True
            for g, r in zip(got[2:], ref[2:]):
                u = (g.view(torch.int32).long() - r.view(torch.int32).long()).abs()
                rec_ulp.append((int(u[cand].max()) if bool(cand.any()) else 0, int(u.max())))
    finally:
        detect_scores.KERNEL = main_kernel
    print(f"FMA probe (detect_scores without -fmad=false): {n_flip} of {n_px} row-pooled "
          f"score entries differ from the plain version; record max ulp (at candidates, "
          f"anywhere) per octave and field {rec_ulp}")
    sampler_fma_probe(images, cfg)
    gate_tf32_probe(images, cfg)
    return 0


def sampler_fma_probe(images, cfg):
    """sample_gradients built with nvcc's default contraction, on the calls
    of descriptor-only mode for frame 0's own keypoints."""
    f = extract_features(images[:1], cfg)
    keys = f.keypoints[0][f.mask[0]]
    calls = []
    with recording(describe, "sample_gradients", calls):
        redetect.describe_at_keypoints(images[:1], keys[None], cfg)
    probe = _build.Kernel("sample_gradients_fmad", "desc_sampler.cu", desc_sampler.KERNEL.entry)
    _build.KERNELS.pop("sample_gradients_fmad")
    main_kernel = desc_sampler.KERNEL
    n_diff = n_all = 0
    max_abs = 0.0
    try:
        desc_sampler.KERNEL = probe
        for args in calls:   # each octave's call, its sampled rows
            got = desc_sampler._sample_gradients_cuda(*args[:5])
            ref = desc_sampler.sample_gradients_plain(*args[:5])
            live = args[2] >= 0
            for g, r in zip(got, ref):
                g, r = g[live], r[live]
                n_diff += int((g.view(torch.int32) != r.view(torch.int32)).sum())
                n_all += g.numel()
                max_abs = max(max_abs, float((g - r).abs().max())) if g.numel() else max_abs
    finally:
        desc_sampler.KERNEL = main_kernel
    print(f"FMA probe (sample_gradients without -fmad=false): {n_diff} of {n_all} samples "
          f"differ from the plain version, max abs {max_abs:.3g}")


def gate_tf32_probe(images, cfg):
    """The H-gate operands from a TF32 matmul against the elementwise ones."""
    f = extract_features(images[:2], cfg)
    loc0 = f.keypoints[0][f.mask[0], :2].contiguous()
    loc1 = f.keypoints[1][f.mask[1], :2].contiguous()
    H = torch.tensor([[1, 0, SHIFT[0]], [0, 1, SHIFT[1]], [0, 0, 1]], device=images.device)
    gate, rows, cols = match.gate_operands(loc0, loc1, H=H)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        p = torch.cat([loc0, torch.ones_like(loc0[:, :1])], 1) @ H.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    rows_t = torch.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]])
    h2, _ = match.gate_thresholds(3.0, 0.0)
    keep = match_kernel.gate_matrix(gate, rows[None], cols[None], h2, 0.0)
    keep_t = match_kernel.gate_matrix(gate, rows_t[None], cols[None], h2, 0.0)
    print(f"TF32 probe (H-gate operands by a TF32 matmul): max |px, py| change "
          f"{float((rows_t - rows).abs().max()):.4g} px; {int((keep != keep_t).sum())} of "
          f"{int(keep.sum())} in-gate pairs flip at 3 px ({len(loc0)} x {len(loc1)} keypoints)")


if __name__ == "__main__":
    sys.exit(main())
