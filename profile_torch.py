#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 profile_torch.py

Same workload as chip_smoke.py (4 x 480x640 frames, K = 2048, 3 pairs).
Prints:
  1. host-clock stage times (each stage ends in torch.cuda.synchronize());
  2. a torch.profiler table of device time by kernel over 5 extract + match
     iterations, and the device busy share of that window;
  3. the FMA probe: the detect_scores kernel built WITHOUT -fmad=false,
     against the plain version — how many score-plane entries and record
     values change when nvcc contracts multiply-adds.
"""

from __future__ import annotations

import sys
import time

import torch

from chip_smoke import K, card_line, make_frames
from siftgpu_tpu_torch import MatchConfig, SiftConfig, extract_features, match_descriptors_batch
from siftgpu_tpu_torch.frontend import detect, extract, fused, orient, pyramid
from siftgpu_tpu_torch.ops import _build, detect_scores


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

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 5
    print(f"extract + match: {wall:.3f} ms per iteration (host clock, no profiler); "
          f"device kernel time {busy:.3f} ms per iteration (torch.profiler, 5 iterations), "
          f"busy share {100 * busy / wall:.1f}%, {sum(e.count for e in kernels) // 5} kernels")
    for e in kernels[:25]:
        print(f"  {e.self_device_time_total / 1e3 / 5:9.4f} ms/iter  {e.count // 5:5d} launches/iter  {e.key[:100]}")

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
