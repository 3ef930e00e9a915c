#!/usr/bin/env python3
"""The reference's SLAM loop (`siftgpu_tpu`, JAX) on `chip_smoke.py` phase
4d's scenes, on the CPU: the numbers phase 4d's gates are set from.

    python3 slam_reference.py [--height 480 --width 640]
    python3 slam_reference.py --online [--height 144 --width 192 --keypoints 384]
                              [--seeds 11,12,13,14,15] [--nudge N] [--port]

Without `--online` it runs `siftgpu_tpu.pipeline.slam.run_slam` on the
out-and-back loop scene (T = 24, K = 2048 at 480x640) and on the blackout
scene (clean and dark), and prints one JSON line: keyframe indices, loop
edges (i, j), ATE and span of each run, PnP inliers per frame, and the host
seconds of each run (`SLAM_REF`).

With `--online` it runs the online loop correction's fixtures with the
weak SlamConfig of tests/test_loop_closure.py (`chip_smoke.
online_correction_runs`), once per noise seed (by default `chip_smoke.
ONLINE_SEEDS`; the tests' scenes are seed 11): the loop scene online,
end-only and plain, and the two-loop scene's measure of
tests/loop_value_worker.py.  It prints one JSON line per seed:
the numbers those tests' assertions read, with every run's keyframes, loop
edges, correction events, PnP inliers per frame, Sim(3) ATE and seconds
(`ONLINE_REF`), and the ratios the assertions compare
(`chip_smoke.online_ratios`).  `--nudge N` first moves every pixel of both
scenes N f32 ulps (a change at the level of rounding, to show how far an
outcome rests on rounding); `--port` runs the same through the port
(`siftgpu_tpu_torch`, on the CPU, one torch thread) instead, for the
port's side of that probe.

It needs JAX (but for `--online --port`) and takes minutes on a CPU.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import types

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--keypoints", type=int, default=None)
    ap.add_argument("--online", action="store_true",
                    help="the online loop correction's fixtures (default 144x192, K = 384)")
    ap.add_argument("--seeds", default=",".join(map(str, cs.ONLINE_SEEDS)),
                    help="with --online: the scenes' noise seeds, comma-separated")
    ap.add_argument("--nudge", type=int, default=0,
                    help="with --online: move every pixel this many f32 ulps first")
    ap.add_argument("--port", action="store_true",
                    help="with --online: run the port on the CPU instead of the reference")
    args = ap.parse_args()
    if args.online:
        return online(args)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from siftgpu_tpu.core.config import MatchConfig, SiftConfig
    from siftgpu_tpu.geometry import align
    from siftgpu_tpu.oracle import fixtures
    from siftgpu_tpu.pipeline import slam

    h, w, k = args.height or cs.H, args.width or cs.W, args.keypoints or cs.K
    cfg = SiftConfig(height=h, width=w, max_keypoints=k)
    mcfg = MatchConfig(max_match=k)
    scfg = cs.slam_config(slam, w)
    out = {"device": "cpu", "height": h, "width": w, "keypoints": k}

    def run(name, frames, intr, gt, rows=None):
        t0 = time.perf_counter()
        res = slam.run_slam(frames, intr, cfg, mcfg, scfg)
        sec = time.perf_counter() - t0
        out[name] = {
            "keyframes": [int(i) for i in res.keyframe_indices],
            "loop_edges": [[int(e[0]), int(e[1])] for e in res.loop_edges],
            "ate": cs.ate(align, res.trajectory, gt, rows),
            "span": cs.loop_span(align, gt),
            "num_tracked": [int(n) for n in res.num_tracked],
            "seconds": sec,
        }
        print(name, json.dumps(out[name]), flush=True)

    frames, gt, intr = cs.slam_loop_scene(fixtures, h, w)
    run("loop", frames, intr, gt)
    clean, dark, gt, intr = cs.slam_blackout_scene(fixtures, h, w)
    rows = np.r_[0:cs.SLAM_BLACKOUT[0], cs.SLAM_BLACKOUT[1]:cs.SLAM_T]
    run("blackout_clean", clean, intr, gt, rows)
    run("blackout_dark", dark, intr, gt, rows)
    print(json.dumps(out))
    return 0


def online(args) -> int:
    """`--online`: the online loop correction's fixtures through one package."""
    kw = {}
    if args.port:
        import torch

        torch.set_num_threads(1)
        from siftgpu_tpu_torch import MatchConfig, SiftConfig
        from siftgpu_tpu_torch.geometry import align
        from siftgpu_tpu_torch.oracle import fixtures
        from siftgpu_tpu_torch.pipeline import metrics, slam

        kw["device"] = "cpu"
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from siftgpu_tpu.core.config import MatchConfig, SiftConfig
        from siftgpu_tpu.geometry import align
        from siftgpu_tpu.oracle import fixtures
        from siftgpu_tpu.pipeline import metrics, slam
    h, w, k = args.height or 144, args.width or 192, args.keypoints or 384
    pkg = types.SimpleNamespace(SiftConfig=SiftConfig, MatchConfig=MatchConfig, slam=slam,
                                align=align, fixtures=fixtures, metrics=metrics)
    for seed in (int(x) for x in args.seeds.split(",")):
        with tempfile.TemporaryDirectory() as tmp:
            out = cs.online_correction_runs(pkg, h, w, k, tmp, seed=seed, nudge=args.nudge, **kw)
        out.update(ratios=cs.online_ratios(out), device="cpu",
                   package="port" if args.port else "reference")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
