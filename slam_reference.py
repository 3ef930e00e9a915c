#!/usr/bin/env python3
"""The reference's SLAM loop (`siftgpu_tpu`, JAX) on `chip_smoke.py` phase
4d's scenes, on the CPU: the numbers phase 4d's gates are set from.

    python3 slam_reference.py [--height 480 --width 640]

Runs `siftgpu_tpu.pipeline.slam.run_slam` on the out-and-back loop scene
(T = 24, K = 2048 at 480x640) and on the blackout scene (clean and dark),
and prints one JSON line: keyframe indices, loop edges (i, j), ATE and span
of each run, PnP inliers per frame, and the host seconds of each run.  It
needs JAX and takes minutes at 480x640 on a CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=cs.H)
    ap.add_argument("--width", type=int, default=cs.W)
    ap.add_argument("--keypoints", type=int, default=cs.K)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from siftgpu_tpu.core.config import MatchConfig, SiftConfig
    from siftgpu_tpu.geometry import align
    from siftgpu_tpu.oracle import fixtures
    from siftgpu_tpu.pipeline import slam

    h, w, k = args.height, args.width, args.keypoints
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


if __name__ == "__main__":
    raise SystemExit(main())
