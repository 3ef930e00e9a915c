"""Command line of the port: SiftGPU's demo programs as subcommands.

Port of `siftgpu_tpu/pipeline/cli.py`, with its arguments and printed lines:
  extract   SimpleSIFT's extraction half (+ --out .sift, --npz feature store)
  match     SimpleSIFT's matching half (extract 2 images, match, print;
            --viz writes a side-by-side PPM of the matches)
  speed     speed.cpp: repeat RunSIFT, report ms/frame and Hz (--trace DIR
            writes a torch.profiler Chrome trace of the steady state)
  twoview   two-view SfM: E, pose, BA rms
  slam      monocular SLAM over an image sequence (keyframes, windowed BA,
            loop closure); --traj writes a TUM-format trajectory
  dump      TestWinGlut viewer analog: every pyramid stage (Gaussian, DoG,
            gradient magnitude) as PGM files (--kp adds keypoints.ppm)
  serve     the TCP feature server (`pipeline/server.py`)

SiftGPU's extraction flags (-fo -d -t -e -m -s -maxd -tc -loweo -unn -b -v)
are accepted anywhere after the subcommand and go to `parse_flags`.  Every
subcommand runs on the card; `--cpu` anywhere runs it on the CPU instead.
Without a card and without `--cpu` a subcommand exits with status 1.

Usage: python -m siftgpu_tpu_torch <subcommand> [args...] [--cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from ..core import image as imio
from ..core.flags import _BOOL, _OPTIONAL_VALUED, _TC, _VALUED
from .api import SiftMatchTPU, SiftTPU, _require

__all__ = ["main"]


def _split_flags(args):
    """Separate SiftGPU flags (for `parse_flags`) from argparse arguments."""
    known, rest = [], []
    valued = {**_VALUED, **dict.fromkeys(_TC)}
    i = 0
    while i < len(args):
        a = args[i]
        base = a.split("=")[0]
        if base in valued and "=" not in a:
            known += args[i : i + 2]
            i += 2
        elif base in valued or base in _BOOL:
            known.append(a)
            i += 1
        elif base in _OPTIONAL_VALUED:
            # parse_flags' rule: the next token is the value iff it is an
            # integer (negatives included), so the CLI and the API agree
            nxt = args[i + 1] if i + 1 < len(args) else None
            consumed = False
            if nxt is not None and "=" not in a:
                try:
                    int(nxt)
                    consumed = True
                except ValueError:
                    pass
            if consumed:
                known += args[i : i + 2]
                i += 2
            else:
                known.append(a)
                i += 1
        else:
            rest.append(a)
            i += 1
    return known, rest


def cmd_extract(argv, device):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="extract")
    p.add_argument("image")
    p.add_argument("--out", "-O", default=None)
    p.add_argument("--npz", default=None)
    a = p.parse_args(rest)
    s = SiftTPU(argv=flags_argv, device=device)
    t0 = time.perf_counter()
    s.run_sift(a.image)
    n = s.get_feature_num()
    print(f"{n} features  ({(time.perf_counter() - t0) * 1e3:.1f} ms incl. compile)")
    out = a.out or s._overrides.get("_output_file")
    if out:
        s.save_sift(out)
        print(f"wrote {out}")
    if a.npz:
        from . import siftio

        siftio.save_feature_store(a.npz, s._feats)
        print(f"wrote {a.npz}")
    return 0


def cmd_match(argv, device):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="match")
    p.add_argument("image0")
    p.add_argument("image1")
    p.add_argument("--distmax", type=float, default=0.7)
    p.add_argument("--ratiomax", type=float, default=0.8)
    p.add_argument("--viz", default=None, metavar="OUT.ppm",
                   help="write a side-by-side match-lines overlay (viewer analog)")
    a = p.parse_args(rest)
    s = SiftTPU(argv=flags_argv, device=device)
    s.run_sift(a.image0)
    k0, d0 = s.get_feature_vector()
    s.run_sift(a.image1)
    k1, d1 = s.get_feature_vector()
    m = SiftMatchTPU(max_sift=max(len(d0), len(d1), 1), device=device)
    m.set_descriptors(0, d0)
    m.set_descriptors(1, d1)
    pairs = m.get_sift_match(distmax=a.distmax, ratiomax=a.ratiomax)
    print(f"{len(d0)} x {len(d1)} features -> {len(pairs)} matches")
    for i, j in pairs[:20]:
        print(f"  ({k0[i,0]:7.2f},{k0[i,1]:7.2f}) <-> ({k1[j,0]:7.2f},{k1[j,1]:7.2f})")
    if a.viz:
        from . import viz

        img0 = imio.load_image(a.image0)
        img1 = imio.load_image(a.image1)
        imio.save_ppm(a.viz, viz.draw_matches(img0, img1, k0, k1, pairs))
        print(f"wrote {a.viz}")
    return 0


def cmd_speed(argv, device):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="speed")
    p.add_argument("image")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (CPU and, on the card, "
                        "CUDA activity) of the steady state to DIR/trace.json")
    a = p.parse_args(rest)
    s = SiftTPU(argv=flags_argv, device=device)
    s.run_sift(a.image)  # warm-up: builds the kernels on the card
    s.get_feature_num()  # waits for the device
    acts = [torch.profiler.ProfilerActivity.CPU]
    if s.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) if a.trace else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        for _ in range(a.iters):
            s.run_sift(a.image)
            s.get_feature_num()  # one wait per frame
        dt = (time.perf_counter() - t0) / a.iters
    if prof is not None:
        os.makedirs(a.trace, exist_ok=True)
        path = os.path.join(a.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}")
    print(
        f"{s.get_feature_num()} features, {dt * 1e3:.2f} ms/frame, "
        f"{1.0 / dt:.1f} Hz (steady-state, {a.iters} iters)"
    )
    return 0


def cmd_twoview(argv, device):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="twoview")
    p.add_argument("image0")
    p.add_argument("image1")
    p.add_argument("--focal", type=float, required=True)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(rest)
    from ..core.config import MatchConfig
    from . import twoview

    img0 = imio.load_image(a.image0)
    img1 = imio.load_image(a.image1)
    if img0.shape != img1.shape:
        raise ValueError(f"twoview: image sizes differ, {img0.shape} and {img1.shape}")
    s = SiftTPU(argv=flags_argv, device=device)
    maxd = s._overrides.get("max_dim", 0)
    if maxd:  # -maxd: downsample the frames, not just the config geometry
        img0 = imio.downsample_to_fit(img0, maxd)
        img1 = imio.downsample_to_fit(img1, maxd)
    H, W = img0.shape
    cfg = s.config_for(H, W)
    dev = s.device
    intr = torch.tensor([a.focal, a.focal, W / 2.0, H / 2.0], dtype=torch.float32, device=dev)
    res = twoview.two_view_reconstruct_jit(   # the reference's CLI calls the jitted program
        torch.from_numpy(np.stack([img0, img1])).to(dev), intr, cfg,
        MatchConfig(max_match=cfg.max_keypoints),
        torch.Generator(device=dev).manual_seed(a.seed),
    )
    R = res.R.cpu().numpy()
    print(f"matches={int(res.num_matches)} inliers={int(res.num_inliers)}")
    print(f"R=\n{R}")
    print(f"t={res.t.cpu().numpy()}  rms={float(res.rms):.3f}px")
    return 0


def cmd_dump(argv, device):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="dump")
    p.add_argument("image")
    p.add_argument("--outdir", default="dump")
    p.add_argument("--kp", action="store_true",
                   help="also render keypoints (scale circles + orientation ticks) "
                        "over the input as keypoints.ppm (viewer analog)")
    a = p.parse_args(rest)
    from ..frontend import orient, pyramid

    os.makedirs(a.outdir, exist_ok=True)
    s = SiftTPU(argv=flags_argv, device=device)
    img = imio.load_image(a.image)
    maxd = s._overrides.get("max_dim", 0)
    if maxd:
        img = imio.downsample_to_fit(img, maxd)
    if a.kp:
        from . import viz

        s.run_sift(img)
        keys, _ = s.get_feature_vector()
        over = viz.draw_keypoints(img, keys[:, 0], keys[:, 1], keys[:, 2], keys[:, 3])
        imio.save_ppm(f"{a.outdir}/keypoints.ppm", over)
        print(f"wrote {a.outdir}/keypoints.ppm ({len(keys)} keypoints)")
    cfg = s.config_for(*img.shape)
    pyr = pyramid.build_pyramid(torch.from_numpy(np.ascontiguousarray(img[None])).to(s.device), cfg)
    for o, oc in enumerate(pyr):
        g = oc.gauss[0].cpu().numpy()
        d = oc.dog[0].cpu().numpy()
        for l in range(g.shape[0]):
            imio.save_pgm(f"{a.outdir}/o{o}_gauss{l}.pgm", g[l])
        for l in range(d.shape[0]):
            dn = 0.5 + d[l] * 5.0
            imio.save_pgm(f"{a.outdir}/o{o}_dog{l}.pgm", np.clip(dn, 0, 1))
        gs = orient.gradient_stack(oc.gauss, cfg)
        # the magnitude in f32 from the bf16 stack
        mag = np.hypot(gs.gx[0].float().cpu().numpy(), gs.gy[0].float().cpu().numpy())
        for l in range(mag.shape[0]):
            imio.save_pgm(f"{a.outdir}/o{o}_gradmag{l}.pgm", np.clip(mag[l] * 4, 0, 1))
    print(f"wrote pyramid stages to {a.outdir}/")
    return 0


def cmd_serve(argv, device):
    """ServerSiftGPU analog: serve one SiftTPU + SiftMatchTPU over TCP.
    Flags after `--` go to the server's parse_param."""
    fwd = []
    if "--" in argv:
        i = argv.index("--")
        argv, fwd = argv[:i], argv[i + 1 :]
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--port", type=int, default=7777)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-sift", type=int, default=4096)
    p.add_argument("--one-shot", action="store_true")
    a = p.parse_args(argv)
    from . import server

    server.serve(a.port, host=a.host, argv=fwd or None, max_sift=a.max_sift,
                 one_shot=a.one_shot, device=device)
    return 0


def cmd_slam(argv, device):
    """Monocular SLAM over an ordered image sequence: tracking, keyframes,
    windowed BA and loop closure; writes a TUM-format trajectory that the
    standard ATE/RPE evaluation tools read."""
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="slam")
    p.add_argument("images", nargs="+", help="image files in order, or ONE .npy of [T, H, W]")
    p.add_argument("--focal", type=float, required=True)
    p.add_argument("--traj", default=None, help="write the trajectory here (TUM format)")
    p.add_argument("--checkpoint", default=None,
                   help="periodic crash-recovery snapshots (atomic NPZ)")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint (exact replay)")
    p.add_argument("--metrics", default=None, help="JSONL metrics stream")
    p.add_argument("--kf-window", type=int, default=4)
    p.add_argument("--no-loop", action="store_true", help="disable loop-closure detection")
    a = p.parse_args(rest)

    if len(a.images) == 1 and a.images[0].endswith(".npy"):
        frames = np.load(a.images[0])
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / 255.0
        frames = frames.astype(np.float32)
    else:
        frames = np.stack([imio.load_image(f) for f in a.images])
    T, H, W = frames.shape

    from ..core.config import MatchConfig
    from . import checkpoint as ckpt_mod
    from . import metrics as metrics_mod
    from . import slam as slam_mod

    s = SiftTPU(argv=flags_argv, device=device)
    cfg = s.config_for(H, W)
    scfg = slam_mod.SlamConfig(kf_window=a.kf_window, loop_closure=not a.no_loop)
    intr = (a.focal, a.focal, W / 2.0, H / 2.0)
    resume = ckpt_mod.load_slam_state(a.checkpoint) if a.resume and a.checkpoint else None
    with metrics_mod.MetricsLogger(a.metrics) as ml:
        t0 = time.perf_counter()
        res = slam_mod.run_slam(
            frames, intr, cfg, MatchConfig(max_match=cfg.max_keypoints), scfg,
            metrics=ml, checkpoint_path=a.checkpoint, resume=resume, device=s.device,
        )
        # a final Sim(3) pose-graph pass over all keyframes before export: it
        # takes any loop edge accepted after the last online correction, so
        # the exported trajectory is loop-corrected
        if res.loop_edges:
            applied = slam_mod.apply_pose_graph_sim3(
                res.keyframes, res.trajectory, res.map_points, res.map_mask,
                res.map_anchor, res.loop_edges, odo_edges=res.odo_edges, device=s.device,
            )
            if applied:
                # points-only refit against the corrected poses (the anchor
                # transport is slightly non-rigid across anchors)
                slam_mod.refit_map_points(res.keyframes, res.map_points, res.map_mask, intr,
                                          device=s.device)
        dt = time.perf_counter() - t0
    print(
        f"{T} frames in {dt:.1f}s ({T / dt:.1f} fps incl. compile): "
        f"{len(res.keyframe_indices)} keyframes, "
        f"{int(res.map_mask.sum())} map points, "
        f"{len(res.loop_edges or [])} loop closures"
    )
    if a.traj:
        from . import siftio

        siftio.save_trajectory_tum(a.traj, res.trajectory)
        print(f"wrote {a.traj} (TUM format)")
    return 0


_COMMANDS = {
    "extract": cmd_extract,
    "match": cmd_match,
    "speed": cmd_speed,
    "twoview": cmd_twoview,
    "slam": cmd_slam,
    "dump": cmd_dump,
    "serve": cmd_serve,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--cpu" in argv else "cuda"
    argv = [a for a in argv if a != "--cpu"]
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _COMMANDS:
        print(__doc__)
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    try:
        _require(torch.device(device))
    except RuntimeError as e:
        print(f"{argv[0]}: {e}, or --cpu to the command line", file=sys.stderr)
        return 1
    return _COMMANDS[argv[0]](argv[1:], device)


if __name__ == "__main__":
    raise SystemExit(main())
