"""Multi-rank dry run: one pass over every leg of `parallel/` in n ranks.

Port of `siftgpu_tpu/parallel/dryrun.py`.  `run_dryrun(n)` spawns n ranks
(`comm.spawn`) that run, in one process group:

  1. data-parallel extraction (`dp`) of n frames of 64x80 noise (2 a
     "data" row of the reference's mesh);
  2. row-slab extraction (`spatial`) of the first two frames over each
     pair of consecutive ranks (`dist.new_group`, every rank creating every
     pair's group: the reference's `spatial` mesh axis; skipped for an odd
     n, where that axis has one device);
  3. one pairwise match of frames 0 and 1 (kernel 4 on the card);
  4. `run_ba_distributed` on a 4-camera, 64-point problem;
  5. the edge-sharded pose graph on a 6-pose chain;
  6. the sequence feature store, then `run_slam_distributed` on an
     8-frame 96x128 two-plane scene, whose Sim(3)-aligned ATE must stay
     under 10% of the trajectory's span.

Steps other than 2 run over the whole group (one group for every leg, as in
the rest of the port).  Every rank returns a summary of its steps, with
the time it joined the group and its hand-kernel launches; a step that
fails raises in its rank, and `comm.spawn` then raises.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.config import MatchConfig, SiftConfig
from . import comm

__all__ = ["run_dryrun"]


def _tiny_ba_problem(n_cams: int = 4, n_pts: int = 64, seed: int = 0):
    """The reference's `_tiny_ba_problem`: noise-free observations of n_pts
    points by n_cams cameras 0.3 apart on x; cameras 1.. perturbed by 0.01,
    the points by 0.05.  Returns an `optim.ba.BAProblem` on the CPU."""
    from ..geometry.pose import exp_so3
    from ..optim import ba

    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 6], [2, 2, 10], (n_pts, 3)).astype(np.float32)
    intr = np.array([200.0, 200.0, 80.0, 60.0], np.float32)
    cams = np.zeros((n_cams, 6), np.float32)
    cams[:, 3] = np.arange(n_cams) * 0.3
    R = exp_so3(torch.from_numpy(cams[:, :3])).numpy()
    Xc = np.einsum("cij,pj->cpi", R, X) + cams[:, None, 3:]
    uv = (intr[:2] * Xc[..., :2] / Xc[..., 2:] + intr[2:]).reshape(-1, 2)
    cams_noisy = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    cams_noisy[0] = cams[0]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    return ba.BAProblem(
        cams=t(cams_noisy), points=t(X + rng.normal(0, 0.05, X.shape).astype(np.float32)),
        intrinsics=t(intr), cam_idx=t(np.repeat(np.arange(n_cams), n_pts), torch.int32),
        pt_idx=t(np.tile(np.arange(n_pts), n_cams), torch.int32), uv=t(uv),
        w=torch.ones(n_cams * n_pts))


def _pair_group(group):
    """This rank's group of two consecutive ranks; every rank creates every
    pair's group, in the same order, as `dist.new_group` requires."""
    import torch.distributed as dist

    n, r = comm.world_size(group), comm.rank(group)
    ranks = dist.get_process_group_ranks(group)
    mine = None
    for k in range(n // 2):
        g = dist.new_group([ranks[2 * k], ranks[2 * k + 1]])
        if r // 2 == k:
            mine = g
    return mine


def _rank(*, group, device) -> dict:
    """One rank of the dry run (see the module docstring)."""
    from ..frontend.match import match_descriptors
    from ..geometry import align
    from ..geometry import pose as P
    from ..ops import _build
    from ..optim import pose_graph as pg
    from ..oracle import fixtures
    from ..pipeline import slam
    from . import dist_ba, dist_pose_graph, dp, sequence, spatial

    n = comm.world_size(group)
    out = {"rank": comm.rank(group), "device": str(device), "t_joined": time.time()}
    launched = {name: kern.launches for name, kern in _build.KERNELS.items()}
    d_spatial = 2 if n % 2 == 0 else 1
    d_data = n // d_spatial

    # 1. data-parallel extraction of tiny frames
    B, H, W = d_data * 2, 64, 80
    frames = np.random.default_rng(0).random((B, H, W)).astype(np.float32)
    cfg = SiftConfig(height=H, width=W, max_keypoints=128, num_octaves=2)
    feats = dp.gather_features(dp.extract_features_dp(frames, cfg, group, device), group)
    out["dp_count"] = feats.count.cpu().tolist()

    # 2. row slabs over each pair of ranks
    if d_spatial > 1:
        sfeats = spatial.extract_features_spatial(frames[:2], cfg, _pair_group(group), device)
        out["spatial_count"] = sfeats.count.cpu().tolist()

    # 3. one pairwise match
    res = match_descriptors(feats.desc[0], feats.desc[1], feats.mask[0], feats.mask[1],
                            MatchConfig(max_match=128))
    out["match_count"] = int(res.count)

    # 4. distributed BA
    sprob = dist_ba.partition_problem(_tiny_ba_problem(), n)
    state, cost = dist_ba.run_ba_distributed(sprob, group, iters=3, n_cg=10, device=device)
    out["ba_cost"] = float(cost)
    if not np.isfinite(out["ba_cost"]):
        raise AssertionError(f"dry run: distributed BA cost {cost}")

    # 5. distributed pose graph (edges sharded, normal equations summed)
    n_pose = 6
    poses = torch.from_numpy(np.concatenate(
        [np.zeros((n_pose, 3)), np.linspace(0, 1, n_pose)[:, None] * np.ones((1, 3))],
        axis=1).astype(np.float32))
    ei = torch.arange(n_pose - 1, dtype=torch.int32)
    ej = ei + 1
    Ri, ti = P.exp_se3(poses[ei.long()])
    Rj, tj = P.exp_se3(poses[ej.long()])
    graph = pg.PoseGraph(poses=(poses + 0.01).to(device), edge_i=ei.to(device),
                         edge_j=ej.to(device),
                         t_meas=P.log_se3(*P.relative(Ri, ti, Rj, tj)).to(device),
                         weight=torch.ones(n_pose - 1, device=device))
    pgo, _ = dist_pose_graph.optimize_pose_graph_distributed(graph, group, iters=2)
    out["pg_poses_finite"] = bool(torch.isfinite(pgo.poses).all())

    # 6. the sequence store, then config 5 end to end on a tiny scene
    seq = sequence.extract_sequence_dp(frames, cfg, group, device, chunk=B)
    if seq.desc.shape[0] != B:
        raise AssertionError(f"dry run: the sequence store holds {seq.desc.shape[0]} frames")
    Ts, Hs, Ws = 8, 96, 128
    intr = (110.0, 110.0, Ws / 2.0, Hs / 2.0)
    sframes, sgt = fixtures.two_plane_sequence(
        Ts, Hs, Ws, intr, rvec_step=np.array([0.002, -0.004, 0.001]),
        t_step=np.array([-0.12, 0.012, 0.006]), d_near=5.0, d_far=10.0, seed=4)
    scfg = slam.SlamConfig(kf_min_inliers=40, kf_flow_px=4.0, init_flow_px=5.0, ba_iters=2,
                           ba_cg=8, loop_min_frame_gap=3)
    result = sequence.run_slam_distributed(
        sframes, intr, SiftConfig(height=Hs, width=Ws, max_keypoints=256),
        MatchConfig(max_match=256), scfg, group, device, pose_graph=True)
    if len(result.keyframe_indices) < 2 or not np.isfinite(result.trajectory).all():
        raise AssertionError(f"dry run: config 5 never mapped (keyframes "
                             f"{result.keyframe_indices})")
    est_c, gt_c = align.camera_centers(result.trajectory), align.camera_centers(sgt)
    ate, _ = align.ate_rmse(est_c, gt_c, with_scale=True)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    out.update(keyframes=list(result.keyframe_indices), ate=float(ate), span=span,
               launches={name: kern.launches - launched.get(name, 0)
                         for name, kern in _build.KERNELS.items()})
    if not ate < 0.1 * span:
        raise AssertionError(f"dry run: config-5 trajectory ATE {ate:.4f} vs span {span:.4f}")
    return out


def run_dryrun(n: int, device="cuda", backend: str = "gloo", timeout: float = 600.0,
               threads: Optional[int] = None) -> list:
    """The dry run in n spawned ranks of one `backend` group, rank r on
    `comm.device_of(r, device)`.  Returns every rank's summary (keypoint
    counts of steps 1-2, the match count, BA cost, the SLAM run's
    keyframes, ATE and span, `t_joined` (time.time() once the group
    joined) and the hand kernels' `launches` in the rank's steps); raises
    if a rank failed a step."""
    return comm.spawn(_rank, n, backend, device, timeout=timeout, threads=threads)
