"""BASELINE config 5: keyframe-partitioned multi-rank SLAM.

Port of `siftgpu_tpu/parallel/sequence.py` on `torch.distributed`.  A
T-frame sequence runs as

  1. extraction of ALL frames data-parallel over the ranks
     (`dp.extract_features_dp_jit`, captured once per chunk shape on the
     card, in chunks so device memory stays bounded), each chunk
     all-gathered so that every rank holds the whole store;
  2. the sequential tracking loop (`pipeline.slam.run_slam`) on the
     pre-extracted features, run by EVERY rank on identical inputs, so
     that every rank takes the same host decisions;
  3. every windowed BA as the distributed Schur solve: the map's points
     resident in blocks on the ranks (`resident_ba.resident_ba_class`:
     the captured programs of `ResidentBAJit`, or `ResidentBA`'s eager
     ones where a group's collectives cannot be captured), or
     re-partitioned per solve (`make_distributed_ba`, eager: the
     reference keeps no program of it);
  4. online loop corrections and a final Sim(3) pose-graph refinement over
     all keyframes with the edges sharded over the ranks
     (`dist_pose_graph`), optionally a global BA pass.

The reference's mesh is one process group here, used for all three legs;
its `data` / `spatial` axes have no counterpart (the spatial split is not
ported).  Only rank 0 writes the checkpoint; the metrics files of the
other ranks get `.h<rank>` (`pipeline.metrics`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import MatchConfig, SiftConfig
from ..optim import ba
from . import comm, dist_ba, dist_pose_graph, dp

__all__ = [
    "SequenceFeatures", "extract_sequence_dp", "make_distributed_ba", "make_pg_optimizer",
    "run_global_ba", "run_slam_distributed",
]


class _FrameShim(NamedTuple):
    """The part of a batch-1 `Features` the tracking loop reads from a
    pre-extracted frame (on the device)."""
    desc: torch.Tensor  # [1, K, 128] uint8
    mask: torch.Tensor  # [1, K] bool


class SequenceFeatures(NamedTuple):
    """Whole-sequence feature store in `run_slam(features=...)`'s duck type:
    coordinates on the host (the bookkeeping reads them); descriptors on
    `device` while the store fits the budget, on the host beyond it (a
    long sequence would otherwise grow device memory with T), uploaded
    per frame by `frame_feats`."""

    desc: object      # [T, K, 128] uint8: a tensor on `device`, or np.ndarray
    mask_dev: object  # [T, K] bool, the same residency as desc
    x: np.ndarray     # [T, K] float32, host
    y: np.ndarray     # [T, K]
    mask: np.ndarray  # [T, K] bool, host
    device: torch.device

    def frame_feats(self, t: int) -> _FrameShim:
        if isinstance(self.desc, np.ndarray):
            from ..pipeline.slam import _upload

            (d,) = _upload(self.device, self.desc[t:t + 1], dtype=torch.uint8)
            (m,) = _upload(self.device, self.mask_dev[t:t + 1], dtype=torch.bool)
            return _FrameShim(desc=d, mask=m)
        return _FrameShim(desc=self.desc[t:t + 1], mask=self.mask_dev[t:t + 1])


def extract_sequence_dp(frames, cfg: SiftConfig, group=None, device="cuda",
                        chunk: Optional[int] = None, metrics=None,
                        desc_hbm_budget: int = 1 << 30) -> SequenceFeatures:
    """Extract a [T, H, W] sequence data-parallel over the ranks.

    `chunk` (a multiple of the world size; default 4 frames per rank)
    bounds the pyramid working set per call.  Each rank's block goes
    through `dp.extract_features_dp_jit`, which holds no collective: one
    capture per block shape on the card (a short tail chunk adds at most
    one), the eager extraction on the CPU; the gather, the pulls and the
    host store stay outside it.  The tail chunk is padded
    with copies of the last frame to a multiple of the world size, and the
    padding dropped after extraction.  `desc_hbm_budget`: descriptor-store
    bytes kept on the device; a longer sequence's store goes to host
    memory, each chunk's descriptors pulled before the next extracts.
    Emits an `extract_chunk` metrics event per chunk."""
    from ..pipeline.metrics import or_null
    from ..pipeline.slam import _pull

    metrics = or_null(metrics)
    group = comm.resolve(group)
    n = comm.world_size(group)
    dev = torch.device(device)
    T = len(frames)
    chunk = chunk or 4 * n
    chunk = max(n, (chunk // n) * n)
    frames = frames.cpu().numpy() if torch.is_tensor(frames) else np.asarray(frames)
    host_mode = T * cfg.max_keypoints * 128 > desc_hbm_budget
    descs, masks_d, xs, ys, ms = [], [], [], [], []
    for lo in range(0, T, chunk):
        t0 = time.perf_counter()
        blk = frames[lo:lo + chunk]
        pad = (-len(blk)) % n
        if pad:
            blk = np.concatenate([blk, np.repeat(blk[-1:], pad, axis=0)])
        feats = dp.gather_features(dp.extract_features_dp_jit(blk, cfg, group, dev), group)
        keep = len(blk) - pad
        if host_mode:
            d_h, x_h, y_h, m_h = _pull(feats.desc[:keep], feats.x[:keep], feats.y[:keep],
                                       feats.mask[:keep])
            descs.append(d_h.astype(np.uint8))
            masks_d.append(m_h)
        else:
            descs.append(feats.desc[:keep])
            masks_d.append(feats.mask[:keep])
            x_h, y_h, m_h = _pull(feats.x[:keep], feats.y[:keep], feats.mask[:keep])
        xs.append(x_h)
        ys.append(y_h)
        ms.append(m_h)
        metrics.event("extract_chunk", lo=lo, frames=keep, devices=n, kp=int(m_h.sum()),
                      ms=(time.perf_counter() - t0) * 1e3)
    cat = np.concatenate if host_mode else torch.cat
    return SequenceFeatures(desc=cat(descs), mask_dev=cat(masks_d), x=np.concatenate(xs),
                            y=np.concatenate(ys), mask=np.concatenate(ms), device=dev)


def make_distributed_ba(group=None, device="cuda"):
    """BA runner for `run_slam(ba_fn=...)`: the window's points and their
    observations partitioned over the ranks per solve
    (`dist_ba.partition_problem`), the all-reduced Schur solve, the blocks
    gathered back.  Returns the whole BAState on `device`."""
    group = comm.resolve(group)
    n = comm.world_size(group)

    def run(prob: ba.BAProblem, iters: int, n_cg: int) -> ba.BAState:
        sprob = dist_ba.partition_problem(prob, n)
        state, _ = dist_ba.run_ba_distributed(sprob, group, iters=iters, n_cg=n_cg,
                                              device=device)
        pts_s = dist_ba.gather_points(state.points, group)
        # un-partition: contiguous blocks by the same linspace bounds
        n_pts = prob.points.shape[0]
        bounds = np.linspace(0, n_pts, n + 1).astype(int)
        pts = torch.cat([pts_s[s, : bounds[s + 1] - bounds[s]] for s in range(n)])
        return state._replace(points=pts)

    return run


def make_pg_optimizer(group=None):
    """Distributed Sim(3) pose-graph solver for `run_slam(pg_fn=...)` and
    `pipeline.slam.apply_pose_graph_sim3`: the dense edge-sharded solver
    up to 64 nodes, the matrix-free PCG solver (O(M) all-reduces, never a
    dense H) beyond."""
    group = comm.resolve(group)

    def opt(graph, iters, n_fix=1):
        if graph.poses.shape[0] <= 64:
            return dist_pose_graph.optimize_pose_graph_sim3_distributed(
                graph, group, iters=iters, n_fix=n_fix)
        return dist_pose_graph.optimize_pose_graph_sim3_cg_distributed(
            graph, group, iters=iters, n_fix=n_fix)

    return opt


def _pose_graph_refine(result, group=None, iters: int = 10, loop_weight: float = 8.0,
                       intr=None, device="cuda"):
    """The final Sim(3) pose-graph refinement over the keyframe chain, edges
    sharded over the ranks (`pipeline.slam.apply_pose_graph_sim3` with the
    distributed solver), then the points-only refit against the corrected
    poses."""
    from ..pipeline.slam import apply_pose_graph_sim3, refit_map_points

    kfs = result.keyframes
    if kfs is None or len(kfs) < 3:
        return result
    anchor = (result.map_anchor if getattr(result, "map_anchor", None) is not None
              else np.full(len(result.map_mask), -1, np.int32))
    applied = apply_pose_graph_sim3(
        kfs, result.trajectory, result.map_points, result.map_mask, anchor, result.loop_edges,
        optimizer=make_pg_optimizer(group), iters=iters, loop_weight=loop_weight,
        odo_edges=getattr(result, "odo_edges", None), device=device)
    if applied and intr is not None:
        refit_map_points(kfs, result.map_points, result.map_mask, intr, device=device)
    return result


def run_global_ba(result, group, intr, iters: int = 4, n_cg: int = 20, metrics=None,
                  device="cuda"):
    """One global BA pass over ALL keyframes after the pose graph, with
    Huber weights from the corrected state (gross outliers weight 0); the
    distributed Schur solve over the ranks of `group`, or the one-process
    solver when `group` resolves to None.  Non-keyframe trajectory rows
    are re-anchored to their moved keyframe."""
    from ..geometry import pose as P
    from ..pipeline.metrics import or_null
    from ..pipeline.slam import _pull, _upload

    m = or_null(metrics)
    group = comm.resolve(group)
    dev = torch.device(device)
    kfs = [k for k in (result.keyframes or [])
           if isinstance(getattr(k, "kp", None), dict)
           and k.kp.get("x") is not None and k.pt_ids.size]
    if len(kfs) < 2:
        return result
    obs_c, obs_p, obs_uv = [], [], []
    for ci, k in enumerate(kfs):
        sel = np.nonzero(k.pt_ids >= 0)[0]
        obs_c += [ci] * len(sel)
        obs_p += list(k.pt_ids[sel])
        obs_uv += list(np.stack([np.asarray(k.kp["x"])[sel], np.asarray(k.kp["y"])[sel]], 1))
    if len(obs_c) < 10:
        return result
    old_cams = np.stack([k.pose for k in kfs]).astype(np.float32)
    cams, pts, intr_t, uv = _upload(dev, old_cams, result.map_points,
                                    np.asarray(intr, np.float32), np.stack(obs_uv))
    ci_t, pi_t = _upload(dev, np.asarray(obs_c), np.asarray(obs_p), dtype=torch.int32)
    prob = ba.BAProblem(cams=cams, points=pts, intrinsics=intr_t, cam_idx=ci_t, pt_idx=pi_t,
                        uv=uv, w=torch.ones(len(obs_c), dtype=torch.float32, device=dev))
    # robust weights: the whole-run observation list holds tracking
    # outliers and loop-fused associations; one Huber reweighting from the
    # corrected state, gross outliers dropped
    (r0,) = _pull(ba.reprojection_residuals(prob, prob.cams, prob.points))
    rn = np.linalg.norm(r0, axis=1)
    huber_px = 3.0
    w = np.minimum(1.0, huber_px / np.maximum(rn, 1e-9))
    w[rn > 10.0 * huber_px] = 0.0
    (w_t,) = _upload(dev, w)
    prob = prob._replace(w=w_t)
    if group is not None:
        state = make_distributed_ba(group, dev)(prob, iters, n_cg)
    else:
        state = ba.run_ba(prob, iters=iters, n_cg=n_cg)
    # re-anchor non-keyframe rows: T_t <- T_t . T_kf_old^-1 . T_kf_new
    kf_rows = np.asarray([k.frame_idx for k in kfs])
    order = np.argsort(kf_rows)
    rows = np.arange(len(result.trajectory))
    anchor = np.maximum(np.searchsorted(kf_rows[order], rows, "right") - 1, 0)
    (sel_t,) = _upload(dev, order[anchor], dtype=torch.long)
    traj_t, old_t = _upload(dev, result.trajectory, old_cams[order][anchor])
    Rt, tt = P.exp_se3(traj_t)
    Ro, to = P.exp_se3(old_t)
    Rn, tn = P.exp_se3(state.cams[sel_t])
    Rrel, trel = P.compose(Rt, tt, *P.inverse(Ro, to))
    new_cams, points, cost, traj_new = _pull(state.cams, state.points, state.cost,
                                             P.log_se3(*P.compose(Rrel, trel, Rn, tn)))
    traj_new = np.array(traj_new, np.float32)
    traj_new[kf_rows] = new_cams          # keyframe rows stay exact
    for ci, k in enumerate(kfs):
        k.pose = new_cams[ci].copy()
    result.trajectory[:] = traj_new
    result.map_points[:] = points
    m.event("global_ba", n_kf=len(kfs), n_obs=len(obs_c), cost=float(cost))
    return result


def run_slam_distributed(frames, intr, cfg: SiftConfig, mcfg: MatchConfig, scfg, group=None,
                         device="cuda", chunk: Optional[int] = None, pose_graph: bool = True,
                         metrics=None, checkpoint_path: Optional[str] = None, resume=None,
                         global_ba: bool = False, resident_map: bool = True,
                         timings: Optional[dict] = None):
    """The config-5 pipeline (see the module docstring), run by every rank
    of `group` (None: the default group once one is initialised, else one
    process) on its `device`.  Returns the `pipeline.slam.SlamResult`,
    the same on every rank.

    `pose_graph=False` is the full ablation: online loop correction and
    landmark fusion are off too.  `checkpoint_path` / `resume`: as in
    `run_slam` (rank 0 writes); the feature store is re-extracted on
    resume, and extraction is deterministic, so a resumed run replays the
    uninterrupted one.  `global_ba=True` ends with one distributed BA over
    all keyframes after the pose graph.  `resident_map=True`: the windowed
    BA keeps the map's points resident on the ranks, through the captured
    programs (`ResidentBAJit`) unless `resident_ba_class` rules them out
    (a gloo group on the card keeps `ResidentBA`); False re-partitions
    the window per solve.  `timings`: as in `run_slam`,
    plus "extract" (the whole sequence's)."""
    from ..pipeline import slam
    from ..pipeline.metrics import or_null
    from .resident_ba import resident_ba_class

    m = or_null(metrics)
    group = comm.resolve(group)
    dev = torch.device(device)
    m.event("sequence_start", frames=len(frames), devices=comm.world_size(group))
    if not pose_graph:
        scfg = dataclasses.replace(scfg, loop_online=False, loop_fuse=False)
    t0 = time.perf_counter()
    seq = extract_sequence_dp(frames, cfg, group, dev, chunk=chunk, metrics=metrics)
    if timings is not None:
        timings.setdefault("extract", []).append((time.perf_counter() - t0) * 1e3)
    if resident_map:
        backend = None if group is None else dist.get_backend(group)
        ba_runner = resident_ba_class(dev, backend)(group, dev)
    else:
        ba_runner = make_distributed_ba(group, dev)
    result = slam.run_slam(
        frames, intr, cfg, mcfg, scfg, features=seq, ba_fn=ba_runner, metrics=metrics,
        checkpoint_path=checkpoint_path, resume=resume,
        pg_fn=make_pg_optimizer(group) if pose_graph else None, device=dev, timings=timings)
    if pose_graph:
        result = _pose_graph_refine(result, group, intr=intr, device=dev)
        if global_ba:
            result = run_global_ba(result, group, intr, metrics=metrics, device=dev)
    m.event("sequence_done", keyframes=len(result.keyframe_indices),
            map_pts=int(result.map_mask.sum()))
    return result
