"""Distributed bundle adjustment: map-block partitioning + all-reduced Schur solve.

Port of `siftgpu_tpu/parallel/dist_ba.py`.  Points and their observations
are partitioned into contiguous blocks, one per rank; cameras are
replicated.  Each rank solves its block with `ba.run_ba(..., group=)`: the
camera-side sums are all-reduced every LM and CG step, point
marginalisation (H_pp^-1) stays with the rank.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..optim import ba
from . import comm

__all__ = ["ShardedBAProblem", "partition_problem", "run_ba_distributed", "gather_points"]


class ShardedBAProblem(NamedTuple):
    """Host arrays; the leading axis of the sharded ones is the shard (S)."""
    cams: np.ndarray        # [M, 6] replicated
    points: np.ndarray      # [S, Ps, 3]
    intrinsics: np.ndarray  # [4] replicated
    cam_idx: np.ndarray     # [S, Ns]
    pt_idx: np.ndarray      # [S, Ns] (LOCAL point indices)
    uv: np.ndarray          # [S, Ns, 2]
    w: np.ndarray           # [S, Ns]
    pt_fixed: np.ndarray    # [S, Ps] bool (see ba.BAProblem.pt_fixed)


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def partition_problem(prob: ba.BAProblem, n_shards: int) -> ShardedBAProblem:
    """Host-side partitioning, as the reference's: contiguous point blocks
    (`linspace` bounds), observations follow their point, shards padded to
    equal sizes with zero-weight observations."""
    pts, cam_idx, pt_idx, uv, w = (_host(a) for a in (prob.points, prob.cam_idx, prob.pt_idx,
                                                      prob.uv, prob.w))
    n_pts = pts.shape[0]
    # points created adjacently upstream (one keyframe's triangulations)
    # stay together: contiguous blocks keep that locality
    bounds = np.linspace(0, n_pts, n_shards + 1).astype(int)
    Ps = int(max(np.diff(bounds).max(), 1))
    shard_obs = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        shard_obs.append((lo, hi, np.nonzero((pt_idx >= lo) & (pt_idx < hi))[0]))
    Ns = max(max(len(sel) for _, _, sel in shard_obs), 1)

    fixed = _host(prob.pt_fixed) if prob.pt_fixed is not None else np.zeros(n_pts, bool)
    points_s = np.zeros((n_shards, Ps, 3), np.float32)
    fixed_s = np.zeros((n_shards, Ps), bool)
    cam_s = np.zeros((n_shards, Ns), np.int32)
    pt_s = np.zeros((n_shards, Ns), np.int32)
    uv_s = np.zeros((n_shards, Ns, 2), np.float32)
    w_s = np.zeros((n_shards, Ns), np.float32)
    for s, (lo, hi, sel) in enumerate(shard_obs):
        k = len(sel)
        points_s[s, : hi - lo] = pts[lo:hi]
        fixed_s[s, : hi - lo] = fixed[lo:hi]
        cam_s[s, :k] = cam_idx[sel]
        pt_s[s, :k] = pt_idx[sel] - lo
        uv_s[s, :k] = uv[sel]
        w_s[s, :k] = w[sel]
    return ShardedBAProblem(cams=_host(prob.cams).astype(np.float32), points=points_s,
                            intrinsics=_host(prob.intrinsics).astype(np.float32),
                            cam_idx=cam_s, pt_idx=pt_s, uv=uv_s, w=w_s, pt_fixed=fixed_s)


def run_ba_distributed(sprob: ShardedBAProblem, group=None, iters: int = 10, n_cg: int = 30,
                       fix_first_cam: bool = True, lam0: float = 1e-3,
                       device="cuda") -> Tuple[ba.BAState, torch.Tensor]:
    """Each rank solves shard `rank` of `sprob` (S = the world size) on
    `device`.  Returns (state: the replicated cameras, this rank's point
    block [Ps, 3], lam and the all-reduced cost; the cost)."""
    s = comm.rank(group)
    if sprob.points.shape[0] != comm.world_size(group):
        raise ValueError(f"{sprob.points.shape[0]} shards for {comm.world_size(group)} ranks")
    dev = torch.device(device)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    local = ba.BAProblem(cams=t(sprob.cams), points=t(sprob.points[s]),
                         intrinsics=t(sprob.intrinsics), cam_idx=t(sprob.cam_idx[s], torch.int32),
                         pt_idx=t(sprob.pt_idx[s], torch.int32), uv=t(sprob.uv[s]),
                         w=t(sprob.w[s]), pt_fixed=t(sprob.pt_fixed[s], torch.bool))
    state = ba.run_ba(local, iters=iters, n_cg=n_cg, fix_first_cam=fix_first_cam, lam0=lam0,
                      group=comm.resolve(group))
    return state, state.cost


def gather_points(points: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's point block [Ps, 3] -> [S, Ps, 3], on every rank."""
    return comm.all_gather_rows(points, group).view(comm.world_size(group), *points.shape)
