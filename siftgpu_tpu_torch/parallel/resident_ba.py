"""Shard-resident map blocks for the distributed windowed BA.

Port of `siftgpu_tpu/parallel/resident_ba.py`.  The map's points live
partitioned over the ranks between solves:

  - rank r holds slot block r, slots [r * Ps, (r + 1) * Ps), on its device
    (a slot's rank is slot // Ps).  The tracking loop allocates slots in
    keyframe order and fusion frees slots rather than moving them, so a
    slot never changes rank;
  - every rank keeps the same host mirror of the whole store; per window
    only the slots the host changed since the last solve (a diff against
    the mirror) are uploaded, each by the rank that owns it;
  - the solve is `ba.run_ba(..., group=)` on the resident blocks; the
    refined points stay on the ranks, and only the window's free points
    are gathered back into the host map, identically on every rank.

Shapes are bucketed to powers of two (the dirty upload, the observations,
the gather) so that the device work sees few distinct shapes.
`pipeline.slam.run_slam` drives this through the `ba_fn.resident`
protocol (see `ResidentBA.solve`).

The device work is three pure functions, each the counterpart of one of
the reference's compiled programs: `_scatter` (its `scat`, keyed
("scatter", cap)), `_solve` (its `shard_map` of `run_ba_impl`, keyed
("solve", Mw, Ns, iters, n_cg)) and `_gather` (its `gath`, keyed
("gather", capg)).  `_scatter_jit`, `_solve_jit` and `_gather_jit` are
their captures (`core/graphs.py`, on NCCL only); `ResidentBAJit` calls
them, `ResidentBA` the eager functions, and `resident_ba_class` picks the
class for a device and a backend before the first solve.  Every rank
captures the same signatures in the same order, as NCCL needs: the
bucketed sizes (cap, Ns, capg) come from counts every rank computes alike
(the mirror diff, the observations of every rank, the window's free
points), and whether a scatter or gather runs at all from the same
counts.  The host work stays
outside the programs, as in the reference: the mirror diff, the
bucketing, the pinned uploads and the one pull.  The reference donates
the block to its programs; here each returns a new block, a copy of Ps x
3 floats a call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.graphs import graphed
from ..optim import ba
from ..pipeline.slam import _pull, _upload
from . import comm

__all__ = ["ResidentBA", "ResidentBAJit", "resident_ba_class"]


def _pow2(n: int, floor: int = 256) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def _scatter(pts: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The block pts [Ps + 1, 3] with rows idx set to vals, a new tensor."""
    return pts.index_copy(0, idx, vals)


def _solve(cams, pts, intr, cam_idx, pt_idx, uv, w, pt_fixed, iters: int, n_cg: int, group):
    """`ba.run_ba` of this rank's block (its points pts[:Ps], their
    observations, every camera; the camera sums all-reduced over `group`)
    -> (cameras, the new block [Ps + 1, 3] with the sink row kept, cost)."""
    Ps = pts.shape[0] - 1
    prob = ba.BAProblem(cams=cams, points=pts[:Ps], intrinsics=intr, cam_idx=cam_idx,
                        pt_idx=pt_idx, uv=uv, w=w, pt_fixed=pt_fixed)
    st = ba.run_ba(prob, iters=iters, n_cg=n_cg, fix_first_cam=True, group=group)
    return st.cams, torch.cat([st.points, pts[Ps:]]), st.cost


def _gather(pts: torch.Tensor, local: torch.Tensor, owner: torch.Tensor, group) -> torch.Tensor:
    """Rows of every rank's block, each from its owner: rank r gives its
    rows `local` (the sink row where it does not own the slot), every rank
    gathers all ranks' and takes slot i from rank owner[i] -> [capg, 3]."""
    n = comm.world_size(group)
    rows = comm.all_gather_rows(pts[local], group)
    return rows.view(n, local.shape[0], 3)[owner, torch.arange(local.shape[0],
                                                                device=pts.device)]


# the reference's three programs, captured on CUDA inputs (`core/graphs.py`)
_scatter_jit = graphed(_scatter, "_scatter_jit")
_solve_jit = graphed(_solve, "_solve_jit")
_gather_jit = graphed(_gather, "_gather_jit")


class ResidentBA:
    """Rank-resident map-point store + windowed distributed BA, a
    `run_slam(ba_fn=...)` solver of the `resident` protocol; its device
    work runs eagerly."""

    resident = True
    scatter, solver, gather = staticmethod(_scatter), staticmethod(_solve), staticmethod(_gather)

    def __init__(self, group=None, device="cuda"):
        self.group = comm.resolve(group)
        self.n = comm.world_size(self.group)
        self.rank = comm.rank(self.group)
        self.device = torch.device(device)
        # this rank's block [Ps + 1, 3]; row Ps is a sink for the padding
        # entries and the other ranks' slots of a bucketed upload
        self.pts: Optional[torch.Tensor] = None
        self.mirror: Optional[np.ndarray] = None   # host copy of the whole store
        self.Ps = 0
        self._intr: Optional[torch.Tensor] = None

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        (t,) = _upload(self.device, a, dtype=dtype)
        return t

    # ---------------------------------------------------------------- state
    def _ensure(self, map_X: np.ndarray) -> None:
        M = map_X.shape[0]
        Ps = -(-M // self.n)
        if self.pts is not None and Ps == self.Ps:
            return
        self.Ps = Ps
        pad = np.zeros((self.n * Ps + 1, 3), np.float32)
        pad[:M] = map_X
        blk = np.concatenate([pad[self.rank * Ps:(self.rank + 1) * Ps], np.zeros((1, 3), np.float32)])
        self.pts = self._t(blk)
        self.mirror = np.array(map_X, np.float32)

    def _upload_dirty(self, map_X: np.ndarray) -> int:
        """Upload the slots the host changed since the mirror (each rank its
        own).  Returns the number of changed slots, the same on every rank."""
        diff = np.nonzero((map_X != self.mirror).any(axis=1))[0]
        if len(diff) == 0:
            return 0
        cap = _pow2(len(diff))
        idx = np.full(cap, self.Ps, np.int64)       # the sink row
        vals = np.zeros((cap, 3), np.float32)       # 0 into the sink: no index gets two values
        own = diff // self.Ps == self.rank
        idx[: len(diff)][own] = diff[own] - self.rank * self.Ps
        vals[: len(diff)][own] = map_X[diff[own]]
        self.pts = self.scatter(self.pts, self._t(idx, torch.int64), self._t(vals))
        self.mirror[diff] = map_X[diff]
        return len(diff)

    # ---------------------------------------------------------------- solve
    def solve(self, cams, obs_c, obs_p, obs_uv, pt_fixed_host, map_X, iters: int, n_cg: int):
        """Windowed BA over the resident blocks.

        cams: [Mw, 6] window poses; obs_c / obs_p / obs_uv: the window's
        observation lists (obs_p are GLOBAL map slots); pt_fixed_host: [M]
        bool; map_X: [M, 3] host map, mutated in place with the refined
        free points.  Returns (new cams [Mw, 6] NumPy, cost float)."""
        self._ensure(map_X)
        self._upload_dirty(map_X)

        obs_c = np.asarray(obs_c, np.int32)
        obs_p = np.asarray(obs_p, np.int64)
        obs_uv = np.asarray(obs_uv, np.float32)
        owner = obs_p // self.Ps
        counts = np.bincount(owner, minlength=self.n)
        Ns = _pow2(int(counts.max()) if len(counts) else 1)
        sel = np.nonzero(owner == self.rank)[0]
        k = len(sel)
        cam_s = np.zeros(Ns, np.int32)
        pt_s = np.zeros(Ns, np.int32)
        uv_s = np.zeros((Ns, 2), np.float32)
        w_s = np.zeros(Ns, np.float32)
        cam_s[:k] = obs_c[sel]
        pt_s[:k] = obs_p[sel] - self.rank * self.Ps
        uv_s[:k] = obs_uv[sel]
        w_s[:k] = 1.0
        M = map_X.shape[0]
        fx = np.zeros(self.n * self.Ps, bool)
        fx[:M] = pt_fixed_host
        fx_s = fx[self.rank * self.Ps:(self.rank + 1) * self.Ps]

        new_cams, self.pts, cost = self.solver(
            self._t(np.asarray(cams, np.float32)), self.pts, self._intr,
            self._t(cam_s, torch.int32), self._t(pt_s, torch.int32), self._t(uv_s),
            self._t(w_s), self._t(fx_s, torch.bool), iters, n_cg, self.group)

        # gather back ONLY the window's free points: each rank gives its
        # rows of the slots it owns (the sink row for the others), and
        # every rank takes each slot from its owner's rows
        touched = np.unique(obs_p[~pt_fixed_host[obs_p]])
        if not len(touched):
            new_cams, cost = _pull(new_cams, cost)
            return np.array(new_cams), float(cost)
        capg = _pow2(len(touched))
        gidx = np.full(capg, touched[0], np.int64)
        gidx[: len(touched)] = touched
        g_owner = gidx // self.Ps
        local = np.where(g_owner == self.rank, gidx - self.rank * self.Ps, self.Ps)
        vals = self.gather(self.pts, self._t(local, torch.int64), self._t(g_owner, torch.int64),
                           self.group)
        new_cams, cost, vals = _pull(new_cams, cost, vals)
        map_X[touched] = vals[: len(touched)]
        self.mirror[touched] = vals[: len(touched)]
        return np.array(new_cams), float(cost)

    def set_intrinsics(self, intr) -> None:
        self._intr = self._t(np.asarray(intr, np.float32))


class ResidentBAJit(ResidentBA):
    """`ResidentBA` on the captured programs (`_scatter_jit`, `_solve_jit`,
    `_gather_jit`): the counterpart of the reference's `ResidentBA`, whose
    programs are always compiled.  On the card its group must be NCCL's
    (a gloo group raises before any collective runs); on the CPU it runs
    the eager functions."""

    scatter, solver, gather = _scatter_jit, _solve_jit, _gather_jit


def resident_ba_class(device, backend: Optional[str]) -> type:
    """The resident store's class for a group of `backend` (None: one
    process) on `device`: `ResidentBAJit`, the reference's compiled
    programs, but for a group other than NCCL's on the card, whose
    collectives a CUDA graph cannot hold (`core.graphs.check_backends`
    would raise): that keeps `ResidentBA`'s eager programs.  On the CPU
    `ResidentBAJit` runs the eager functions, on any backend."""
    if torch.device(device).type == "cuda" and backend not in (None, "nccl"):
        return ResidentBA
    return ResidentBAJit
