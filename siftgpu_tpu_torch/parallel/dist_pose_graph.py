"""Distributed pose-graph optimisation: edges sharded over the ranks.

Port of `siftgpu_tpu/parallel/dist_pose_graph.py`.  The edges are padded
with weight-0 edges to a multiple of the world size; each rank takes its
contiguous slice and runs the one-process optimizer with `group=`, which
all-reduces the normal equations (dense solvers: H and b per GN
iteration; PCG: O(M) vectors per CG step and the 7x7 diagonal blocks).
The poses are replicated, so every rank ends with the same graph.
"""

from __future__ import annotations

import torch

from ..optim import pose_graph as pg
from . import comm

__all__ = [
    "partition_edges", "optimize_pose_graph_distributed",
    "optimize_pose_graph_sim3_distributed", "optimize_pose_graph_sim3_cg_distributed",
]


def partition_edges(g, n_shards: int):
    """Pad the edges to a multiple of n_shards with weight-0 edges (0 -> 0,
    a zero measurement); the poses are untouched."""
    pad = (-g.edge_i.shape[0]) % n_shards
    if not pad:
        return g
    z = lambda a: torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                                            device=a.device)])
    return g._replace(edge_i=z(g.edge_i), edge_j=z(g.edge_j), t_meas=z(g.t_meas),
                      weight=z(g.weight))


def _local(g, group):
    """(the padded graph, this rank's contiguous slice of its edges)."""
    n, r = comm.world_size(group), comm.rank(group)
    g = partition_edges(g, n)
    e = g.edge_i.shape[0] // n
    sl = slice(r * e, (r + 1) * e)
    return g, g._replace(edge_i=g.edge_i[sl], edge_j=g.edge_j[sl], t_meas=g.t_meas[sl],
                         weight=g.weight[sl])


def optimize_pose_graph_distributed(g: pg.PoseGraph, group=None, iters: int = 10,
                                    lam: float = 1e-5, fix_first: bool = True):
    """SE(3): edges sharded, poses replicated.  Returns (the padded graph
    with the optimised poses, costs [iters])."""
    g, local = _local(g, group)
    out, costs = pg.optimize_pose_graph(local, iters=iters, lam=lam, fix_first=fix_first,
                                        group=comm.resolve(group))
    return g._replace(poses=out.poses), costs


def optimize_pose_graph_sim3_distributed(g: pg.Sim3PoseGraph, group=None, iters: int = 10,
                                         lam: float = 1e-5, fix_first: bool = True,
                                         n_fix: int = 1):
    """Sim(3), dense normal equations: one all-reduce of (H, b) per GN
    iteration."""
    g, local = _local(g, group)
    out, costs = pg.optimize_pose_graph_sim3(local, iters=iters, lam=lam, fix_first=fix_first,
                                             n_fix=n_fix, group=comm.resolve(group))
    return g._replace(poses=out.poses), costs


def optimize_pose_graph_sim3_cg_distributed(g: pg.Sim3PoseGraph, group=None, iters: int = 10,
                                            lam: float = 1e-5, fix_first: bool = True,
                                            n_cg: int = 60, n_fix: int = 1):
    """Sim(3), matrix-free PCG: every all-reduce is an O(M) vector ([M, 7]
    per CG step, [M, 7, 7] once per GN iteration), never a dense H."""
    g, local = _local(g, group)
    out, costs = pg.optimize_pose_graph_sim3_cg(local, iters=iters, lam=lam, fix_first=fix_first,
                                                n_cg=n_cg, n_fix=n_fix,
                                                group=comm.resolve(group))
    return g._replace(poses=out.poses), costs
