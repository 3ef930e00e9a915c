"""Pose-graph optimization over SE(3) and Sim(3).

Port of `siftgpu_tpu/optim/pose_graph.py`: Gauss-Newton on relative-pose
constraints.  For edge (i, j) with measured T_ij, the residual is
log(T_ij_meas^-1 . T_j . T_i^-1), weighted by per-edge scalar information,
under LOCAL left perturbations of both nodes (manifold GN).  SE(3) and Sim(3)
have dense solvers (small normal equations); Sim(3) also has a matrix-free
PCG solver with a 7x7 block-Jacobi preconditioner for long chains.

Differences from the reference:
  - the per-edge Jacobians come from one `torch.func.jvp` over the edges
    repeated once per input direction (the reference: `jax.jacfwd` under
    `jax.vmap`), through the same exp/log maps;
  - `lax.scan` is a Python loop with a fixed count; the costs come back as
    one [iters] tensor;
  - the block sums over edges add each node's rows in edge order
    (`ba.Segments`), not with float atomics, so repeated runs on the card
    give the same bits; the dense systems are solved by
    `torch.linalg.solve_ex` and the preconditioner blocks inverted by
    `inv_ex`, which do not check on the host: nothing synchronises;
  - the reference's `psum_axis` hooks are `group=` (a `torch.distributed`
    process group; each rank holds its own slice of the edges, the poses
    are replicated): the dense solvers all-reduce H and b, the PCG solver
    every O(M) vector ([M, 7] per CG step) and the [M, 7, 7] diagonal
    blocks, and all three the costs (`ba.all_reduce_sum`);
  - contractions run with TF32 off (`full_f32`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jvp

from ..core.graphs import graphed
from ..core.precision import full_f32
from ..geometry import pose as P
from .ba import Segments, _segment_sum, all_reduce_sum

__all__ = [
    "PoseGraph", "optimize_pose_graph", "optimize_pose_graph_jit",
    "Sim3PoseGraph", "optimize_pose_graph_sim3",
    "optimize_pose_graph_sim3_cg", "sim7_to_srt", "srt_to_sim7",
]


class PoseGraph(NamedTuple):
    poses: torch.Tensor   # [M, 6] se3 twists (world->cam_i as exp(xi))
    edge_i: torch.Tensor  # [E] int
    edge_j: torch.Tensor  # [E] int
    t_meas: torch.Tensor  # [E, 6] measured relative twists T_ij (cam_i -> cam_j)
    weight: torch.Tensor  # [E] scalar information (0 masks the edge)


def _edge_residual_local(di, dj, Ri, ti, Rj, tj, Rm, tm):
    """Residual as a function of LOCAL left-multiplicative perturbations
    (T_i <- exp(di) . T_i), evaluated/differentiated at d = 0."""
    dRi, dti = P.exp_se3(di)
    dRj, dtj = P.exp_se3(dj)
    Ri2, ti2 = P.compose(dRi, dti, Ri, ti)
    Rj2, tj2 = P.compose(dRj, dtj, Rj, tj)
    Rrel, trel = P.relative(Ri2, ti2, Rj2, tj2)
    Rminv, tminv = P.inverse(Rm, tm)
    Re, te = P.compose(Rminv, tminv, Rrel, trel)
    return P.log_se3(Re, te)


def _linearize(residual, D, states_i, states_j, meas, weight):
    """Per-edge weighted residuals r [E, D] and Jacobians Ji, Jj [E, D, D]
    of `residual(di, dj, *state_i, *state_j, *meas)` at di = dj = 0: one
    forward-mode pass over the edges repeated once per input direction."""
    E = weight.shape[0]
    dev, dt = weight.device, weight.dtype
    tangents = torch.eye(2 * D, dtype=dt, device=dev).repeat_interleave(E, 0)   # [2D E, 2D]
    args = [a.repeat((2 * D,) + (1,) * (a.dim() - 1))
            for a in (*states_i, *states_j, *meas)]

    def f(d):
        return residual(d[:, :D], d[:, D:], *args)

    with full_f32():
        r, dr = jvp(f, (torch.zeros_like(tangents),), (tangents,))
    J = dr.view(2 * D, E, D).permute(1, 2, 0)                                  # [E, D, 2D]
    sw = torch.sqrt(weight)
    return r[:E] * sw[:, None], J[..., :D] * sw[:, None, None], J[..., D:] * sw[:, None, None]


class _Blocks(NamedTuple):
    """Edge-order segment plans for the normal equations of M nodes."""
    pair: Segments   # the 4E (row node, column node) blocks into M * M
    ei: Segments     # edges by i into M
    ej: Segments     # edges by j into M

    @classmethod
    def of(cls, ei, ej, M):
        ei, ej = ei.long(), ej.long()
        pair = torch.cat([ei * M + ei, ej * M + ej, ei * M + ej, ej * M + ei])
        return cls(Segments.of(pair, M * M), Segments.of(ei, M), Segments.of(ej, M))


def _dense_step(r, Ji, Jj, blocks: _Blocks, M, D, lam, n_fix, group=None):
    """Dense damped normal equations, the first `n_fix` nodes frozen, H and
    b summed over `group`; returns dx [M, D]."""
    ein = torch.einsum
    with full_f32():
        ii = ein("eab,eac->ebc", Ji, Ji)
        jj = ein("eab,eac->ebc", Jj, Jj)
        ij = ein("eab,eac->ebc", Ji, Jj)
        Hb = _segment_sum(torch.cat([ii, jj, ij, ij.transpose(-1, -2)]), blocks.pair)
        H = all_reduce_sum(Hb.view(M, M, D, D).permute(0, 2, 1, 3).reshape(M * D, M * D), group)
        b = all_reduce_sum(_segment_sum(-ein("eab,ea->eb", Ji, r), blocks.ei)
                           + _segment_sum(-ein("eab,ea->eb", Jj, r), blocks.ej), group)
    Hf = H + lam * torch.eye(M * D, dtype=H.dtype, device=H.device)
    bf = b.reshape(M * D)
    if n_fix > 0:
        # freeze the first n_fix nodes: zero their rows/cols, identity diagonal
        mask = torch.arange(M * D, device=H.device) >= D * n_fix
        Hf = torch.where(mask[:, None] & mask[None, :], Hf, torch.zeros_like(Hf))
        Hf = Hf + torch.diag(torch.where(mask, 0.0, 1.0).to(Hf.dtype))
        bf = torch.where(mask, bf, torch.zeros_like(bf))
    return torch.linalg.solve_ex(Hf, bf)[0].reshape(M, D)


def optimize_pose_graph(g: PoseGraph, iters: int = 10, lam: float = 1e-5,
                        fix_first: bool = True, group=None) -> Tuple[PoseGraph, torch.Tensor]:
    """SE(3) Gauss-Newton; returns (graph with optimized poses, costs [iters]).
    `group`: the edges are this rank's slice, H, b and the costs are summed
    over the group's ranks."""
    M = g.poses.shape[0]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    blocks = _Blocks.of(ei, ej, M)
    Rm, tm = P.exp_se3(g.t_meas)
    R, t = P.exp_se3(g.poses)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _linearize(_edge_residual_local, 6, (R[ei], t[ei]), (R[ej], t[ej]),
                               (Rm, tm), g.weight)
        dx = _dense_step(r, Ji, Jj, blocks, M, 6, lam, 1 if fix_first else 0, group)
        dR, dt = P.exp_se3(dx)
        R, t = P.compose(dR, dt, R, t)
        costs.append((r * r).sum())
    return g._replace(poses=P.log_se3(R, t)), all_reduce_sum(torch.stack(costs), group)


# the reference's `optimize_pose_graph_jit` (`iters`, `fix_first` static; its
# traced `lam` is a Python float here, keyed by value): captured once per
# signature on CUDA inputs (`core/graphs.py`).  `group` stays None: a gloo
# collective cannot be captured (the capture fails, naming this entry
# point), and capturing NCCL's is left to the rank programs
optimize_pose_graph_jit = graphed(optimize_pose_graph, "optimize_pose_graph_jit")


# ---------------- Sim(3) pose graph (monocular loop closure) ----------------
# Chart convention: a Sim(3) measurement / perturbation is a 7-vector
# [omega(3), t(3), lambda(1)] mapped DIRECTLY to (s, R, t) =
# (e^lambda, exp_so3(omega), t) — a first-order-equivalent chart of the true
# sim(3) exponential (no W-matrix).  `sim7_to_srt` / `srt_to_sim7` define it.


class Sim3PoseGraph(NamedTuple):
    poses: torch.Tensor   # [M, 7] chart coords (world->cam, s x -> s R x + t)
    edge_i: torch.Tensor  # [E] int
    edge_j: torch.Tensor  # [E] int
    t_meas: torch.Tensor  # [E, 7] measured relative transforms S_ij (chart)
    weight: torch.Tensor  # [E] scalar information (0 masks the edge)


def sim7_to_srt(v: torch.Tensor):
    """[..., 7] chart vector -> (s, R, t)."""
    return torch.exp(v[..., 6]), P.exp_so3(v[..., :3]), v[..., 3:6]


def srt_to_sim7(s, R, t) -> torch.Tensor:
    return torch.cat([P.log_so3(R), t, torch.log(s)[..., None]], dim=-1)


def _sim3_edge_residual_local(di, dj, si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """7-dim residual under LOCAL left perturbations (evaluated at d = 0)."""
    S_i = P.compose_sim3(*sim7_to_srt(di), si, Ri, ti)
    S_j = P.compose_sim3(*sim7_to_srt(dj), sj, Rj, tj)
    S_rel = P.relative_sim3(*S_i, *S_j)
    s_e, R_e, t_e = P.compose_sim3(*P.inverse_sim3(sm, Rm, tm), *S_rel)
    return srt_to_sim7(s_e, R_e, t_e)


def _sim3_linearize(g: Sim3PoseGraph, s, R, t):
    """Weight-folded r [E, 7], Ji, Jj [E, 7, 7] at the current estimate."""
    ei, ej = g.edge_i.long(), g.edge_j.long()
    return _linearize(_sim3_edge_residual_local, 7, (s[ei], R[ei], t[ei]),
                      (s[ej], R[ej], t[ej]), sim7_to_srt(g.t_meas), g.weight)


def optimize_pose_graph_sim3(g: Sim3PoseGraph, iters: int = 10, lam: float = 1e-5,
                             fix_first: bool = True, n_fix: int = 1,
                             group=None) -> Tuple[Sim3PoseGraph, torch.Tensor]:
    """Gauss-Newton over (pose, scale) per node, dense normal equations.
    `n_fix` freezes the FIRST n nodes (pose and scale): 1 is the gauge
    anchor, larger values the online loop-correction policy
    (`fix_first=False` forces 0).  `group` as in `optimize_pose_graph`.
    Returns (graph, costs [iters])."""
    M = g.poses.shape[0]
    if not fix_first:
        n_fix = 0
    blocks = _Blocks.of(g.edge_i, g.edge_j, M)
    s, R, t = sim7_to_srt(g.poses)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _sim3_linearize(g, s, R, t)
        dx = _dense_step(r, Ji, Jj, blocks, M, 7, lam, n_fix, group)
        s, R, t = P.compose_sim3(*sim7_to_srt(dx), s, R, t)
        costs.append((r * r).sum())
    return g._replace(poses=srt_to_sim7(s, R, t)), all_reduce_sum(torch.stack(costs), group)


# ------------- scalable Sim(3) pose graph (block-sparse GN + PCG) -----------
# H is never formed: H @ x is evaluated per edge and summed per node,
# preconditioned by the block-Jacobi 7x7 diagonal.


def optimize_pose_graph_sim3_cg(g: Sim3PoseGraph, iters: int = 10, lam: float = 1e-5,
                                fix_first: bool = True, n_cg: int = 60, n_fix: int = 1,
                                group=None) -> Tuple[Sim3PoseGraph, torch.Tensor]:
    """Matrix-free Gauss-Newton: block-sparse H, PCG with 7x7 block-Jacobi.
    Same measurement model and chart as `optimize_pose_graph_sim3`; O(E *
    n_cg) per iteration instead of O(M^3).  `group`: the edges are this
    rank's slice; b, the diagonal blocks, each H @ x and the costs are
    summed over the group's ranks, never a dense H."""
    M, D = g.poses.shape[0], 7
    if not fix_first:
        n_fix = 0
    blocks = _Blocks.of(g.edge_i, g.edge_j, M)
    ei, ej = g.edge_i.long(), g.edge_j.long()
    dev, dt = g.poses.device, g.poses.dtype
    gm = (torch.arange(M, device=dev)[:, None] >= n_fix).to(dt)
    eye = torch.eye(D, dtype=dt, device=dev)
    ein = torch.einsum

    def seg2(a, b):
        return all_reduce_sum(_segment_sum(a, blocks.ei) + _segment_sum(b, blocks.ej), group)

    def nonzero(x):
        return torch.where(x.abs() < 1e-20, torch.full_like(x, 1e-20), x)

    s, R, t = sim7_to_srt(g.poses)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _sim3_linearize(g, s, R, t)
        with full_f32():
            b = seg2(-ein("eab,ea->eb", Ji, r), -ein("eab,ea->eb", Jj, r)) * gm   # [M, 7]
            Hd = seg2(ein("eab,eac->ebc", Ji, Ji), ein("eab,eac->ebc", Jj, Jj)) + lam * eye
            Minv = torch.linalg.inv_ex(Hd)[0]

            def matvec(x):
                xg = x * gm
                z = ein("eab,eb->ea", Ji, xg[ei]) + ein("eab,eb->ea", Jj, xg[ej])    # [E, 7]
                out = seg2(ein("eab,ea->eb", Ji, z), ein("eab,ea->eb", Jj, z))
                return (out + lam * xg) * gm

            def precond(v):
                return ein("mij,mj->mi", Minv, v) * gm

            x = torch.zeros_like(b)
            rr = b
            p = precond(b)
            rz = (b * p).sum()
            for _ in range(n_cg):
                Ap = matvec(p)
                alpha = rz / nonzero((p * Ap).sum())
                x = x + alpha * p
                rr = rr - alpha * Ap
                z = precond(rr)
                rz_new = (rr * z).sum()
                p = z + rz_new / nonzero(rz) * p
                rz = rz_new
        s, R, t = P.compose_sim3(*sim7_to_srt(x * gm), s, R, t)
        costs.append((r * r).sum())
    return g._replace(poses=srt_to_sim7(s, R, t)), all_reduce_sum(torch.stack(costs), group)
