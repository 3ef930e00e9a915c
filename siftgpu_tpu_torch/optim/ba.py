"""Bundle adjustment: Levenberg-Marquardt with a matrix-free Schur complement.

Port of `siftgpu_tpu/optim/ba.py`.  The reduced camera system
S = H_cc - W H_pp^-1 W^T is never materialized: S @ x is evaluated per
observation with segment sums (`Segments`).  Structure-of-arrays problem
layout, fixed shapes, the LM loop and the CG loop as Python loops with
accept/reject as `torch.where` — no host sync inside.  Gauge: camera 0 is
frozen.

Differences from the reference:
  - the Jacobians are closed form (d(R X)/dw = -[R X]x J_l(w), J_l the left
    Jacobian of SO(3)) instead of `jax.jacfwd`; they follow the same
    branches (R = I + [w]x below theta = 1e-8, the depth clamp at 1e-9);
  - the reference's `psum_axis` hook is `group=` (a `torch.distributed`
    process group): each rank holds its own block of points and their
    observations, the cameras are replicated, and the five camera-side
    sums the reference `psum`s (bc, Hcc, S's camera sum, the reduced
    right-hand side, the cost) are sum-all-reduced over the group
    (`all_reduce_sum`); the point-side sums stay local.  The loop counts
    are fixed and accept/reject is a `torch.where` on the reduced cost, so
    every rank makes the same collective calls in the same order;
  - every contraction runs with TF32 off (`full_f32`), the reference's
    "highest";
  - the segment sums add each segment's rows in their original order
    (a stable sort of the index, then `torch.segment_reduce`), not with
    float atomics: the same inputs give the same bits on every run, on the
    card as on the CPU, where they equal an index-add in row order bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.graphs import count_collective, graphed
from ..core.precision import full_f32
from ..geometry.pose import _so3_left_jacobian, exp_so3, hat

__all__ = [
    "BAProblem", "BAState", "Segments", "project", "reprojection_residuals", "schur_solve",
    "run_ba", "run_ba_jit", "refine_points", "refine_points_jit", "all_reduce_sum",
]


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks of `group` (a `torch.distributed` process
    group, each rank holding its own partial sums) into a new tensor; x
    itself when `group` is None.  Each call is counted
    (`core.graphs.count_collective`)."""
    if group is None:
        return x
    out = x.clone()
    count_collective("all_reduce")
    torch.distributed.all_reduce(out, group=group)
    return out


class BAProblem(NamedTuple):
    cams: torch.Tensor        # [M, 6] (so3 rotvec, translation), world->cam
    points: torch.Tensor      # [P, 3]
    intrinsics: torch.Tensor  # [4] fx, fy, cx, cy (shared)
    cam_idx: torch.Tensor     # [N] int
    pt_idx: torch.Tensor      # [N] int
    uv: torch.Tensor          # [N, 2] pixel observations
    w: torch.Tensor           # [N] observation weights (0 masks out)
    # optional [P] bool: FIXED landmarks — their observations still
    # constrain the cameras, but the points themselves do not move
    pt_fixed: Optional[torch.Tensor] = None


class BAState(NamedTuple):
    cams: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor         # LM damping
    cost: torch.Tensor


def _camera_frame(cams, points, prob: BAProblem):
    """Per observation: R [N, 3, 3], X [N, 3] and the camera-frame point
    xc = R X + t [N, 3]."""
    R = exp_so3(cams[:, :3])[prob.cam_idx.long()]
    X = points[prob.pt_idx.long()]
    xc = (R @ X[:, :, None])[:, :, 0] + cams[prob.cam_idx.long(), 3:]
    return R, X, xc


def _pixels(xc, intr):
    """Pinhole projection of camera-frame points [..., 3] -> [..., 2], with
    the depth clamped away from 0 as the reference does."""
    z = xc[..., 2:]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return intr[:2] * xc[..., :2] / z + intr[2:]


def project(cam: torch.Tensor, X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """cam [..., 6], X [..., 3], intr [4] -> pixel [..., 2]."""
    with full_f32():
        xc = (exp_so3(cam[..., :3]) @ X[..., None])[..., 0] + cam[..., 3:]
    return _pixels(xc, intr)


def reprojection_residuals(prob: BAProblem, cams, points) -> torch.Tensor:
    """[N, 2] weighted residuals."""
    with full_f32():
        _, _, xc = _camera_frame(cams, points, prob)
    return (_pixels(xc, prob.intrinsics) - prob.uv) * torch.sqrt(prob.w)[:, None]


def _cost(prob, cams, points, group=None):
    r = reprojection_residuals(prob, cams, points)
    return all_reduce_sum((r * r).sum(), group)


def _proj_jacobian(xc, intr):
    """d pixel / d xc [N, 2, 3] (no weighting); the depth derivative is 0
    where the depth was clamped."""
    z = xc[:, 2]
    live = z.abs() >= 1e-9
    z = torch.where(live, z, torch.full_like(z, 1e-9))
    fx, fy = intr[0], intr[1]
    zero = torch.zeros_like(z)
    dz = torch.where(live, torch.ones_like(z), zero) / (z * z)
    return torch.stack([
        torch.stack([fx / z, zero, -fx * xc[:, 0] * dz], -1),
        torch.stack([zero, fy / z, -fy * xc[:, 1] * dz], -1),
    ], -2)


def _jacobians(prob: BAProblem, cams, points):
    """Per-observation closed-form Jacobians.
    Returns r [N, 2], Jc [N, 2, 6], Jp [N, 2, 3] (weighted)."""
    ci = prob.cam_idx.long()
    with full_f32():
        R, X, xc = _camera_frame(cams, points, prob)
        sw = torch.sqrt(prob.w)[:, None]
        r = (_pixels(xc, prob.intrinsics) - prob.uv) * sw
        Jx = _proj_jacobian(xc, prob.intrinsics) * sw[:, :, None]   # [N, 2, 3]
        wcam = cams[ci, :3]
        theta = torch.linalg.vector_norm(wcam, dim=-1)[:, None, None]
        drot = torch.where(theta < 1e-8, -hat(X),
                           -hat((R @ X[:, :, None])[:, :, 0]) @ _so3_left_jacobian(wcam))
        Jc = torch.cat([Jx @ drot, Jx], dim=-1)                      # [N, 2, 6]
        Jp = Jx @ R                                                  # [N, 2, 3]
    return r, Jc, Jp


def _inv3(A):
    """Batched closed-form 3x3 inverse (adjugate/det) for SPD blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj / det[..., None, None]


class Segments(NamedTuple):
    """The plan of a segment sum over a fixed index: rows in the stable
    order of their segment, and where each segment starts in that order."""
    order: torch.Tensor    # [N] int64
    offsets: torch.Tensor  # [n + 1] int64: segment k is order[offsets[k]:offsets[k+1]]

    @classmethod
    def of(cls, idx: torch.Tensor, n: int) -> "Segments":
        """idx [N] in [0, n).  No host sync: the offsets come from
        `searchsorted` on the sorted index, not from `bincount`."""
        srt, order = torch.sort(idx.long(), stable=True)
        return cls(order, torch.searchsorted(srt, torch.arange(n + 1, device=idx.device)))


def _segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """[N, ...] -> [n, ...]: each segment's rows summed in their original
    order, from 0 (empty segments give 0)."""
    return torch.segment_reduce(x[seg.order], "sum", offsets=seg.offsets, unsafe=True)


def _nonzero(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def schur_solve(r, Jc, Jp, cam_idx, pt_idx, M: int, P: int, lam, gauge_mask,
                n_cg: int = 30, pt_fixed: Optional[torch.Tensor] = None, segments=None,
                group=None):
    """Solve the damped normal equations via Schur complement + PCG.
    Returns (dcam [M, 6], dpt [P, 3]).  `gauge_mask` [M] zeroes frozen
    cameras.  `segments`: the (camera, point) `Segments` of cam_idx and
    pt_idx, made here when not given.  `group`: the camera-side sums are
    all-reduced over it (points and observations are this rank's block)."""
    ci, pi = cam_idx.long(), pt_idx.long()
    red = lambda x: all_reduce_sum(x, group)
    sc, sp = segments or (Segments.of(ci, M), Segments.of(pi, P))
    ein = torch.einsum
    with full_f32():
        # gradient blocks
        bc = red(_segment_sum(-ein("nij,ni->nj", Jc, r), sc))          # [M, 6]
        bp = _segment_sum(-ein("nij,ni->nj", Jp, r), sp)               # [P, 3]
        # block diagonals (damped)
        eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
        eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
        Hcc = red(_segment_sum(ein("nij,nik->njk", Jc, Jc), sc)) + lam * eye6
        Hpp = _segment_sum(ein("nij,nik->njk", Jp, Jp), sp) + lam * eye3
        Hpp_inv = _inv3(Hpp)
        if pt_fixed is not None:
            # fixed landmarks: no marginalization block, dpt = 0, and their
            # observations act as pure camera constraints
            Hpp_inv = torch.where(pt_fixed[:, None, None], torch.zeros_like(Hpp_inv), Hpp_inv)
        gm = gauge_mask[:, None].to(bc.dtype)

        def S_matvec(x):                                               # x: [M, 6]
            u = ein("nij,nj->ni", Jc, x[ci])                           # [N, 2]
            v = _segment_sum(ein("nij,ni->nj", Jp, u), sp)             # [P, 3]
            y = ein("pij,pj->pi", Hpp_inv, v)
            wv = ein("nij,nj->ni", Jp, y[pi])
            out = red(_segment_sum(ein("nij,ni->nj", Jc, u - wv), sc))
            return (out + lam * x) * gm

        # reduced RHS: bc - W Hpp^-1 bp
        yb = ein("pij,pj->pi", Hpp_inv, bp)
        wb = ein("nij,nj->ni", Jp, yb[pi])
        rhs = (bc - red(_segment_sum(ein("nij,ni->nj", Jc, wb), sc))) * gm

        # PCG with a block-Jacobi (6x6 Hcc) preconditioner; inv_ex does not
        # check the (damped, SPD) blocks on the host, so nothing synchronises
        Minv = torch.linalg.inv_ex(Hcc)[0]

        def precond(v):
            return ein("mij,mj->mi", Minv, v) * gm

        x = torch.zeros_like(rhs)
        rr = rhs
        p = precond(rhs)
        rz = (rhs * p).sum()
        for _ in range(n_cg):
            Ap = S_matvec(p)
            alpha = rz / _nonzero((p * Ap).sum(), 1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = (rr * z).sum()
            p = z + rz_new / _nonzero(rz, 1e-20) * p
            rz = rz_new

        # back-substitute points: dp = Hpp^-1 (bp - W^T dcam)
        u = ein("nij,nj->ni", Jc, x[ci])
        wtd = _segment_sum(ein("nij,ni->nj", Jp, u), sp)
        dpt = ein("pij,pj->pi", Hpp_inv, bp - wtd)
    return x, dpt


def run_ba(prob: BAProblem, iters: int = 10, n_cg: int = 30,
           fix_first_cam: bool = True, lam0: float = 1e-3, group=None) -> BAState:
    """LM loop with multiplicative accept/reject damping, `iters` steps of
    `n_cg` CG iterations each; the decisions stay on the device.  With
    `group` the problem is this rank's block (its points and their
    observations, all the cameras): the camera-side sums and the cost are
    all-reduced, so every rank takes the same steps and ends with the same
    cameras and cost, and its own refined points."""
    M, P = prob.cams.shape[0], prob.points.shape[0]
    dev, dt = prob.cams.device, prob.cams.dtype
    # 0 for a frozen camera 0, made on the device: assigning a host scalar
    # into a device tensor would synchronise
    gauge = (torch.arange(M, device=dev) >= int(fix_first_cam)).to(dt)
    segments = (Segments.of(prob.cam_idx, M), Segments.of(prob.pt_idx, P))
    state = BAState(cams=prob.cams, points=prob.points,
                    lam=torch.full((), lam0, dtype=torch.float32, device=dev),
                    cost=_cost(prob, prob.cams, prob.points, group))
    for _ in range(iters):
        r, Jc, Jp = _jacobians(prob, state.cams, state.points)
        dcam, dpt = schur_solve(r, Jc, Jp, prob.cam_idx, prob.pt_idx, M, P, state.lam,
                                gauge, n_cg, pt_fixed=prob.pt_fixed, segments=segments,
                                group=group)
        new_cams = state.cams + dcam
        new_pts = state.points + dpt
        new_cost = _cost(prob, new_cams, new_pts, group)
        accept = new_cost < state.cost
        lam = torch.where(accept, state.lam * 0.3, state.lam * 4.0)
        state = BAState(
            cams=torch.where(accept, new_cams, state.cams),
            points=torch.where(accept, new_pts, state.points),
            lam=torch.clamp(lam, 1e-9, 1e6),
            cost=torch.where(accept, new_cost, state.cost),
        )
    return state


# the reference's jitted `run_ba`: captured once per signature on CUDA
# inputs (`core/graphs.py`), the `Segments` plan inside the capture
run_ba_jit = graphed(run_ba, "run_ba_jit")


def refine_points(prob: BAProblem, iters: int = 3, huber_px: float = 3.0) -> torch.Tensor:
    """Points-only Gauss-Newton refit with the CAMERAS FIXED (Huber IRLS):
    per-point 3x3 damped normal equations, one segment sum per iteration.
    Returns the refined [P, 3] points (unobserved points keep theirs)."""
    Pn = prob.points.shape[0]
    sp = Segments.of(prob.pt_idx, Pn)
    points = prob.points
    with full_f32():
        for _ in range(iters):
            R, _, xc = _camera_frame(prob.cams, points, prob)
            r = _pixels(xc, prob.intrinsics) - prob.uv
            Jp = _proj_jacobian(xc, prob.intrinsics) @ R                # [N, 2, 3]
            rn = torch.linalg.vector_norm(r, dim=1)
            rn = torch.clamp(rn, min=1e-9)
            w = prob.w * torch.clamp(torch.full_like(rn, huber_px) / rn, max=1.0)
            bp = _segment_sum(-torch.einsum("nij,ni->nj", Jp, r * w[:, None]), sp)
            Hpp = _segment_sum(w[:, None, None] * torch.einsum("nij,nik->njk", Jp, Jp), sp)
            Hpp = Hpp + 1e-4 * torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
            dpt = torch.einsum("pij,pj->pi", _inv3(Hpp), bp)
            # guard: a point with degenerate observations must not fly away
            points = points + torch.clamp(dpt, -1e3, 1e3)
    return points


# the reference's jitted `refine_points` (`iters` static; `huber_px`, a
# Python float, is keyed by value): one capture per padded problem bucket.
# A weight-0 row adds nothing to its point's system, so a point observed
# only by such rows keeps its coordinates (its Hpp is 1e-4 I, its bp 0)
refine_points_jit = graphed(refine_points, "refine_points_jit")
