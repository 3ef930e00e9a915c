"""Small symmetric eigendecompositions and 3 x 3 SVDs without a host sync:
CUDA kernel + plain version.

Replaces no TPU kernel: the reference computes these with XLA
(`jnp.linalg.eigh` / `jnp.linalg.svd` in `siftgpu_tpu/geometry/`).  On the
card `torch.linalg.eigh` and `torch.linalg.svd` read cuSOLVER's `info` on
the host, so the two-view geometry synchronised and could not be captured
into a CUDA graph; the kernel (`csrc/small_eig.cu`) reads no host value.

- `eigh_sym(M)`: M [..., n, n] f32, n in {3, 4, 9}, symmetric (its lower
  triangle is read) -> (w [..., n] ascending, V [..., n, n] with the
  orthonormal eigenvectors in its columns), as `torch.linalg.eigh`.
- `svd3(A)`: A [..., 3, 3] f32 -> (U, S descending, Vh), as
  `torch.linalg.svd(A, full_matrices=True)`.

Routes.  CUDA tensors go through the kernel, eager and captured alike; a
build or launch failure raises (no cuSOLVER fallback).  CPU tensors take
`torch.linalg.eigh` / `svd` as they are: the CPU tests hold the geometry to
the reference through those calls, and the bootstrap's RANSAC refit rests
on their rounding where hypotheses tie (ROADMAP §3), so the CPU route is
not moved.  `eigh_sym_plain` / `svd3_plain` are the kernel's plain version,
a step-by-step float64 mirror of its Jacobi (the algorithm and its
conventions are in `csrc/small_eig.cu`'s header: cyclic sweeps for n = 3,
4, sweeps of the round-robin rounds `ROUNDS9` for n = 9, eigenvalues by a
stable sort, each eigenvector's largest-magnitude component positive, U's
columns from A V, the third a cross product); built with -fmad=false, the
kernel gives their bits.  The tests and `chip_smoke.py` use them; the main
path does not.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["eigh_sym", "svd3", "eigh_sym_plain", "svd3_plain", "KERNEL", "SIZES", "ROUNDS9"]

SIZES = (3, 4, 9)        # the n the kernel is compiled for
MAX_SWEEPS = 20
TOL = 1e-30              # a matrix stops when its off-diagonal squares <= TOL x diagonal squares
RANK = 1e-13             # svd3: a second singular vector below RANK x s_1 is completed

# n = 9: a sweep is 9 rounds of 5 disjoint pairs of 0..9 (the kernel's
# kRounds9); round r pairs r with the pad index 9 (no rotation) and
# (r + k) mod 9 with (r - k) mod 9 for k = 1..4, each as (p < q)
ROUNDS9 = tuple(((r, 9),) + tuple((min((r + k) % 9, (r - k) % 9), max((r + k) % 9, (r - k) % 9))
                                  for k in range(1, 5)) for r in range(9))

KERNEL = _build.Kernel(
    "small_eig", "small_eig.cu",
    {"small_eigh_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
     "small_svd3_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]},
    flags=["-fmad=false"],
)

_F64 = torch.float64


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernel's: torch's
    vectorised float64 sqrt on the CPU is off by one ulp on ~0.7% of
    inputs, NumPy's (and the card's) is not."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _rotation(app, aqq, apq):
    """(c, s) of the Jacobi rotation that zeroes a_pq, elementwise."""
    theta = (aqq - app) / (2.0 * apq)
    t = 1.0 / (theta.abs() + _sqrt(theta * theta + 1.0))
    t = torch.where(theta < 0.0, -t, t)
    c = 1.0 / _sqrt(t * t + 1.0)
    return c, t * c


def _jacobi(a: torch.Tensor, v: torch.Tensor):
    """The kernel's Jacobi on a, v [B, N, N] float64, in place: cyclic
    sweeps (`jacobi`) for N = 3, 4, the rounds of `ROUNDS9` (`eigh9_warp`)
    for N = 9.  Returns the convergence tests and the rotations it made,
    summed over the batch."""
    B, N, _ = a.shape
    pairs = [(p, q) for p in range(N - 1) for q in range(p + 1, N)]
    active = torch.ones(B, dtype=torch.bool, device=a.device)
    tests = rotations = 0
    for _ in range(MAX_SWEEPS):
        tests += int(active.sum())
        off = torch.zeros(B, dtype=_F64, device=a.device)
        dd = torch.zeros_like(off)
        for p, q in pairs:
            off = off + a[:, p, q] * a[:, p, q]
        for i in range(N):
            dd = dd + a[:, i, i] * a[:, i, i]
        active = active & ~(off <= TOL * dd)
        if not bool(active.any()):
            break
        if N == 9:
            rotations += _sweep9(a, v, active)
            continue
        for p, q in pairs:
            apq = a[:, p, q].clone()
            rot = active & (apq != 0.0)
            rotations += int(rot.sum())
            c, s = _rotation(a[:, p, p], a[:, q, q], apq)
            r, c, s = rot[:, None], c[:, None], s[:, None]
            for idx in ((slice(None), slice(None), p), (slice(None), slice(None), q)), \
                    ((slice(None), p, slice(None)), (slice(None), q, slice(None))):
                xp, xq = a[idx[0]].clone(), a[idx[1]].clone()
                a[idx[0]] = torch.where(r, c * xp - s * xq, xp)
                a[idx[1]] = torch.where(r, s * xp + c * xq, xq)
            a[:, p, q] = torch.where(rot, 0.0, a[:, p, q])
            a[:, q, p] = torch.where(rot, 0.0, a[:, q, p])
            vp, vq = v[:, :, p].clone(), v[:, :, q].clone()
            v[:, :, p] = torch.where(r, c * vp - s * vq, vp)
            v[:, :, q] = torch.where(r, s * vp + c * vq, vq)
    return tests, rotations


def _round9_tables(r: int):
    """Round r's index tables over 0..8: each index's slot (0 for the one
    paired with the pad), its partner (itself for slot 0) and whether it is
    its pair's p."""
    slot, partner, is_p = [0] * 9, list(range(9)), [False] * 9
    for k, (p, q) in enumerate(ROUNDS9[r]):
        if q == 9:
            continue
        slot[p] = slot[q] = k
        partner[p], partner[q] = q, p
        is_p[p] = True
    return slot, partner, is_p


def _rotate(x, xp, c, s, rot, is_p):
    """x's entries of a rotated pair: c x - s x' where x is the pair's p,
    s x' + c x where it is q (x' its partner's entry); x where not rotated."""
    return torch.where(rot, torch.where(is_p, c * x - s * xp, s * xp + c * x), x)


def _sweep9(a: torch.Tensor, v: torch.Tensor, active: torch.Tensor) -> int:
    """One sweep of the kernel's `eigh9_warp` on a, v [B, 9, 9] float64, in
    place, for the `active` matrices: per round the 4 rotations from the
    round's A, then every entry of R^T (A R) (columns first) and of V R,
    the blocks of slots i > j taken as the transposes of blocks (j, i), a
    rotated pair's a_pq, a_qp set to 0.  Returns the rotations made."""
    dev = a.device
    rotations = 0
    for r in range(9):
        slot, partner, is_p = (torch.tensor(t, device=dev) for t in _round9_tables(r))
        P = torch.tensor([p for p, _ in ROUNDS9[r][1:]], device=dev)
        Q = torch.tensor([q for _, q in ROUNDS9[r][1:]], device=dev)
        apq = a[:, P, Q]
        rot = active[:, None] & (apq != 0.0)                          # [B, 4], slots 1..4
        rotations += int(rot.sum())
        c, s = _rotation(a[:, P, P], a[:, Q, Q], apq)
        pad = lambda t, fill: torch.cat([torch.full_like(t[:, :1], fill), t], 1)[:, slot]
        c, s, rot = pad(c, 1.0), pad(s, 0.0), pad(rot, False)         # [B, 9] by index
        cols = lambda t: t[:, None, :]
        rows = lambda t: t[:, :, None]
        b = _rotate(a, a[:, :, partner], cols(c), cols(s), cols(rot), is_p[None, :])
        a_new = _rotate(b, b[:, partner, :], rows(c), rows(s), rows(rot), is_p[:, None])
        own = (slot[:, None] == slot[None, :]) & ~torch.eye(9, dtype=torch.bool, device=dev)
        a_new = torch.where(own & rows(rot), 0.0, a_new)
        upper = slot[:, None] <= slot[None, :]
        a.copy_(torch.where(upper, a_new, a_new.transpose(-1, -2)))
        v.copy_(_rotate(v, v[:, :, partner], cols(c), cols(s), cols(rot), is_p[None, :]))
    return rotations


def _eigh_sorted(a: torch.Tensor, counts: list | None = None):
    """The kernel's `eigh_sorted`: (w [B, N] ascending, vs [B, N, N]) in
    float64 from the symmetric a [B, N, N] float64 (overwritten); appends
    `_jacobi`'s counts to `counts` where given."""
    B, N, _ = a.shape
    v = torch.eye(N, dtype=_F64, device=a.device).repeat(B, 1, 1)
    n = _jacobi(a, v)
    if counts is not None:
        counts.append(n)
    w, perm = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1, stable=True)
    vs = torch.gather(v, 2, perm[:, None, :].expand(B, N, N))
    big = torch.argmax(vs.abs(), dim=1, keepdim=True)                 # [B, 1, N]
    neg = torch.gather(vs, 1, big) < 0.0
    return w, torch.where(neg, -vs, vs)


def eigh_sym_plain(M: torch.Tensor, counts: list | None = None):
    """Plain version of the kernel's eigh; see `eigh_sym` for the contract.
    `counts`, where given, receives (convergence tests, rotations) summed
    over the batch: the work this input needs (`bounds.small_eig_work`)."""
    n = M.shape[-1]
    lead = M.shape[:-2]
    m = M.reshape(-1, n, n).to(_F64)
    lower = torch.ones(n, n, dtype=torch.bool, device=M.device).tril()
    w, vs = _eigh_sorted(torch.where(lower, m, m.transpose(-1, -2)), counts)
    return (w.to(torch.float32).reshape(*lead, n),
            vs.to(torch.float32).reshape(*lead, n, n))


def _dot3(x, y):
    return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]


def svd3_plain(A: torch.Tensor, counts: list | None = None):
    """Plain version of the kernel's svd3; see `svd3` for the contract
    (`counts` as `eigh_sym_plain`'s, of its A^T A)."""
    lead = A.shape[:-2]
    x = A.reshape(-1, 3, 3).to(_F64)
    B = x.shape[0]
    g = torch.stack([torch.stack([
        x[:, 0, i] * x[:, 0, j] + x[:, 1, i] * x[:, 1, j] + x[:, 2, i] * x[:, 2, j]
        for j in range(3)], -1) for i in range(3)], -2)
    _, vs = _eigh_sorted(g, counts)
    v = vs.flip(-1).transpose(-1, -2)                                  # [B, j, k]: rows v_j
    bc = torch.stack([torch.stack([
        x[:, r, 0] * v[:, j, 0] + x[:, r, 1] * v[:, j, 1] + x[:, r, 2] * v[:, j, 2]
        for r in range(3)], -1) for j in range(3)], 1)                 # [B, j, r]: A v_j
    n1 = _sqrt(_dot3(bc[:, 0], bc[:, 0]))
    e = torch.eye(3, dtype=_F64, device=A.device)
    u0 = torch.where((n1 > 0.0)[:, None], bc[:, 0] / n1[:, None], e[0])
    d = _dot3(u0, bc[:, 1])
    rr = bc[:, 1] - d[:, None] * u0
    n2 = _sqrt(_dot3(rr, rr))
    k = torch.argmin(u0.abs(), dim=1)
    uk = torch.gather(u0, 1, k[:, None])
    done = e[k] - uk * u0
    rr = torch.where((n2 > RANK * n1)[:, None], rr, done)
    u1 = rr / _sqrt(_dot3(rr, rr))[:, None]
    u2 = torch.stack([u0[:, 1] * u1[:, 2] - u0[:, 2] * u1[:, 1],
                      u0[:, 2] * u1[:, 0] - u0[:, 0] * u1[:, 2],
                      u0[:, 0] * u1[:, 1] - u0[:, 1] * u1[:, 0]], -1)
    d3 = _dot3(u2, bc[:, 2])
    u2 = torch.where((d3 < 0.0)[:, None], -u2, u2)
    d3 = torch.where(d3 < 0.0, -d3, d3)
    s1 = torch.fmin(n2, n1)
    S = torch.stack([n1, s1, torch.fmin(d3, s1)], -1)
    U = torch.stack([u0, u1, u2], -1)
    f32 = torch.float32
    return (U.to(f32).reshape(*lead, 3, 3), S.to(f32).reshape(*lead, 3),
            v.to(f32).reshape(*lead, 3, 3))


def _batch(x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    if x.dim() < 2 or tuple(x.shape[-2:]) != (n, n):
        raise ValueError(f"{name}: expected [..., {n}, {n}], got shape {tuple(x.shape)}")
    x = x.reshape(-1, n, n).contiguous()
    _build.check_tensor(x, name, torch.float32, 3)
    return x


def _eigh_cuda(M: torch.Tensor):
    n = M.shape[-1]
    if n not in SIZES:
        raise ValueError(f"eigh_sym: n = {n}; the kernel is built for n in {SIZES}")
    lead = M.shape[:-2]
    m = _batch(M, n, "M")
    B = m.shape[0]
    w = torch.empty((B, n), dtype=torch.float32, device=m.device)
    V = torch.empty((B, n, n), dtype=torch.float32, device=m.device)
    if B:
        p = _build.ptr
        KERNEL.launch("small_eigh_launch", m.device, p(m), p(w), p(V), B, n)
    return w.reshape(*lead, n), V.reshape(*lead, n, n)


def _svd3_cuda(A: torch.Tensor):
    lead = A.shape[:-2]
    a = _batch(A, 3, "A")
    B = a.shape[0]
    U = torch.empty((B, 3, 3), dtype=torch.float32, device=a.device)
    S = torch.empty((B, 3), dtype=torch.float32, device=a.device)
    Vh = torch.empty_like(U)
    if B:
        p = _build.ptr
        KERNEL.launch("small_svd3_launch", a.device, p(a), p(U), p(S), p(Vh), B)
    return U.reshape(*lead, 3, 3), S.reshape(*lead, 3), Vh.reshape(*lead, 3, 3)


def eigh_sym(M: torch.Tensor):
    """(w, V) of the symmetric M [..., n, n] f32: eigenvalues ascending,
    orthonormal eigenvectors in V's columns.  CPU: `torch.linalg.eigh`;
    CUDA: the kernel (n in {3, 4, 9}, the lower triangle read)."""
    if M.device.type == "cpu":
        return torch.linalg.eigh(M)
    return _eigh_cuda(M)


def svd3(A: torch.Tensor):
    """(U, S, Vh) of A [..., 3, 3] f32, S descending, A = U diag(S) Vh.
    CPU: `torch.linalg.svd`; CUDA: the kernel."""
    if A.device.type == "cpu":
        return torch.linalg.svd(A)
    return _svd3_cuda(A)
