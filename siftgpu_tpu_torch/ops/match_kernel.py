"""Best-2 descriptor match reduction, ungated and H/F-gated: CUDA kernel +
plain version.

Replaces `siftgpu_tpu/ops/match_kernel.py::match_best2` (Pallas), with and
without its guided gates.  For uint8 descriptor sets d0 [P, N0, 128] and
d1 [P, N1, 128] (P pairs):

    sim[i, j] = (dot(d0[i], d1[j]) * rn1[j]) * rn0[i]    (-inf where masked)

and per row the best and second-best similarity and the argbest column, per
column the argbest row; ties go to the lowest index.  The integer dot is
exact (in the kernel on the int8 tensor cores, in the plain version by an
f32 matmul of values < 2^24), so with the same `rn0`/`rn1` the kernel
(`csrc/match_best2.cu`) and the plain version return identical selections
and bit-identical similarities.  `launch_plan` states the kernel's tiles,
column splits, grid, scratch and shared memory.

The gated variant (`match_best2_gated`, guided matching) also masks every
pair that fails the reprojection gate ("h") and/or the symmetric epipolar
gate ("f"), computed from rank-1 operands (`gate_matrix` states the
expressions and the operand layout).  The kernel forms the gate sums with
round-to-nearest intrinsics that are never contracted into FMAs, so it too
is bit-identical to its plain version.  It has its own launch counter
(`GATED`), on the same library as the ungated kernel.

`match_best2(...)` / `match_best2_gated(...)` take the plain version for CPU
tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..core.precision import full_f32

__all__ = [
    "match_best2", "match_best2_plain", "match_best2_gated",
    "match_best2_gated_plain", "best2_dense", "gate_matrix", "recip_norms",
    "launch_plan", "KERNEL", "GATED",
]

KERNEL = _build.Kernel(
    "match_best2", "match_best2.cu",
    {"match_best2_launch": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
     + [ctypes.c_void_p]},
)
GATED = _build.Kernel(
    "match_best2_gated", "match_best2.cu",
    {"match_best2_gated_launch": [ctypes.c_void_p] * 8 + [ctypes.c_float] * 2
     + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]},
)

_GATE_CODE = {"h": 1, "f": 2, "hf": 3}
_GATE_ROWS = {"h": 2, "f": 5, "hf": 7}
_GATE_COLS = {"h": 2, "f": 5, "hf": 5}

# csrc/match_best2.cu's constants: rows per block, columns per staged tile,
# shared row pitch in bytes, threads (8 warps: 2 row halves x 4 column
# quarters), ring stages, mask window bytes per stage; the grid aims at
# about 4 blocks per SM of the H100's 132
BM, BN, PITCH, THREADS, STAGES, MASK_W = 128, 64, 144, 256, 2, 80
TARGET_BLOCKS = 4 * 132
SMEM_LIMIT = 232_448            # 227 KB a block can hold


def launch_plan(P: int, N0: int, N1: int, gate=None) -> dict:
    """The match kernel's launch for P pairs of [N0, 128] x [N1, 128], as
    `csrc/match_best2.cu` runs it: a block owns a 128-row tile of one pair
    (staged once) and a column split of `tiles_per_split` 64-column tiles,
    streamed through a 2-stage cp.async ring; warps take 64 x 16 tiles of
    `mma.sync m16n8k32` u8 products.  Splits are as many as bring the grid
    to about TARGET_BLOCKS blocks (never more than the column tiles, none
    empty).  Each split writes its rows' (best, second, argbest) to the
    scratch [3, P, N0, splits], merged in split order by a second kernel;
    each column gets one 64-bit atomicMax per row tile."""
    if min(P, N0, N1) <= 0:
        raise ValueError(f"launch_plan: empty sets ({P}, {N0}, {N1})")
    rows, cols = (_GATE_ROWS[gate], _GATE_COLS[gate]) if gate else (0, 0)
    row_tiles, col_tiles = -(-N0 // BM), -(-N1 // BN)
    want = -(-TARGET_BLOCKS // (row_tiles * P))
    tps = -(-col_tiles // min(want, col_tiles))
    splits = -(-col_tiles // tps)
    smem = (BM * PITCH + STAGES * BN * PITCH + 2 * BN * 8 + STAGES * BN * 4 * (1 + cols)
            + rows * BM * 4 + STAGES * MASK_W)
    if smem > SMEM_LIMIT:
        raise ValueError(f"launch_plan: {smem} bytes of shared memory")
    return dict(tile=(BM, BN), threads=THREADS, warp_tile=(64, 16), mma="m16n8k32.u8.u8.s32",
                stages=STAGES, row_tiles=row_tiles, col_tiles=col_tiles,
                tiles_per_split=tps, splits=splits, grid=(row_tiles, splits, P),
                scratch=(3, P, N0, splits), smem_bytes=smem, atomics_per_column=row_tiles)


def recip_norms(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal L2 norm of each uint8 descriptor row, [..., 128] -> [...].

    Computed in float64 and rounded once to f32, so it is the correctly
    rounded value on every device (`torch.rsqrt` differs between the CPU and
    the card in the last ulp, and from the reference's `lax.rsqrt`)."""
    i = d.to(torch.int32)
    sq = (i * i).sum(dim=-1, dtype=torch.int32).to(torch.float64)
    return (1.0 / torch.sqrt(torch.clamp(sq, min=1e-24))).to(torch.float32)


def best2_dense(sim, m0, m1, keep=None):
    """The selection on a dense similarity sim [..., N0, N1]: pairs outside
    the masks m0 [..., N0], m1 [..., N1] (and, if given, outside `keep`
    [..., N0, N1]) are -inf; returns (bsim, ssim [..., N0] f32, bestj
    [..., N0] int32, col_best_i [..., N1] int32), ties to the lowest index."""
    valid = m0[..., :, None] & m1[..., None, :]
    if keep is not None:
        valid = valid & keep
    sim = torch.where(valid, sim, float("-inf"))
    best_j = torch.argmax(sim, dim=-1)
    bsim = torch.amax(sim, dim=-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    ssim = torch.where(cols == best_j[..., None], float("-inf"), sim).amax(dim=-1)
    col_best_i = torch.argmax(sim, dim=-2)
    return bsim, ssim, best_j.to(torch.int32), col_best_i.to(torch.int32)


def _u8_sim(d0, d1, rn0, rn1):
    with full_f32():
        dot = torch.matmul(d0.to(torch.float32), d1.to(torch.float32).transpose(-1, -2))
    return (dot * rn1[..., None, :]) * rn0[..., :, None]


def match_best2_plain(d0, d1, rn0, rn1, m0, m1):
    """Plain PyTorch version: the dense similarity matrix and its argmaxes."""
    return best2_dense(_u8_sim(d0, d1, rn0, rn1), m0, m1)


def gate_matrix(gate: str, rows, cols, h2: float, fthr: float) -> torch.Tensor:
    """Dense guided gate [P, N0, N1] bool from rank-1 operands.

    rows [P, R, N0] f32: "h" -> [px, py] (loc0 projected through H); "f" ->
    [la_x, la_y, la_z, x0x, x0y] (loc0's normalised epiline in image 1, then
    loc0); "hf" -> both, H first.  cols [P, C, N1] f32: [x1, y1], then for
    "f" [lb_x, lb_y, lb_z] (loc1's normalised epiline in image 0).

        h:  dx = px - x1; dy = py - y1;  dx*dx + dy*dy < h2
        f:  max(|la_x*x1 + la_y*y1 + la_z|, |x0x*lb_x + x0y*lb_y + lb_z|) < fthr

    h2 is the squared reprojection threshold rounded to f32 and fthr the
    epipolar threshold in f32 (`frontend/match.py::gate_thresholds`)."""
    x1, y1 = cols[:, 0, None, :], cols[:, 1, None, :]
    keep = None
    k = 0
    if "h" in gate:
        dx = rows[:, 0, :, None] - x1
        dy = rows[:, 1, :, None] - y1
        keep = dx * dx + dy * dy < h2
        k = 2
    if "f" in gate:
        la_x, la_y, la_z, x0x, x0y = (rows[:, k + i, :, None] for i in range(5))
        lb_x, lb_y, lb_z = (cols[:, 2 + i, None, :] for i in range(3))
        da = (la_x * x1 + la_y * y1 + la_z).abs()
        db = (x0x * lb_x + x0y * lb_y + lb_z).abs()
        f = torch.maximum(da, db) < fthr
        keep = f if keep is None else keep & f
    return keep


def match_best2_gated_plain(d0, d1, rn0, rn1, m0, m1, gate, rows, cols, h2, fthr):
    """Plain PyTorch version of the gated reduction."""
    return best2_dense(_u8_sim(d0, d1, rn0, rn1), m0, m1,
                       gate_matrix(gate, rows, cols, h2, fthr))


def _check_match_args(d0, d1, rn0, rn1, m0, m1):
    P, N0, D = d0.shape
    N1 = d1.shape[1]
    _build.check_tensor(d0, "d0", torch.uint8, 3)
    _build.check_tensor(d1, "d1", torch.uint8, 3)
    if D != 128 or d1.shape[0] != P or d1.shape[2] != 128:
        raise ValueError(f"descriptors must be [P, N, 128]: {tuple(d0.shape)}, {tuple(d1.shape)}")
    if N0 == 0 or N1 == 0 or d0.data_ptr() % 16 or d1.data_ptr() % 16:
        raise ValueError("descriptor sets must be non-empty and 16-byte aligned "
                         "(the kernel copies them in 16-byte chunks)")
    for name, t, dt, n in (("rn0", rn0, torch.float32, N0), ("rn1", rn1, torch.float32, N1),
                           ("m0", m0, torch.bool, N0), ("m1", m1, torch.bool, N1)):
        _build.check_tensor(t, name, dt, 2)
        if tuple(t.shape) != (P, n):
            raise ValueError(f"{name}: expected shape {(P, n)}, got {tuple(t.shape)}")
    return P, N0, N1


def _outputs(plan, P, N0, N1, dev):
    """(bsim, ssim, bestj, col_best_i) and the kernel's scratch: the zeroed
    column keys [P, N1] and the split partials [3, P, N0, splits]."""
    out = torch.empty((3, P, N0), dtype=torch.int32, device=dev)
    colb = torch.empty((P, N1), dtype=torch.int32, device=dev)
    colkey = torch.zeros((P, N1), dtype=torch.int64, device=dev)
    part = torch.empty(plan["scratch"], dtype=torch.int32, device=dev)
    return out, colb, colkey, part


def _results(out, colb):
    return out[0].view(torch.float32), out[1].view(torch.float32), out[2], colb


def _match_best2_cuda(d0, d1, rn0, rn1, m0, m1):
    P, N0, N1 = _check_match_args(d0, d1, rn0, rn1, m0, m1)
    plan = launch_plan(P, N0, N1)
    out, colb, colkey, part = _outputs(plan, P, N0, N1, d0.device)
    p = _build.ptr
    KERNEL.launch("match_best2_launch", d0.device,
                  p(d0), p(d1), p(rn0), p(rn1), p(m0), p(m1), p(out[0]), p(out[1]), p(out[2]),
                  p(colb), p(colkey), p(part[0]), p(part[1]), p(part[2]), P, N0, N1,
                  plan["tiles_per_split"], plan["splits"])
    return _results(out, colb)


def _match_best2_gated_cuda(d0, d1, rn0, rn1, m0, m1, gate, rows, cols, h2, fthr):
    P, N0, N1 = _check_match_args(d0, d1, rn0, rn1, m0, m1)
    if gate not in _GATE_CODE:
        raise ValueError(f"gate must be one of {sorted(_GATE_CODE)}, got {gate!r}")
    _build.check_tensor(rows, "rows", torch.float32, 3)
    _build.check_tensor(cols, "cols", torch.float32, 3)
    if tuple(rows.shape) != (P, _GATE_ROWS[gate], N0) or tuple(cols.shape) != (P, _GATE_COLS[gate], N1):
        raise ValueError(f"gate {gate!r}: rows {tuple(rows.shape)} / cols {tuple(cols.shape)} "
                         f"must be {(P, _GATE_ROWS[gate], N0)} / {(P, _GATE_COLS[gate], N1)}")
    plan = launch_plan(P, N0, N1, gate)
    out, colb, colkey, part = _outputs(plan, P, N0, N1, d0.device)
    p = _build.ptr
    GATED.launch("match_best2_gated_launch", d0.device,
                 p(d0), p(d1), p(rn0), p(rn1), p(m0), p(m1), p(rows), p(cols),
                 float(h2), float(fthr), p(out[0]), p(out[1]), p(out[2]), p(colb), p(colkey),
                 p(part[0]), p(part[1]), p(part[2]), P, N0, N1, plan["tiles_per_split"],
                 plan["splits"], _GATE_CODE[gate])
    return _results(out, colb)


def match_best2(d0, d1, rn0, rn1, m0, m1):
    """d0 [P, N0, 128], d1 [P, N1, 128] uint8; rn0 [P, N0], rn1 [P, N1] f32
    reciprocal norms; m0, m1 bool masks -> (bsim, ssim [P, N0] f32,
    bestj [P, N0] int32, col_best_i [P, N1] int32)."""
    if d0.device.type == "cpu":
        return match_best2_plain(d0, d1, rn0, rn1, m0, m1)
    return _match_best2_cuda(d0, d1, rn0, rn1, m0, m1)


def match_best2_gated(d0, d1, rn0, rn1, m0, m1, gate: str, rows, cols,
                      h2: float, fthr: float):
    """`match_best2` with every pair also gated: gate in {"h", "f", "hf"},
    rows [P, R, N0] and cols [P, C, N1] f32 operands and the f32 thresholds
    h2, fthr as `gate_matrix` states them."""
    if d0.device.type == "cpu":
        return match_best2_gated_plain(d0, d1, rn0, rn1, m0, m1, gate, rows, cols, h2, fthr)
    return _match_best2_gated_cuda(d0, d1, rn0, rn1, m0, m1, gate, rows, cols, h2, fthr)
