"""Descriptor matching: brute-force best-2 + ratio test + mutual best, plain
and guided.

Port of `siftgpu_tpu/frontend/match.py`, with two routes, chosen by the
descriptors' dtype and device only:

  - uint8 sets on the card take the best-2 reduction of
    `ops/match_kernel.py` at every size (the CUDA kernel: the [N0, N1]
    similarity never reaches device memory), guided matching its H/F-gated
    variant, whose rank-1 gate operands `gate_operands` forms (the
    reference's `_fused_select` / `_fused_guided`);
  - every other set (float descriptors on both devices, uint8 on the CPU)
    takes `_match_streaming`, in blocks of the width `_effective_block`
    gives (above `stream_threshold` columns, or above an explicit
    `block_size`), else in one block of all N1 columns, the dense
    selection.  It takes d1 in column blocks, forms each block's
    similarity (uint8: exact dots with reciprocal norms computed once;
    float: L2-normalised rows, one full-f32 matmul), applies the masks and
    the block's gates, and merges the block's best-2 into running (best,
    second, argbest) rows, ties to the earlier column.  Each column's
    argbest row completes within its block, which holds every row.  It
    holds O(N0 x block) memory, not O(N0 x N1), and its loop is a static
    Python loop with no host read, so the captured entry points (`*_jit`)
    capture it at every block width.

`_finalize` applies the angular distmax / ratiomax thresholds and the
mutual-best check and compacts the surviving rows, in row order, into a
fixed `[max_match, 2]` buffer padded with -1.

Gate operands are formed elementwise in f32 in a fixed order, never with a
small matmul: a [N, 3] x [3, 3] product on the card would run in TF32
unless disabled, and its ~1e-3 relative error moves a 3 px gate.  The same
code serves the kernel, the plain version and every block of the stream,
so the CPU and the card get the same operands.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.config import MatchConfig
from ..core.graphs import graphed
from ..ops.match_kernel import (_u8_sim, best2_dense, gate_matrix, match_best2,
                                match_best2_gated, recip_norms)
from ..core.precision import full_f32

__all__ = [
    "MatchResult", "match_descriptors", "match_descriptors_batch",
    "match_descriptors_jit", "match_descriptors_batch_jit",
    "guided_match_descriptors", "guided_match_descriptors_jit", "gate_operands",
    "gate_thresholds",
]


class MatchResult(NamedTuple):
    pairs: torch.Tensor  # [max_match, 2] int32, -1-padded (leading pair axis in batch)
    count: torch.Tensor  # [] int32
    dist: torch.Tensor   # [max_match] angular distance of each pair (padded 0)


def _finalize(bsim, ssim, best_j, col_best_i, cfg: MatchConfig) -> MatchResult:
    """Thresholds + mutual best + fixed-capacity compaction for one pair."""
    n0 = bsim.shape[0]
    dev = bsim.device
    best = torch.acos(bsim.clamp(-1.0, 1.0))
    second = torch.acos(ssim.clamp(-1.0, 1.0))
    second = torch.where(torch.isfinite(ssim), second, float("inf"))
    ok = (best < cfg.dist_max) & (best < cfg.ratio_max * second)
    rows = torch.arange(n0, dtype=torch.int64, device=dev)
    bj = best_j.to(torch.int64)
    if cfg.mutual_best:
        ok &= col_best_i.to(torch.int64)[bj] == rows
    ok &= torch.isfinite(bsim)

    key = torch.where(ok, rows, n0 + rows)          # valid first, row order
    m = cfg.max_match
    perm = torch.sort(key).values
    perm = torch.where(perm < n0, perm, perm - n0)
    perm_m = perm[:m] if n0 >= m else torch.nn.functional.pad(perm, (0, m - n0))
    count = torch.clamp(ok.sum(), max=m).to(torch.int32)
    valid_slot = torch.arange(m, device=dev) < count
    pr = torch.stack([perm_m, bj[perm_m]], dim=1).to(torch.int32)
    return MatchResult(
        pairs=torch.where(valid_slot[:, None], pr, -1),
        count=count,
        dist=torch.where(valid_slot, best[perm_m], 0.0),
    )


def _is_u8(*ds) -> bool:
    return all(d.dtype == torch.uint8 for d in ds)


def _normalize(d: torch.Tensor) -> torch.Tensor:
    f = d.to(torch.float32)
    n = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    return f / torch.clamp(n, min=1e-12)


def _masks(d0, d1, mask0, mask1):
    lead0, lead1 = d0.shape[:-1], d1.shape[:-1]
    if mask0 is None:
        mask0 = torch.ones(lead0, dtype=torch.bool, device=d0.device)
    if mask1 is None:
        mask1 = torch.ones(lead1, dtype=torch.bool, device=d1.device)
    return mask0.contiguous(), mask1.contiguous()


def _effective_block(cfg: MatchConfig, n1: int) -> int:
    """The reference's streaming policy, from N1 and the config alone.

    block_size > 0: stream with that block when N1 exceeds it;
    block_size == 0: stream `stream_block` columns when N1 > `stream_threshold`;
    block_size < 0: always dense.
    Returns the block, or 0 for the dense route."""
    if cfg.block_size > 0:
        return cfg.block_size if n1 > cfg.block_size else 0
    if cfg.block_size == 0 and n1 > cfg.stream_threshold:
        return min(cfg.stream_block, n1)
    return 0


def _match_streaming(d0, d1, mask0, mask1, block: int, gate=None):
    """Blockwise streaming best-2 (the reference's `_match_streaming`) of P
    pairs: d0 [P, N0, 128], d1 [P, N1, 128] (uint8 or float), masks
    [P, N0] / [P, N1], d1 taken `block` columns at a time, N1 padded to a
    multiple of the block with mask1 false.  `gate`, if given, is
    (gate, rows [P, R, N0], cols [P, C, N1], h2, fthr) as `gate_matrix`
    takes them; each block's gate is formed from its slice of `cols`.
    Returns what `best2_dense` returns on the whole [N0, N1]."""
    P, n0, n1 = d0.shape[0], d0.shape[1], d1.shape[1]
    pad = (-n1) % block
    pad_cols = lambda x: torch.nn.functional.pad(x, (0, pad)) if pad else x
    pad_rows = lambda x: torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
    if _is_u8(d0, d1):
        rn0, rn1, d1 = recip_norms(d0), pad_cols(recip_norms(d1)), pad_rows(d1)

        def sim(lo):
            return _u8_sim(d0, d1[:, lo:lo + block], rn0, rn1[:, lo:lo + block])
    else:
        f0, f1 = _normalize(d0), pad_rows(_normalize(d1))

        def sim(lo):
            with full_f32():
                return torch.matmul(f0, f1[:, lo:lo + block].transpose(-1, -2))
    mask1 = pad_cols(mask1)
    if gate is not None:
        g, rows, cols, h2, fthr = gate
        cols = pad_cols(cols)
    dev = d0.device
    best = torch.full((P, n0), float("-inf"), dtype=torch.float32, device=dev)
    second = torch.full((P, n0), float("-inf"), dtype=torch.float32, device=dev)
    best_j = torch.zeros((P, n0), dtype=torch.int32, device=dev)
    col_best_i = []
    for lo in range(0, n1 + pad, block):
        keep = None if gate is None else gate_matrix(g, rows, cols[..., lo:lo + block], h2, fthr)
        b, s, j, ci = best2_dense(sim(lo), mask0, mask1[:, lo:lo + block], keep)
        # disjoint candidates: the strict > keeps the earlier column on ties
        second = torch.maximum(torch.maximum(second, s), torch.minimum(best, b))
        best_j = torch.where(b > best, j + lo, best_j)
        best = torch.maximum(best, b)
        col_best_i.append(ci)
    return best, second, best_j, torch.cat(col_best_i, dim=-1)[:, :n1]


def _selection(d0, d1, mask0, mask1, cfg: MatchConfig, gate=None):
    """The best-2 selection of P pairs (d0 [P, N0, 128], d1 [P, N1, 128],
    masks [P, N0] / [P, N1], `gate` as `_match_streaming` takes it) by the
    route the dtype and the device choose (the module's docstring)."""
    if not (_is_u8(d0, d1) and d0.device.type == "cuda"):
        n1 = d1.shape[1]
        return _match_streaming(d0, d1, mask0, mask1, _effective_block(cfg, n1) or n1, gate)
    d0, d1 = d0.contiguous(), d1.contiguous()
    # `recip_norms` is the counterpart of the reference's `_u8_parts`:
    # computed once here, so the kernel and the plain version share them
    args = (d0, d1, recip_norms(d0), recip_norms(d1), mask0, mask1)
    if gate is None:
        return match_best2(*args)
    g, rows, cols, h2, fthr = gate
    return match_best2_gated(*args, g, rows.contiguous(), cols.contiguous(), h2, fthr)


def match_descriptors_batch(
    d0: torch.Tensor, d1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None, mask1: Optional[torch.Tensor] = None,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """Pairwise matching of P pairs: d0 [P, N0, 128], d1 [P, N1, 128] (uint8
    or float) -> MatchResult with a leading pair axis.  One reduction launch
    for all P pairs on the kernel's route."""
    mask0, mask1 = _masks(d0, d1, mask0, mask1)
    sel = _selection(d0, d1, mask0, mask1, cfg)
    res = [_finalize(*(s[p] for s in sel), cfg) for p in range(d0.shape[0])]
    return MatchResult(*(torch.stack(f) for f in zip(*res)))


def match_descriptors(
    d0: torch.Tensor, d1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None, mask1: Optional[torch.Tensor] = None,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """d0: [N0, 128], d1: [N1, 128] (uint8 or float). GetSiftMatch analog."""
    res = match_descriptors_batch(
        d0[None], d1[None],
        None if mask0 is None else mask0[None],
        None if mask1 is None else mask1[None], cfg,
    )
    return MatchResult(*(f[0] for f in res))


# the reference's jitted `match_descriptors_batch` and `match_descriptors`:
# captured once per signature on CUDA inputs (`core/graphs.py`)
match_descriptors_batch_jit = graphed(match_descriptors_batch, "match_descriptors_batch_jit")
match_descriptors_jit = graphed(match_descriptors, "match_descriptors_jit")


# ---------------- guided matching (GetGuidedSiftMatch) ----------------

def _row3(loc, M, k, transpose=False):
    """(x, y, 1) · row k of M (column k if `transpose`), elementwise f32:
    (x·m0 + y·m1) + m2."""
    m = M[:, k] if transpose else M[k]
    return (loc[:, 0] * m[0] + loc[:, 1] * m[1]) + m[2]


def _h_parts(loc0, H):
    """Per-row homography operands: loc0 [N0, 2] projected through H -> (px, py)."""
    z = _row3(loc0, H, 2)
    den = torch.clamp(z.abs(), min=1e-12)
    sgn = torch.sign(z)
    return _row3(loc0, H, 0) / den * sgn, _row3(loc0, H, 1) / den * sgn


def _normalized_line(a, b, c):
    den = torch.clamp(torch.sqrt(a * a + b * b), min=1e-12)
    return a / den, b / den, c / den


def _f_parts_rows(loc0, F):
    """Per-row epipolar operands: loc0's normalised epiline in image 1
    (la = F x0 / |la_xy|) plus loc0 itself."""
    la = _normalized_line(*(_row3(loc0, F, k) for k in range(3)))
    return (*la, loc0[:, 0], loc0[:, 1])


def _f_parts_cols(loc1, F):
    """Per-column epipolar operands: loc1's normalised epiline in image 0
    (lb = F^T x1 / |lb_xy|)."""
    return _normalized_line(*(_row3(loc1, F, k, transpose=True) for k in range(3)))


def gate_operands(loc0, loc1, H=None, F=None):
    """The gated selection's operands (the reference's `_fused_guided`
    layout): gate in
    {"h", "f", "hf"}, rows [R, N0] and cols [C, N1] f32 (see
    `ops.match_kernel.gate_matrix`).  loc0 [N0, 2], loc1 [N1, 2], H, F
    [3, 3] f32 on one device."""
    loc0, loc1 = loc0.to(torch.float32), loc1.to(torch.float32)
    gate, rows = "", []
    if H is not None:
        gate += "h"
        rows += list(_h_parts(loc0, H.to(torch.float32)))
    if F is not None:
        gate += "f"
        rows += list(_f_parts_rows(loc0, F.to(torch.float32)))
    cols = [loc1[:, 0], loc1[:, 1]]
    if F is not None:
        cols += list(_f_parts_cols(loc1, F.to(torch.float32)))
    return gate, torch.stack(rows), torch.stack(cols)


def gate_thresholds(hdist_max: float, fdist_max: float):
    """(h2, fthr): the squared reprojection threshold, squared in double and
    rounded once to f32, and the epipolar threshold in f32 — the values the
    reference compares against."""
    return (float(np.float32(float(hdist_max) * float(hdist_max))),
            float(np.float32(fdist_max)))


def _homography_gate(loc0, loc1, H, hdist_max):
    """Squared reprojection gate |H x0 - x1|^2 < hdist_max^2 -> [N0, N1] bool."""
    gate, rows, cols = gate_operands(loc0, loc1, H=H)
    return gate_matrix(gate, rows[None], cols[None], *gate_thresholds(hdist_max, 0.0))[0]


def _epipolar_gate(loc0, loc1, F, fdist_max):
    """Symmetric epipolar-distance gate via F -> [N0, N1] bool."""
    gate, rows, cols = gate_operands(loc0, loc1, F=F)
    return gate_matrix(gate, rows[None], cols[None], *gate_thresholds(0.0, fdist_max))[0]


def guided_match_descriptors(
    d0, d1, loc0, loc1, H=None, F=None,
    mask0: Optional[torch.Tensor] = None, mask1: Optional[torch.Tensor] = None,
    hdist_max: float = 32.0, fdist_max: float = 16.0,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """GetGuidedSiftMatch analog: pairs gated by the reprojection distance
    through H (< hdist_max px) and/or the symmetric epipolar distance
    through F (< fdist_max px) before the best-2 selection.  d0 [N0, 128],
    d1 [N1, 128]; loc0 [N0, 2], loc1 [N1, 2] (x, y); H, F [3, 3] f32
    tensors on the descriptors' device.  Without H and F it is
    `match_descriptors`."""
    if H is None and F is None:
        return match_descriptors(d0, d1, mask0, mask1, cfg)
    mask0, mask1 = _masks(d0, d1, mask0, mask1)
    gate, rows, cols = gate_operands(loc0, loc1, H, F)
    sel = _selection(d0[None], d1[None], mask0[None], mask1[None], cfg,
                     (gate, rows[None], cols[None], *gate_thresholds(hdist_max, fdist_max)))
    return _finalize(*(x[0] for x in sel), cfg)


# the reference's jitted `guided_match_descriptors` (hdist_max, fdist_max and
# cfg static; H and F in the signature by None-ness)
guided_match_descriptors_jit = graphed(guided_match_descriptors, "guided_match_descriptors_jit")
