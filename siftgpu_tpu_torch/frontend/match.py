"""Descriptor matching: brute-force best-2 + ratio test + mutual best.

Port of the uint8 path of `siftgpu_tpu/frontend/match.py`.  Similarities
come from the best-2 reduction of `ops/match_kernel.py` (the CUDA kernel on
the card — the [N0, N1] similarity never reaches device memory — and the
dense plain version on CPU); `_finalize` applies the reference's angular
distmax / ratiomax thresholds and the mutual-best check and compacts the
surviving rows, in row order, into a fixed `[max_match, 2]` buffer padded
with -1.

Float descriptors (the reference's f32 / streaming paths) are not ported:
the port raises on non-uint8 input.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import MatchConfig
from ..ops.match_kernel import match_best2, recip_norms

__all__ = ["MatchResult", "match_descriptors", "match_descriptors_batch"]


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


def _check_u8(*ds):
    for d in ds:
        if d.dtype != torch.uint8:
            raise NotImplementedError(
                f"only uint8 descriptors are ported (got {d.dtype})")


def match_descriptors_batch(
    d0: torch.Tensor, d1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None, mask1: Optional[torch.Tensor] = None,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """Pairwise matching of P pairs: d0 [P, N0, 128], d1 [P, N1, 128] uint8
    -> MatchResult with a leading pair axis.  One reduction launch for all P
    pairs."""
    _check_u8(d0, d1)
    P, N0, _ = d0.shape
    N1 = d1.shape[1]
    dev = d0.device
    if mask0 is None:
        mask0 = torch.ones((P, N0), dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones((P, N1), dtype=torch.bool, device=dev)
    d0, d1 = d0.contiguous(), d1.contiguous()
    # `recip_norms` is the counterpart of the reference's `_u8_parts`: computed
    # once here, so the kernel and the plain version share the same norms
    bs, ss, bj, ci = match_best2(d0, d1, recip_norms(d0), recip_norms(d1),
                                 mask0.contiguous(), mask1.contiguous())
    res = [_finalize(bs[p], ss[p], bj[p], ci[p], cfg) for p in range(P)]
    return MatchResult(*(torch.stack(f) for f in zip(*res)))


def match_descriptors(
    d0: torch.Tensor, d1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None, mask1: Optional[torch.Tensor] = None,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """d0: [N0, 128], d1: [N1, 128] uint8. GetSiftMatch analog."""
    res = match_descriptors_batch(
        d0[None], d1[None],
        None if mask0 is None else mask0[None],
        None if mask1 is None else mask1[None], cfg,
    )
    return MatchResult(*(f[0] for f in res))
