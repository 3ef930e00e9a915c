"""Plain best-2 matching of uint8 descriptor sets: the benchmark's reference
for every cell that matches.

A frozen copy of the port's plain route at commit
72032356832fccc0fed74691f2666c2a15816fcf (`ops/match_kernel.py::recip_norms`,
`_u8_sim`, `best2_dense` and `frontend/match.py::_finalize`), with every
import of the port removed.  The similarity is the exact integer dot
product (an f32 matmul of values below 2^24, TF32 off) scaled by reciprocal
norms that are correctly rounded; the best and second best per row, the
argbest column and each column's argbest row (ties to the lowest index);
then SiftMatchGPU's angular distmax, ratio and mutual-best tests and the
fixed-capacity compaction in row order.

`precision`: "int8" matches the descriptors as they are (the
configuration's precision); "int4" keeps the 4 high bits of each byte
first: the control that a comparison has to fail.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Matches", "match_pair", "match_batch", "quantise"]


class Matches(NamedTuple):
    pairs: torch.Tensor  # [max_match, 2] int32, -1-padded
    count: torch.Tensor  # [] int32
    dist: torch.Tensor   # [max_match] f32, 0-padded


def quantise(d: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "int8":
        return d
    if precision == "int4":
        return d >> 4
    raise ValueError(f"precision: 'int8' or 'int4', got {precision!r}")


def _recip_norms(d):
    i = d.to(torch.int32)
    sq = (i * i).sum(dim=-1, dtype=torch.int32).to(torch.float64)
    return (1.0 / torch.sqrt(torch.clamp(sq, min=1e-24))).to(torch.float32)


def _best2(d0, d1, m0, m1):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dot = torch.matmul(d0.to(torch.float32), d1.to(torch.float32).T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    sim = (dot * _recip_norms(d1)[None, :]) * _recip_norms(d0)[:, None]
    sim = torch.where(m0[:, None] & m1[None, :], sim, float("-inf"))
    best_j = torch.argmax(sim, dim=-1)
    bsim = torch.amax(sim, dim=-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    ssim = torch.where(cols == best_j[:, None], float("-inf"), sim).amax(dim=-1)
    return bsim, ssim, best_j, torch.argmax(sim, dim=-2)


@torch.no_grad()
def match_pair(d0, d1, m0, m1, cfg: dict, precision: str = "int8") -> Matches:
    """d0 [N0, 128], d1 [N1, 128] uint8, masks [N0] / [N1] bool; `cfg` the
    configuration's matcher settings (max_match, dist_max, ratio_max,
    mutual_best)."""
    bsim, ssim, bj, col_best_i = _best2(quantise(d0, precision), quantise(d1, precision), m0, m1)
    n0, dev = bsim.shape[0], bsim.device
    best = torch.acos(bsim.clamp(-1.0, 1.0))
    second = torch.acos(ssim.clamp(-1.0, 1.0))
    second = torch.where(torch.isfinite(ssim), second, float("inf"))
    ok = (best < cfg["dist_max"]) & (best < cfg["ratio_max"] * second)
    rows = torch.arange(n0, dtype=torch.int64, device=dev)
    if cfg["mutual_best"]:
        ok &= col_best_i[bj] == rows
    ok &= torch.isfinite(bsim)
    key = torch.where(ok, rows, n0 + rows)
    m = cfg["max_match"]
    perm = torch.sort(key).values
    perm = torch.where(perm < n0, perm, perm - n0)
    perm_m = perm[:m] if n0 >= m else torch.nn.functional.pad(perm, (0, m - n0))
    count = torch.clamp(ok.sum(), max=m).to(torch.int32)
    valid = torch.arange(m, device=dev) < count
    pr = torch.stack([perm_m, bj[perm_m]], dim=1).to(torch.int32)
    return Matches(pairs=torch.where(valid[:, None], pr, -1), count=count,
                   dist=torch.where(valid, best[perm_m], 0.0))


def match_batch(d0, d1, m0, m1, cfg: dict, precision: str = "int8") -> Matches:
    """`match_pair` over a leading pair axis: d0 [P, N0, 128], d1 [P, N1, 128]."""
    res = [match_pair(d0[q], d1[q], m0[q], m1[q], cfg, precision) for q in range(d0.shape[0])]
    return Matches(*(torch.stack(f) for f in zip(*res)))
