"""Keypoint detection: DoG extrema -> contrast/edge tests -> subpixel refine.

Port of `siftgpu_tpu/frontend/detect.py`:

  1. dense scores + Cramer subpixel records over each octave's DoG volume
     (`ops/detect_scores.py`: CUDA kernel on the card, plain PyTorch on CPU);
  2. per-octave EXACT top-k over the 2x2-pooled scores (a stable descending
     sort: ties go to the lowest flat index, as `lax.top_k`), the winner's
     corner recovered from the score's low mantissa bits;
  3. one gather of each winner's 4-field record across all octaves;
  4. offset/contrast/border validity tests on the gathered records.

The TPU's approximate top-k (`approx_max_k`) has no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import SiftConfig
from ..ops.detect_scores import detect_scores
from .pyramid import Octave

__all__ = [
    "OctaveKeypoints", "OctaveWinners", "detect_octave", "detect_pyramid",
    "record_indices", "refine_records",
]


class OctaveKeypoints(NamedTuple):
    y: torch.Tensor           # [B, K] refined row, octave-local float
    x: torch.Tensor           # [B, K] refined col
    level: torch.Tensor       # [B, K] refined DoG level (float)
    grad_level: torch.Tensor  # [B, K] int32 in [1, S]: Gaussian level for gradients
    sigma: torch.Tensor       # [B, K] octave-local scale
    response: torch.Tensor    # [B, K] |DoG| at the refined extremum
    mask: torch.Tensor        # [B, K] bool validity


class OctaveWinners(NamedTuple):
    """Integer winner pixels of the pooled top-k, pre-refinement."""
    py: torch.Tensor    # [B, cap] int32 winner row
    px: torch.Tensor    # [B, cap] int32 winner col
    l: torch.Tensor     # [B, cap] int32 DoG slice in [1, S]
    cand: torch.Tensor  # [B, cap] bool (top-k slot holds a real candidate)


N_REC = 4


def _octave_scores(dog: torch.Tensor, cfg: SiftConfig, owned_rows=None):
    """Dense scores + lane-pair pooling; `owned_rows=(lo, hi)` keeps
    candidates to a spatial slab's rows [lo, hi).  Returns (bscore
    [B, 2*nb1], records, (Hs, Ws), (nb1, Hs2))."""
    B, L, H, W = dog.shape
    S = L - 2
    s_max, s_min, r_val, r_ol, r_oy, r_ox = detect_scores(dog, cfg, owned_rows)
    Hs2, Ws = s_max.shape[-2:]
    Hs = r_val.shape[-2]
    nb1 = S * Hs2 * (Ws // 2)

    def pooled(score):  # max over lane pairs
        return score.view(B, S, Hs2, Ws // 2, 2).amax(dim=4).reshape(B, nb1)

    bscore = torch.cat([pooled(s_max), pooled(s_min)], dim=1)
    return bscore, (r_val, r_ol, r_oy, r_ox), (Hs, Ws), (nb1, Hs2)


def _run_topk(bscore: torch.Tensor, cap: int):
    """Exact top-k of each row, ties to the lowest index; padded to `cap`."""
    rows, n = bscore.shape
    k = min(cap, n)
    top, bidx = torch.sort(bscore, dim=1, descending=True, stable=True)
    top, bidx = top[:, :k], bidx[:, :k].to(torch.int32)
    if k < cap:  # zero scores are masked by `cand`
        top = torch.nn.functional.pad(top, (0, cap - k))
        bidx = torch.nn.functional.pad(bidx, (0, cap - k))
    return top, bidx


def _decode_topk(top, bidx, nb1, Hs2, Ws) -> OctaveWinners:
    cand = top > 0.0
    bidx1 = bidx % nb1                                # drop the type axis
    l = bidx1 // (Hs2 * (Ws // 2)) + 1                # DoG slice in [1, S]
    rem = bidx1 % (Hs2 * (Ws // 2))
    corner = top.view(torch.int32) & 3                # packed 2x2 corner
    py = (rem // (Ws // 2)) * 2 + (corner >> 1)
    px = (rem % (Ws // 2)) * 2 + (corner & 1)
    return OctaveWinners(py=py, px=px, l=l, cand=cand)


def record_indices(win: OctaveWinners, S: int, Hs: int, Ws: int) -> torch.Tensor:
    """[B, 4*cap] flat indices of the winner's record cells in the
    field-stacked record planes reshaped to [B, 4 * S*Hs*Ws]."""
    vol = S * Hs * Ws
    cell = (win.l - 1).clamp(0, S - 1) * (Hs * Ws) + win.py * Ws + win.px
    return torch.cat([cell + f * vol for f in range(N_REC)], dim=1)


def refine_records(rec: torch.Tensor, win: OctaveWinners, cfg: SiftConfig,
                   H: int, W: int) -> OctaveKeypoints:
    """rec: [B, 4, cap] gathered (val, off_l, off_y, off_x) -> validity tests
    + derived scale.  H, W are the true octave dims."""
    S = cfg.dog_levels
    py, px, l, cand = win.py, win.px, win.l, win.cand
    val, off_l, off_y, off_x = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
    if cfg.subpixel:
        off_ok = (off_l.abs() <= 1.5) & (off_y.abs() <= 1.5) & (off_x.abs() <= 1.5)
        off_l = off_l.clamp(-0.5, 0.5)
    else:
        off_ok = torch.ones_like(val, dtype=torch.bool)
    fy = py.to(torch.float32) + off_y
    fx = px.to(torch.float32) + off_x
    fl = l.to(torch.float32) + off_l
    bd = float(cfg.border)
    border_ok = (fy >= bd) & (fy < H - bd) & (fx >= bd) & (fx < W - bd)
    contrast_ok = val.abs() >= cfg.dog_threshold   # compared in f32, as the reference
    mask = cand & off_ok & border_ok & contrast_ok
    sigma = cfg.sigma0 * torch.exp2(fl / S)
    grad_level = torch.round(fl).to(torch.int32).clamp(1, S)
    resp = val if cfg.keep_sign else val.abs()
    return OctaveKeypoints(y=fy, x=fx, level=fl, grad_level=grad_level,
                           sigma=sigma, response=resp, mask=mask)


def detect_octave(oc: Octave, cfg: SiftConfig, cap: int, owned_rows=None) -> OctaveKeypoints:
    """Single-octave detection (see `detect_pyramid`); `owned_rows=(lo,
    hi)` keeps candidates to a spatial slab's rows [lo, hi), so that halo
    extrema neither take top-k capacity nor count twice across slabs."""
    return detect_pyramid((oc,), cfg, caps=[cap], owned_rows=[owned_rows])[0]


def detect_pyramid(pyr, cfg: SiftConfig, caps=None, owned_rows=None):
    """Detection over all octaves with one record gather across octaves;
    `owned_rows`: each octave's (lo, hi) or None (default: None for all).
    Returns a list of per-octave `OctaveKeypoints`.

    An octave's dense records are dropped as soon as they are flattened,
    and one octave's flat records (-obo's octave programs) are gathered
    from without another copy: at octave 0 each copy is about a third of
    the working set."""
    caps = caps or [cfg.octave_cap(o) for o in range(len(pyr))]
    owned_rows = owned_rows or [None] * len(pyr)
    B = pyr[0].dog.shape[0]
    wins, ridxs, flats, dims = [], [], [], []
    off = 0
    for oc, cap, owned in zip(pyr, caps, owned_rows):
        _, L, H, W = oc.dog.shape
        S = L - 2
        bscore, recs, (Hs, Ws), (nb1, Hs2) = _octave_scores(oc.dog, cfg, owned)
        top, bidx = _run_topk(bscore, cap)
        win = _decode_topk(top, bidx, nb1, Hs2, Ws)
        del bscore, top, bidx   # `top` is a view of the whole sorted row
        wins.append(win)
        ridxs.append(record_indices(win, S, Hs, Ws).to(torch.int64) + off)
        flats.append(torch.cat([r.reshape(B, -1) for r in recs], dim=1))
        del recs
        off += N_REC * S * Hs * Ws
        dims.append((H, W))
    flat = flats[0] if len(flats) == 1 else torch.cat(flats, dim=1)
    del flats
    rall = torch.gather(flat, 1, torch.cat(ridxs, dim=1))
    del flat
    outs, col = [], 0
    for (H, W), cap, win in zip(dims, caps, wins):
        rec = rall[:, col : col + N_REC * cap].reshape(B, N_REC, cap)
        col += N_REC * cap
        outs.append(refine_records(rec, win, cfg, H, W))
    return outs
