"""The comparison that decides `correct`: the program's outputs against the
reference's, number by number, each number against its limit.

Keypoints of one frame are paired mutually nearest by the Chebyshev
distance of their positions plus the wrapped difference of their
orientations, and a pair counts only within `PAIR_PX` and `PAIR_RAD`.
Numbers (each a maximum or a share over the calls checked):

  kp_unpaired_pct    keypoints of either side left unpaired, % of both sides'
  kp_pos_err_px      the widest position gap of a pair (x or y, pixels)
  kp_theta_err_rad   the widest orientation gap of a pair (radians)
  desc_step_max      the widest descriptor byte gap of a pair (uint8 steps)
  match_unshared_pct matches that only one side makes, % of the union; the
                     program's keypoint indices mapped through the pairing
  match_entries_differing  (descriptor sets) pair slots, counts or
                     distances that differ from the reference's: exact
"""

from __future__ import annotations

import torch

__all__ = ["PAIR_PX", "PAIR_RAD", "pair_keypoints", "FrameTally", "match_sets_differing",
           "judge"]

PAIR_PX = 0.5
PAIR_RAD = 0.1
TWO_PI = 6.283185307179586


def _frame(feats, b: int) -> dict:
    m = feats.mask[b]
    idx = torch.nonzero(m).flatten()
    return dict(idx=idx, x=feats.x[b][idx].float(), y=feats.y[b][idx].float(),
                theta=feats.theta[b][idx].float(), desc=feats.desc[b][idx], K=m.shape[0])


def pair_keypoints(p: dict, r: dict):
    """Mutually nearest pairs of program keypoints p and reference keypoints
    r (as `_frame` gives them) -> (pi, ri) index tensors into p and r, and
    the pairs' position and orientation gaps."""
    dev = p["x"].device
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if p["x"].numel() == 0 or r["x"].numel() == 0:
        z = torch.zeros(0, device=dev)
        return empty, empty, z, z
    dpos = torch.maximum((p["x"][:, None] - r["x"][None, :]).abs(),
                         (p["y"][:, None] - r["y"][None, :]).abs())
    dth = (p["theta"][:, None] - r["theta"][None, :]).abs() % TWO_PI
    dth = torch.minimum(dth, TWO_PI - dth)
    cost = dpos + dth
    near_r = cost.argmin(dim=1)
    near_p = cost.argmin(dim=0)
    pi = torch.arange(cost.shape[0], device=dev)
    ok = near_p[near_r] == pi
    pi, ri = pi[ok], near_r[ok]
    gp, gt = dpos[pi, ri], dth[pi, ri]
    keep = (gp <= PAIR_PX) & (gt <= PAIR_RAD)
    return pi[keep], ri[keep], gp[keep], gt[keep]


class FrameTally:
    """The numbers of the frame cells, summed over the frames and pairs
    checked."""

    def __init__(self):
        self.kp_total = 0
        self.kp_unpaired = 0
        self.pos = 0.0
        self.theta = 0.0
        self.desc = 0
        self.match_union = 0
        self.match_unshared = 0
        self.maps = {}

    def frame(self, key, prog, b: int, ref, rb: int) -> None:
        """Compare frame b of the program's Features with frame rb of the
        reference's; `key` names the frame for the matches compared later."""
        p, r = _frame(prog, b), _frame(ref, rb)
        pi, ri, gp, gt = pair_keypoints(p, r)
        n, m = p["x"].numel(), r["x"].numel()
        self.kp_total += n + m
        self.kp_unpaired += n + m - 2 * pi.numel()
        if pi.numel():
            self.pos = max(self.pos, float(gp.max()))
            self.theta = max(self.theta, float(gt.max()))
            gap = (p["desc"][pi].to(torch.int32) - r["desc"][ri].to(torch.int32)).abs()
            self.desc = max(self.desc, int(gap.max()))
        # program slot -> reference slot (-1: unpaired)
        to_ref = torch.full((p["K"],), -1, dtype=torch.int64, device=p["x"].device)
        to_ref[p["idx"][pi]] = r["idx"][ri]
        self.maps[key] = to_ref

    def matches(self, key0, key1, prog_pairs, prog_count, ref_pairs, ref_count) -> None:
        """Compare one pair of frames' matches: the program's slots mapped
        to the reference's through the frames' pairings."""
        pp = prog_pairs[: int(prog_count)].to(torch.int64)
        rp = ref_pairs[: int(ref_count)].to(torch.int64)
        a = self.maps[key0][pp[:, 0]]
        b = self.maps[key1][pp[:, 1]]
        ok = (a >= 0) & (b >= 0)
        big = max(self.maps[key0].numel(), self.maps[key1].numel()) + 1
        pk = set((a[ok] * big + b[ok]).tolist())
        rk = set((rp[:, 0] * big + rp[:, 1]).tolist())
        unmapped = int((~ok).sum())
        union = len(pk | rk) + unmapped
        self.match_union += union
        self.match_unshared += len(pk ^ rk) + unmapped

    def numbers(self, with_matches: bool) -> dict:
        out = dict(
            kp_unpaired_pct=100.0 * self.kp_unpaired / max(self.kp_total, 1),
            kp_pos_err_px=self.pos, kp_theta_err_rad=self.theta, desc_step_max=float(self.desc),
        )
        if with_matches:
            out["match_unshared_pct"] = 100.0 * self.match_unshared / max(self.match_union, 1)
        return out


def match_sets_differing(prog, ref_list) -> int:
    """Entries of the program's batched MatchResult (pairs [P, M, 2], count
    [P], dist [P, M]) that differ from the reference's list of P results."""
    n = 0
    for q, r in enumerate(ref_list):
        n += int(int(prog.count[q]) != int(r.count))
        n += int((prog.pairs[q].to(torch.int32) != r.pairs.to(torch.int32)).any(dim=1).sum())
        n += int((prog.dist[q] != r.dist).sum())
    return n


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each at or below it; a limit without a number fails."""
    out, ok = {}, True
    for name in sorted(limits):
        v, lim = numbers.get(name), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not (v <= lim):
            ok = False
    return ok, out
