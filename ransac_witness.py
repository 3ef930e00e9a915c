#!/usr/bin/env python3
"""The SLAM bootstrap's RANSAC on the card against float64: why phase 4d's
online-correction step (`chip_smoke.online_phase`) turns on rounding.

    python3 ransac_witness.py record [DIR]      # on a card
    python3 ransac_witness.py witness [DIR]     # on any host
    python3 ransac_witness.py variants NAME...  # on a card

record: for each noise seed of `chip_smoke.ONLINE_SEEDS`, one `run_slam` on
the online step's 144x192 loop scene (`weak_slam_config`), its bootstrap's
`ransac_from_samples` inputs recorded; then the 256 minimal sets' 9 x 9
normal matrices as `eight_point` forms them, their smallest eigenvectors
from the `small_eig` kernel and from `torch.linalg.eigh` (cuSOLVER), and
each set's inlier score with either solver.  Saved to DIR/boot_<seed>.pt
(DIR: chiprun_out).

witness: per recorded seed, the matches, the sets that repeat a
correspondence, the median sine of the angle between each solver's vector
and float64's (`torch.linalg.eigh` in float64 of the same f32 matrices), the
median eigen gap (second smallest less smallest eigenvalue, over the
largest) of repeating and of distinct sets, and, for each solver's
top-scoring set (the reference's rule, the first of equal scores), whether
it repeats a correspondence, its score with the kernel, cuSOLVER and an
all-float64 eight-point, and the inliers after each of the reference's two
refits from it with the kernel's arithmetic (its plain version, on this
host's f32 products).  One JSON line.

variants: phase 4d's online step (`chip_smoke.online_phase`, its gate
unchanged) with the bootstrap's RANSAC replaced: "reference" ranks every
set by score and takes every refit (the reference's rules); "distinct" only
ranks sets that repeat a correspondence last; "keep" only keeps a refit
that loses no inlier; "f64" the reference's rules on a float64 normal
matrix (the kernel's arithmetic through its plain version).  The port's
own rules are both of the first two; `chip_smoke.py` runs them.  Prints
which assertions hold on which seeds, and whether the gate passed.

Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import traceback

import torch

import chip_smoke as cs
from siftgpu_tpu_torch import MatchConfig, SiftConfig
from siftgpu_tpu_torch.core.precision import full_f32
from siftgpu_tpu_torch.geometry import epipolar
from siftgpu_tpu_torch.ops import small_eig as se
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import slam

VARIANTS = ("reference", "distinct", "keep", "f64")


def normal_matrices(x0, x1, w, f64=False):
    """`eight_point`'s normal matrices A^T diag(w) A (in float64 with `f64`)
    and its Hartley transforms."""
    x0n, T0 = epipolar._normalize_for_dlt(x0, w)
    x1n, T1 = epipolar._normalize_for_dlt(x1, w)
    u0, v0, u1, v1 = x0n[..., 0], x0n[..., 1], x1n[..., 0], x1n[..., 1]
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, torch.ones_like(u0)],
                    dim=-1)
    if f64:
        A, w = A.double(), w.double()
    with full_f32():
        return (A * w[..., None]).transpose(-1, -2) @ A, T0, T1


def eight_point_f64(x0, x1, w):
    """`eight_point` on a float64 normal matrix, its eigen solve the
    kernel's arithmetic (`eigh_sym_plain`)."""
    M, T0, T1 = normal_matrices(x0, x1, w, f64=True)
    with full_f32():
        _, vecs = se.eigh_sym_plain(M)
        E = T1.transpose(-1, -2) @ vecs[..., 0].reshape(*vecs.shape[:-2], 3, 3) @ T0
        U, s, Vt = se.svd3(E)
        sm = (s[..., 0] + s[..., 1]) / 2.0
        return (U * torch.stack([sm, sm, torch.zeros_like(sm)], -1)[..., None, :]) @ Vt


def ransac(x0, x1, mask, idx, threshold=1e-4, refine_iters=2, distinct=False, keep=False,
           eight_point=epipolar.eight_point):
    """`ransac_from_samples` with each of its two rules on or off."""
    idx = idx.to(torch.int64)
    Es = eight_point(x0[idx], x1[idx], torch.ones(idx.shape, dtype=x0.dtype, device=x0.device))
    inls = (epipolar.sampson_distance(Es, x0, x1) < threshold) & mask
    scores = inls.sum(-1)
    rank = scores
    if distinct:
        once = (idx[:, :, None] == idx[:, None, :]).sum((-1, -2)) == idx.shape[1]
        rank = scores + once.to(scores.dtype) * (x0.shape[0] + 1)
    best = torch.argmax(rank).reshape(1)
    E, inliers = Es[best][0], inls[best][0]
    for _ in range(refine_iters):
        E_new = eight_point(x0, x1, inliers.to(x0.dtype))
        inl_new = (epipolar.sampson_distance(E_new, x0, x1) < threshold) & mask
        take = inl_new.sum() >= inliers.sum() if keep else torch.ones((), dtype=torch.bool)
        E = torch.where(take, E_new, E)
        inliers = torch.where(take, inl_new, inliers)
    return epipolar.RansacResult(E=E, inliers=inliers, num_inliers=inliers.sum().to(torch.int32),
                                 best_score=scores[best][0].to(torch.int32))


@contextlib.contextmanager
def variant(name):
    rules = {"reference": {}, "distinct": {"distinct": True}, "keep": {"keep": True},
             "f64": {"eight_point": eight_point_f64}}[name]
    kept = epipolar.ransac_from_samples
    epipolar.ransac_from_samples = lambda *a, **kw: ransac(*a, **kw, **rules)
    try:
        yield
    finally:
        epipolar.ransac_from_samples = kept


def scores(Es, x0, x1, mask, thr):
    return ((epipolar.sampson_distance(Es, x0, x1) < thr) & mask).sum(-1)


def record(out_dir="chiprun_out"):
    dev = torch.device("cuda")
    os.makedirs(out_dir, exist_ok=True)
    cs.log(cs.card_line())
    for seed in cs.ONLINE_SEEDS:
        frames, _, intr = cs.slam_loop_scene(fixtures, 144, 192, seed=seed)
        calls = []
        with cs.recorded_calls(epipolar, "ransac_from_samples", calls):
            slam.run_slam(frames, intr, SiftConfig(height=144, width=192, max_keypoints=384),
                          MatchConfig(max_match=384), cs.weak_slam_config(slam, 192),
                          device=dev)
        (x0, x1, mask, idx), thr = calls[0][0][:4], float(calls[0][1]["threshold"])
        idx = idx.to(torch.int64)
        ones = torch.ones(idx.shape, device=dev)
        M = normal_matrices(x0[idx], x1[idx], ones)[0]
        rec = dict(x0=x0.cpu(), x1=x1.cpu(), mask=mask.cpu(), idx=idx.cpu(), thr=thr, M=M.cpu(),
                   vec_kernel=se.eigh_sym(M)[1][..., 0].cpu(),
                   vec_linalg=torch.linalg.eigh(M)[1][..., 0].cpu())
        rec["scores_kernel"] = scores(epipolar.eight_point(x0[idx], x1[idx], ones), x0, x1, mask,
                                      thr).cpu()
        kept = se.eigh_sym, se.svd3
        se.eigh_sym, se.svd3 = torch.linalg.eigh, torch.linalg.svd
        try:
            rec["scores_linalg"] = scores(epipolar.eight_point(x0[idx], x1[idx], ones), x0, x1,
                                          mask, thr).cpu()
        finally:
            se.eigh_sym, se.svd3 = kept
        torch.save(rec, os.path.join(out_dir, f"boot_{seed}.pt"))
        cs.log(f"  seed {seed}: {int(mask.sum())} matches recorded")


def eight_point_all_f64(x0, x1, w):
    """The 8-point algorithm with every step in float64 (LAPACK)."""
    M, T0, T1 = normal_matrices(x0, x1, w)
    V = torch.linalg.eigh(M)[1]
    E = T1.transpose(-1, -2) @ V[..., 0].reshape(*V.shape[:-2], 3, 3) @ T0
    U, s, Vt = torch.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) / 2
    return (U * torch.stack([sm, sm, torch.zeros_like(sm)], -1)[..., None, :]) @ Vt


def refits(r, win):
    """Inliers of set `win` and after each of the reference's two refits,
    with the kernel's arithmetic (its plain version) on the f32 inputs."""
    x0, x1, mask, thr = r["x0"], r["x1"], r["mask"], r["thr"]
    kept = se.eigh_sym, se.svd3
    se.eigh_sym, se.svd3 = se.eigh_sym_plain, se.svd3_plain
    try:
        sel = r["idx"][win]
        E = epipolar.eight_point(x0[sel], x1[sel], torch.ones(len(sel)))
        counts = []
        for _ in range(3):
            inl = (epipolar.sampson_distance(E, x0, x1) < thr) & mask
            counts.append(int(inl.sum()))
            E = epipolar.eight_point(x0, x1, inl.to(x0.dtype))
        return counts
    finally:
        se.eigh_sym, se.svd3 = kept


def witness(in_dir="chiprun_out"):
    out = {}
    for seed in cs.ONLINE_SEEDS:
        path = os.path.join(in_dir, f"boot_{seed}.pt")
        if not os.path.exists(path):
            continue
        r = torch.load(path)
        x0, x1, mask, idx, thr = (r["x0"].double(), r["x1"].double(), r["mask"], r["idx"],
                                  r["thr"])
        repeats = torch.tensor([len(set(row.tolist())) < idx.shape[1] for row in idx])
        ev, V = torch.linalg.eigh(r["M"].double())
        gap = (ev[:, 1] - ev[:, 0]) / ev[:, -1]
        truth = scores(eight_point_all_f64(x0[idx], x1[idx], torch.ones(idx.shape,
                                                                         dtype=torch.float64)),
                       x0, x1, mask, thr)
        rec = {"matches": int(mask.sum()), "repeating_sets": int(repeats.sum()),
               "sets": len(idx), "gap_median_repeating": float(gap[repeats].median()),
               "gap_median_distinct": float(gap[~repeats].median())}
        for name in ("kernel", "linalg"):
            v = r[f"vec_{name}"].double()
            cos = (v * V[..., 0]).sum(-1) / v.norm(dim=-1)
            rec[f"sin_{name}_median"] = float(torch.sqrt(torch.clamp(1 - cos * cos, min=0))
                                              .median())
            win = int(torch.argmax(r[f"scores_{name}"]))
            rec[f"winner_{name}"] = {"set": win, "repeats": bool(repeats[win]),
                                     "kernel": int(r["scores_kernel"][win]),
                                     "linalg": int(r["scores_linalg"][win]),
                                     "float64": int(truth[win]),
                                     "refits": refits(r, win)}
        out[seed] = rec
        cs.log(f"  seed {seed}: {rec}")
    print(json.dumps(out))


def variants(names):
    dev = torch.device("cuda")
    cs.log(cs.card_line())
    for name in names:
        with variant(name):
            cs.log(f"=== online step, RANSAC variant {name}")
            try:
                cs.online_phase(dev, torch.cuda.synchronize)
                cs.log(f"=== variant {name}: the gate passed")
            except AssertionError:
                cs.log(f"=== variant {name}: the gate failed: "
                       + traceback.format_exc().strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("record", "witness", "variants"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if argv[0] != "witness" and not torch.cuda.is_available():
        print(f"{argv[0]} needs a CUDA card", file=sys.stderr)
        return 1
    if argv[0] == "record":
        record(*argv[1:2])
    elif argv[0] == "witness":
        witness(*argv[1:2])
    else:
        bad = [n for n in argv[1:] if n not in VARIANTS]
        if bad or len(argv) < 2:
            print(f"variants: choose from {VARIANTS}", file=sys.stderr)
            return 2
        variants(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
