"""The match kernel's tiling, checked where no card is.

`csrc/match_best2.cu` runs as `ops/match_kernel.py::launch_plan` states it:
128-row tiles of one pair, 64-column tiles grouped into column splits, a
block per (row tile, split, pair).  Inside a block each thread keeps a
running (best, second, argbest) over its columns in ascending order; the 4
lanes of a row, then the 4 column quarters, then the splits merge by the
reference's rule; each column's argbest row is the max of ordered
(sim bits, ~row) keys over the rows of each row tile, then over row tiles.
These tests hold the plan to the kernel source's constants, check that it
covers every (pair, row, column) exactly once, and check a NumPy model of
that reduction tree against the plain version's dense selection on sets
built to stress it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from siftgpu_tpu_torch.ops import match_kernel as mk

CSRC = Path(mk.__file__).resolve().parent.parent / "csrc" / "match_best2.cu"


def _csrc_constants():
    src = CSRC.read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("BM", "BN", "KB", "kThreads", "kStages", "kMaskW", "kMaskWords")}


def _covered(plan, P, N0, N1):
    """How many blocks of the plan own each (pair, row, column), counted per
    (pair, 128-row tile, column): a block owns whole rows of its tile, and
    the tiles cover the rows [0, N0) once."""
    bm, bn = plan["tile"]
    tps = plan["tiles_per_split"]
    rt, ns, pp = plan["grid"]
    assert (rt - 1) * bm < N0 <= rt * bm
    n = np.zeros((P, rt, N1), np.uint8)
    for p in range(pp):
        for r in range(rt):
            for s in range(ns):
                cols = slice(s * tps * bn, min((s + 1) * tps * bn, N1))
                assert cols.start < N1, "an empty split"
                n[p, r, cols] += 1
    return n


@pytest.mark.parametrize("gate", [None, "h", "f", "hf"])
@pytest.mark.parametrize("P,N0,N1", [(3, 1, 1), (2, 100, 333), (2, 333, 100), (3, 2048, 2048),
                                     (1, 4096, 4096), (1, 16384, 16384)], ids=str)
def test_launch_plan_covers_every_pair_once(P, N0, N1, gate):
    plan = mk.launch_plan(P, N0, N1, gate)
    c = _csrc_constants()
    assert plan["tile"] == (c["BM"], c["BN"]) == (128, 64)
    assert plan["threads"] == c["kThreads"] and plan["stages"] == c["kStages"]
    assert mk.PITCH == c["KB"] + 16 and mk.MASK_W == c["kMaskW"] >= 4 * c["kMaskWords"]
    assert 4 * c["kMaskWords"] >= 3 + c["BN"]    # BN mask bytes from any offset in a word
    rows, cols = {None: (0, 0), "h": (2, 2), "f": (5, 5), "hf": (7, 5)}[gate]
    assert plan["smem_bytes"] == (128 * 144 + 2 * 64 * 144 + 2 * 64 * 8 + 2 * 64 * 4 * (1 + cols)
                                  + rows * 128 * 4 + 2 * 80) <= 232_448
    assert plan["grid"] == (-(-N0 // 128), plan["splits"], P)
    assert plan["scratch"] == (3, P, N0, plan["splits"])
    assert plan["atomics_per_column"] == -(-N0 // 128)
    assert (_covered(plan, P, N0, N1) == 1).all()
    blocks = plan["grid"][0] * plan["splits"] * P
    if plan["col_tiles"] >= -(-mk.TARGET_BLOCKS // (plan["row_tiles"] * P)):
        assert blocks >= mk.TARGET_BLOCKS * 0.9      # the grid fills the card
    if (P, N0, N1) == (3, 2048, 2048):
        assert (plan["tiles_per_split"], plan["splits"], blocks) == (3, 11, 528)
    if (P, N0, N1) == (1, 4096, 4096):
        assert (plan["tiles_per_split"], plan["splits"], blocks) == (4, 16, 512)
    if (P, N0, N1) == (1, 16384, 16384):
        # bench.py's 16k pair: 128 row tiles x 256 column tiles; the scratch
        # holds 3 x 16384 x 5 int32, each column takes 128 atomics
        assert (plan["row_tiles"], plan["col_tiles"]) == (128, 256)
        assert (plan["tiles_per_split"], plan["splits"], blocks) == (52, 5, 640)


def test_launch_plan_refuses_empty_sets():
    with pytest.raises(ValueError, match="empty"):
        mk.launch_plan(1, 0, 8)


# ---- a NumPy model of the kernel's reduction tree ----

def _merge(a, b):
    """The reference's merge of disjoint candidates (B, S, J) -> (B, S, J)."""
    B, S, J = a
    b2, s2, j2 = b
    S = np.maximum(np.maximum(S, s2), np.minimum(B, b2))
    J = np.where((b2 > B) | ((b2 == B) & (j2 < J)), j2, J)
    return np.maximum(B, b2), S, J


def _order_bits(v):
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _kernel_model(sim, N1, plan):
    """(bsim, ssim, bestj, col_best_i) of one pair's masked similarity
    [N0, N1] (-inf where masked or gated) as csrc/match_best2.cu reduces it."""
    N0 = sim.shape[0]
    bm, bn = plan["tile"]
    tps, ns = plan["tiles_per_split"], plan["splits"]
    big = np.int64(0x7FFFFFFF)
    # thread state per (row, split, column quarter, lane): running best-2
    B = np.full((N0, ns, 4, 4), -np.inf, np.float32)
    S = np.full_like(B, -np.inf)
    J = np.full(B.shape, big, np.int64)
    for j in range(N1):   # ascending columns: each goes to one thread
        s, cc = j // (tps * bn), j % bn
        wc, tig = cc // 16, (cc % 8) // 2
        x = sim[:, j]
        b, se, bj = B[:, s, wc, tig], S[:, s, wc, tig], J[:, s, wc, tig]
        up = (x > b) | ((x == b) & (j < bj))
        S[:, s, wc, tig] = np.where(up, b, np.maximum(se, x))
        B[:, s, wc, tig] = np.where(up, x, b)
        J[:, s, wc, tig] = np.where(up, j, bj)
    lanes = [(B[..., t], S[..., t], J[..., t]) for t in range(4)]
    for off in (1, 2):    # __shfl_xor_sync over the 4 lanes of a row
        lanes = [_merge(lanes[t], lanes[t ^ off]) for t in range(4)]
    acc = tuple(x[:, :, 0] for x in lanes[0])
    for wc in range(1, 4):  # column quarters, ascending
        acc = _merge(acc, tuple(x[:, :, wc] for x in lanes[0]))
    out = tuple(x[:, 0] for x in acc)
    for s in range(1, ns):  # splits, ascending (the second kernel)
        out = _merge(out, tuple(x[:, s] for x in acc))
    # columns: max of (order bits, ~row) per row tile, then across row tiles
    key = (_order_bits(sim) << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                                   - np.arange(N0, dtype=np.uint64)[:, None])
    tiles = [key[r : r + bm].max(0) for r in range(0, N0, bm)]
    colkey = np.maximum.reduce(tiles)
    colbest = (np.uint64(0xFFFFFFFF) - (colkey & np.uint64(0xFFFFFFFF))).astype(np.int64)
    return out[0], out[1], out[2], colbest


def _stress_set(case, seed=0):
    """d0 [300, 128], d1 [701, 128] uint8, masks and a keep matrix, with the
    structure `case` names placed across the 128-row tiles and the column
    splits of 64-column tiles."""
    rng = np.random.default_rng(seed)
    d0 = rng.integers(0, 256, (300, 128), dtype=np.uint8)
    d1 = rng.integers(0, 256, (701, 128), dtype=np.uint8)
    m0 = rng.random(300) > 0.1
    m1 = rng.random(701) > 0.1
    keep = np.ones((300, 701), bool)
    if case in ("best duplicated across splits", "best equals second"):
        d1[[10, 200, 650]] = d0[5]           # columns in different splits
        m0[5] = True
        m1[[10, 200, 650]] = True
        if case == "best equals second":
            m1[650] = False
    elif case == "equal rows across row tiles":
        d0[[140, 290]] = d0[5]
        d1[333] = d0[5]
        m0[[5, 140, 290]] = True
        m1[333] = True
    elif case == "all masked":
        m0[:] = False
    elif case == "rows gated out":
        keep[100:260] = False
        keep[:, 64:128] = False
    elif case == "column -inf everywhere":
        m1[[0, 64, 700]] = False
        keep[:, 500] = False
    return d0, d1, m0, m1, keep


CASES = ["best duplicated across splits", "best equals second", "equal rows across row tiles",
         "all masked", "rows gated out", "column -inf everywhere"]


@pytest.mark.parametrize("tps", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_split_model_matches_dense_selection(case, tps):
    """The kernel's reduction tree (thread, lanes, column quarters, splits;
    column keys per row tile) gives the plain version's dense selection bit
    for bit, with one or three column tiles per split."""
    d0, d1, m0, m1, keep = _stress_set(case)
    t0, t1 = torch.from_numpy(d0)[None], torch.from_numpy(d1)[None]
    rn0, rn1 = mk.recip_norms(t0), mk.recip_norms(t1)
    tm0, tm1, tk = (torch.from_numpy(a)[None] for a in (m0, m1, keep))
    ref = mk.best2_dense(mk._u8_sim(t0, t1, rn0, rn1), tm0, tm1, tk)
    sim = torch.where(tm0[..., :, None] & tm1[..., None, :] & tk,
                      mk._u8_sim(t0, t1, rn0, rn1), float("-inf"))[0].numpy()
    plan = dict(mk.launch_plan(1, 300, 701))
    plan["tiles_per_split"] = tps
    plan["splits"] = -(-plan["col_tiles"] // tps)
    got = _kernel_model(sim, 701, plan)
    for name, g, r in zip(("bsim", "ssim", "bestj", "col_best_i"), got, ref):
        r = r[0].numpy()
        if r.dtype == np.float32:
            assert np.array_equal(g.astype(np.float32).view(np.int32), r.view(np.int32)), name
        else:
            assert np.array_equal(g, r), name
    if case == "best equals second":
        assert ref[0][0, 5] == ref[1][0, 5] and int(ref[2][0, 5]) == 10
    if case == "best duplicated across splits":
        assert int(ref[3][0, 200]) == 5 and int(ref[2][0, 5]) == 10
    if case == "equal rows across row tiles":
        assert int(ref[3][0, 333]) == 5
    if case in ("all masked", "rows gated out"):
        rows = slice(None) if case == "all masked" else slice(100, 260)
        assert np.isneginf(ref[0][0, rows].numpy()).all() and (ref[2][0, rows] == 0).all()
    if case == "column -inf everywhere":
        assert (ref[3][0, [0, 64, 500, 700]] == 0).all()
