"""The detect kernel's tiling, checked where no card is.

`csrc/detect_scores.cu` runs as `ops/detect_scores.py::launch_plan` states
it: a block per frame and 16 x 64 tile of the even-padded (He, We) output,
walking all S slices or, for planes of few tiles, one slice each; 256
threads, each a row pair x 2 columns; each DoG plane of a tile staged with
its halo into a 4-plane ring.  These tests hold the plan to the kernel
source's constants and check that its blocks and threads write every
(b, s, y, x) of the outputs exactly once, odd sizes and planes smaller than
one tile included.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from siftgpu_tpu_torch.ops import detect_scores as ds

CSRC = Path(ds.__file__).resolve().parent.parent / "csrc" / "detect_scores.cu"


def _csrc_constants():
    src = CSRC.read_text()
    return {k: int(re.search(rf"\b{k} = (\d+)[,;]", src).group(1))
            for k in ("TH", "TW", "kThreads", "kRing")}


def _written(plan, B, S):
    """How often the plan's threads write each (b, s, y, x) of (He, We)."""
    He, We = plan["out_shape"]
    th, tw = plan["tile"]
    py, px = plan["thread_pixels"]
    spb = plan["slices_per_block"]
    groups = S // spb
    threads = np.arange(plan["threads"])
    rp, xp = threads // (tw // px), threads % (tw // px)
    n = np.zeros((B, S, He, We), np.int32)
    gx, gy, gz = plan["grid"]
    for z in range(gz):
        b, s0 = z // groups, (z % groups) * spb
        for by in range(gy):
            for bx in range(gx):
                y, x = by * th + py * rp, bx * tw + px * xp
                live = (y < He) & (x < We)
                for s in range(s0, s0 + spb):
                    for dy in range(py):
                        for dx in range(px):
                            np.add.at(n, (b, s, y[live] + dy, x[live] + dx), 1)
    return n


@pytest.mark.parametrize("B,S,H,W", [(4, 3, 480, 640), (4, 3, 30, 40), (2, 3, 9, 13),
                                     (1, 4, 35, 68), (4, 3, 251, 331), (1, 3, 17, 65),
                                     (3, 2, 64, 64), (1, 1, 1, 2)], ids=str)
def test_launch_plan_writes_every_output_once(B, S, H, W):
    plan = ds.launch_plan(B, S, H, W)
    c = _csrc_constants()
    assert plan["tile"] == (c["TH"], c["TW"]) == (16, 64)
    assert plan["threads"] == c["kThreads"] == 256 and plan["ring"] == c["kRing"] == 4
    assert plan["threads"] == (plan["tile"][0] // 2) * (plan["tile"][1] // 2)
    assert plan["window"] == (18, 72) and plan["smem_bytes"] == 4 * 18 * 72 * 4 <= 48 * 1024
    He, We = H + H % 2, W + W % 2
    assert plan["out_shape"] == (He, We)
    assert plan["vector_loads"] == (W % 4 == 0)
    assert S % plan["slices_per_block"] == 0
    tiles = -(-We // 64) * -(-He // 16)
    assert plan["slices_per_block"] == (S if tiles * B >= ds.MIN_BLOCKS else 1)
    assert (_written(plan, B, S) == 1).all()


def test_launch_plan_refuses_empty_volumes():
    with pytest.raises(ValueError, match="empty"):
        ds.launch_plan(1, 0, 8, 8)
