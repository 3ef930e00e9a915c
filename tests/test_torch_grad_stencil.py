"""Kernel 2's launch (`ops/grad_stencil.py::launch_plan`) and a NumPy model
of its threads (`csrc/grad_stencil.cu`) against the plain version.

  - the plan covers every (plane, y, x) of the padded (Hp, Wp) output
    exactly once, on the main path's octaves 0, 1 and 4, an odd plane, W < 8
    and the window padding (Hp > H, Wp > W), and says where the 16-byte
    vector path applies;
  - the model runs the kernel's threads as the plan lays them out (8
    columns x 1 or 4 rows a thread, the x-1 / x+8 halo from the
    neighbouring lane or, at a warp's edge, one scalar load) and gives the
    plain version's bf16 bits, across warp and block edges, with either
    strip height."""

import numpy as np
import pytest
import torch

from siftgpu_tpu_torch.ops import grad_stencil as gs

PLANS = [  # (B, S, H, W, Hp, Wp), vector path
    ((4, 3, 480, 640, 480, 640), True),     # main path, octave 0 (4-row strips)
    ((4, 3, 240, 320, 240, 320), True),     # octave 1 (1-row strips)
    ((4, 3, 30, 40, 35, 40), True),         # octave 4: rows padded to the window
    ((2, 3, 97, 131, 97, 131), False),      # odd plane
    ((1, 3, 5, 6, 35, 35), False),          # W < 8, both padded
    ((1, 2, 20, 24, 35, 40), True),         # Wp > W, both multiples of 8
    ((1, 2, 20, 16, 35, 35), False),        # Wp > W, Wp odd
]


@pytest.mark.parametrize("shape,vector", PLANS, ids=lambda v: str(v))
def test_launch_plan_covers_every_output_once(shape, vector):
    B, S, H, W, Hp, Wp = shape
    p = gs.launch_plan(*shape)
    tx, ty = p["threads"]
    assert tx % 32 == 0 and tx * ty <= 256 and p["vector"] is vector
    assert p["grid"][2] == B * S
    assert p["rows"] == (4 if H == 480 else 1)
    cols = np.zeros(Wp, int)
    for c in range(p["grid"][0] * tx):
        cols[c * p["cols"] : (c + 1) * p["cols"]] += 1
    rows = np.zeros(Hp, int)
    for r in range(p["grid"][1] * ty):
        rows[r * p["rows"] : (r + 1) * p["rows"]] += 1
    assert (cols == 1).all() and (rows == 1).all()


def _model(gauss: np.ndarray, S: int, Hp: int, Wp: int, rows: int) -> np.ndarray:
    """The kernel's threads, one by one, `rows` rows a thread: [B, L, H, W]
    f32 -> [2, B, S, Hp, Wp] f32 (the values before the bf16 rounding)."""
    B, L, H, W = gauss.shape
    p = gs.launch_plan(B, S, H, W, Hp, Wp)
    (tx, ty), gxn = p["threads"], p["grid"][0]
    C, R = p["cols"], rows
    gyn = -(-Hp // (R * ty))
    out = np.full((2, B, S, Hp, Wp), np.nan, np.float32)
    half = np.float32(0.5)
    for b in range(B):
        for s in range(S):
            g = gauss[b, s + 1]
            for strip in range(gyn * ty):
                y0 = strip * R
                if y0 >= Hp:
                    continue
                nchunk = gxn * tx
                # r[c][i]: the 8 values of chunk c on row y0 - 1 + i (0 outside)
                r = np.zeros((nchunk, R + 2, C), np.float32)
                for i in range(R + 2):
                    yy = y0 - 1 + i
                    if 0 <= yy < H:
                        row = np.zeros(nchunk * C, np.float32)
                        row[:W] = g[yy]
                        r[:, i] = row.reshape(nchunk, C)
                for c in range(nchunk):
                    x0, lane = c * C, c % 32
                    for i in range(R):
                        y = y0 + i
                        hl = r[c - 1, i + 1, C - 1] if lane > 0 else np.float32(0)
                        hr = r[c + 1, i + 1, 0] if lane < 31 else np.float32(0)
                        if y < H and lane == 0 and 0 < x0 <= W:
                            hl = g[y, x0 - 1]
                        if y < H and lane == 31 and x0 + C < W:
                            hr = g[y, x0 + C]
                        if y >= Hp:
                            break
                        for j in range(C):
                            x = x0 + j
                            if x >= Wp:
                                continue
                            vx = vy = np.float32(0)
                            if y < H and x < W:
                                cc = r[c, i + 1, j]
                                left = hl if j == 0 else r[c, i + 1, j - 1]
                                right = hr if j == C - 1 else r[c, i + 1, j + 1]
                                vx = (right - cc if x == 0 else cc - left if x == W - 1
                                      else half * (right - left))
                                vy = (r[c, i + 2, j] - cc if y == 0 else cc - r[c, i, j]
                                      if y == H - 1 else half * (r[c, i + 2, j] - r[c, i, j]))
                            out[:, b, s, y, x] = vx, vy
    return out


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("shape", [(1, 5, 9, 300, 9, 300), (1, 5, 6, 2100, 6, 2100),
                                   (2, 5, 13, 21, 35, 35), (1, 5, 7, 5, 35, 35)],
                         ids=["warp edge", "block edge", "padded", "W<8"])
def test_thread_model_matches_plain(shape, rows):
    B, L, H, W, Hp, Wp = shape
    gauss = np.random.default_rng(H * W).normal(0, 1, (B, L, H, W)).astype(np.float32)
    model = torch.from_numpy(_model(gauss, L - 2, Hp, Wp, rows)).to(torch.bfloat16)
    ref = gs.grad_stencil_plain(torch.from_numpy(gauss), L - 2, Hp, Wp)
    for m, r in zip(model, ref):
        assert torch.equal(m.view(torch.int16), r.view(torch.int16))
