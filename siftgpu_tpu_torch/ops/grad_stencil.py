"""Central-difference gradient stack: CUDA kernel + plain version.

Replaces `siftgpu_tpu/ops/grad_stencil.py::grad_stencil` (Pallas) and mirrors
the XLA route of `siftgpu_tpu/frontend/orient.py::gradient_stack`:

    gx = 0.5 (g[y, x+1] - g[y, x-1])   (one-sided, unhalved, at x = 0 / W-1)
    gy = 0.5 (g[y+1, x] - g[y-1, x])   (one-sided, unhalved, at y = 0 / H-1)

over Gaussian levels 1..S, zero beyond (H, W) up to (Hp, Wp) =
(max(H, min_h), max(W, min_w)), stored as bf16 with round-to-nearest-even.
A spatial slab passes `y0` (the image row of its row 0, negative above the
image) and `global_h` (the image's height): after the difference, gy is
doubled at the rows where y + y0 is 0 or global_h - 1, the image's edge
rows that lie inside the slab, whose central difference is half the
one-sided one of the whole image (`siftgpu_tpu/ops/grad_stencil.py:86-95`).

`grad_stencil(gauss, S, min_h, min_w, y0, global_h)` takes the plain version for a CPU
tensor and the CUDA kernel (`csrc/grad_stencil.cu`, its launch stated by
`launch_plan`) for a CUDA tensor; the two are bit-identical (one subtraction
and one exact halving per value).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["grad_stencil", "grad_stencil_plain", "factor_rows", "launch_plan", "KERNEL"]

KERNEL = _build.Kernel(
    "grad_stencil", "grad_stencil.cu",
    {"grad_stencil_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
     + [ctypes.c_void_p]},
)

# csrc/grad_stencil.cu's constants: consecutive x of a thread, its rows on
# large planes, the threads of a block (at most), and the blocks a grid of
# such strips needs (4 per SM of the H100's 132), else a thread takes 1 row
COLS, ROWS, THREADS, MIN_BLOCKS = 8, 4, 256, 4 * 132


def launch_plan(B: int, S: int, H: int, W: int, Hp: int, Wp: int) -> dict:
    """The kernel's launch for gauss [B, S+3, H, W] -> [B, S, Hp, Wp], as
    `csrc/grad_stencil.cu` runs it: a thread owns 8 consecutive x (a
    column chunk) and a strip of `rows` rows (4 where that grid has at
    least MIN_BLOCKS blocks, else 1); a block is `threads` = (tx, ty), tx
    the plane's chunks rounded up to whole warps (at most 256) and ty =
    256 // tx strips; the grid is (column blocks, strip blocks, B * S
    planes).  `vector`: W and Wp are multiples of 8, so the kernel loads
    float4 pairs and stores 16-byte bf16 vectors (given 16-byte aligned
    pointers, as PyTorch allocates them); scalar accesses otherwise."""
    if min(B, S, H, W) <= 0 or Hp < H or Wp < W:
        raise ValueError(f"launch_plan: bad shapes ({B}, {S}, {H}, {W}) -> ({Hp}, {Wp})")
    chunks = -(-Wp // COLS)
    tx = THREADS if chunks >= THREADS else -(-chunks // 32) * 32
    ty = THREADS // tx
    gx = -(-chunks // tx)
    rows = ROWS if gx * -(-Hp // (ROWS * ty)) * B * S >= MIN_BLOCKS else 1
    return dict(cols=COLS, rows=rows, threads=(tx, ty), grid=(gx, -(-Hp // (rows * ty)), B * S),
                vector=W % COLS == 0 and Wp % COLS == 0)


def factor_rows(y0=None, global_h=None) -> tuple:
    """The slab rows whose gy is doubled, (-y0, global_h - 1 - y0), or
    (-1, -1) (none) without a slab."""
    if y0 is None or global_h is None:
        return -1, -1
    return -int(y0), int(global_h) - 1 - int(y0)


def grad_stencil_plain(gauss: torch.Tensor, S: int, min_h: int, min_w: int, y0=None,
                       global_h=None):
    """gauss: [B, S+3, H, W] f32 -> (gx, gy) [B, S, Hp, Wp] bf16."""
    g = gauss[:, 1 : S + 1].to(torch.float32)
    B, _, H, W = g.shape
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1), mode="replicate")
    gx = 0.5 * (gp[:, :, 1 : H + 1, 2:] - gp[:, :, 1 : H + 1, :W])
    gy = 0.5 * (gp[:, :, 2:, 1 : W + 1] - gp[:, :, :H, 1 : W + 1])
    gx[:, :, :, 0] = g[:, :, :, 1] - g[:, :, :, 0]
    gx[:, :, :, -1] = g[:, :, :, -1] - g[:, :, :, -2]
    gy[:, :, 0, :] = g[:, :, 1, :] - g[:, :, 0, :]
    gy[:, :, -1, :] = g[:, :, -1, :] - g[:, :, -2, :]
    if y0 is not None and global_h is not None:
        grow = torch.arange(H, device=g.device) + int(y0)
        factor = torch.where((grow == 0) | (grow == int(global_h) - 1), 2.0, 1.0)
        gy = gy * factor[:, None]
    ph, pw = max(0, min_h - H), max(0, min_w - W)
    gx = torch.nn.functional.pad(gx, (0, pw, 0, ph))
    gy = torch.nn.functional.pad(gy, (0, pw, 0, ph))
    return gx.to(torch.bfloat16), gy.to(torch.bfloat16)


def _grad_stencil_cuda(gauss: torch.Tensor, S: int, min_h: int, min_w: int, y0=None,
                       global_h=None):
    _build.check_tensor(gauss, "gauss", torch.float32, 4)
    B, L, H, W = gauss.shape
    if L < S + 1 or H < 2 or W < 2:
        raise ValueError(f"gauss: shape {tuple(gauss.shape)} too small for S={S}")
    Hp, Wp = max(H, min_h), max(W, min_w)
    out = torch.empty((2, B, S, Hp, Wp), dtype=torch.bfloat16, device=gauss.device)
    p = _build.ptr
    KERNEL.launch("grad_stencil_launch", gauss.device,
                  p(gauss), p(out[0]), p(out[1]), B, L, S, H, W, Hp, Wp,
                  *factor_rows(y0, global_h))
    return out[0], out[1]


def grad_stencil(gauss: torch.Tensor, S: int, min_h: int = 0, min_w: int = 0, y0=None,
                 global_h=None):
    """Gradients of Gaussian levels 1..S of gauss [B, S+3, H, W] f32 ->
    (gx, gy) [B, S, max(H, min_h), max(W, min_w)] bf16; `y0` (an int) and
    `global_h` give a spatial slab's place in the image (default: none)."""
    if gauss.device.type == "cpu":
        return grad_stencil_plain(gauss, S, min_h, min_w, y0, global_h)
    return _grad_stencil_cuda(gauss, S, min_h, min_w, y0, global_h)
