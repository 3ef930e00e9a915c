"""Gradient stack for orientation assignment and descriptor sampling.

Port of `siftgpu_tpu/frontend/orient.py::gradient_stack`: the stack holds
the gradients of Gaussian levels 1..S, zero-padded to at least the
orientation window, stored as bf16 (round-to-nearest-even).  The top-K and
orientation budgets of the reference rest on that storage.  A spatial slab
(`parallel/spatial.py`) gives its place in the image, `y0` (the image row
of its row 0) and `global_h` (the image's height): the gradient kernel
doubles gy on the image's edge rows inside the slab, and window rows and
descriptor samples outside the image are masked in image rows.

The extraction's orientation histogram runs inside the fused orientation +
sampling kernel (`ops/kp_engine.py`).  `compute_orientations` ports the
reference's unfused route (a chunked one-hot contraction over each
keypoint's window), in plain PyTorch on any device; no extraction path of
the port calls it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import SiftConfig
from ..core.precision import full_f32
from ..ops.grad_stencil import grad_stencil
from ..ops.kp_engine import TWO_PI, exp_window
from .detect import OctaveKeypoints

__all__ = ["GradStack", "gradient_stack", "compute_orientations"]


class GradStack(NamedTuple):
    gx: torch.Tensor                 # [B, S, Hp, Wp] bf16
    gy: torch.Tensor                 # [B, S, Hp, Wp] bf16
    h: int                           # true (unpadded) height of the plane (slab)
    w: int                           # true width
    y0: int = 0                      # image row of plane row 0 (a slab's; 0 for an image)
    global_h: Optional[int] = None   # the image's height (None: h)

    @property
    def image_h(self) -> int:
        return self.h if self.global_h is None else self.global_h


def gradient_stack(gauss: torch.Tensor, cfg: SiftConfig, y0: Optional[int] = None,
                   global_h: Optional[int] = None) -> GradStack:
    """gauss: [B, S+3, H, W] -> central-difference grads of levels 1..S;
    `y0` and `global_h` place a spatial slab in the image."""
    H, W = gauss.shape[-2:]
    win = 2 * cfg.orient_window_radius + 1
    gx, gy = grad_stencil(gauss, cfg.dog_levels, min_h=win, min_w=win, y0=y0,
                          global_h=global_h)
    return GradStack(gx=gx, gy=gy, h=H, w=W, y0=0 if y0 is None else int(y0),
                     global_h=H if global_h is None else int(global_h))


def _hist_onehot(w: torch.Tensor, bins: torch.Tensor, nb: int, chunk: int = 128) -> torch.Tensor:
    """sum_p w[..., p] * onehot(bins[..., p], nb), one chunk of pixels at a
    time, the chunks added in order.  w, bins: [B, K, P] -> [B, K, nb]."""
    B, K, P = w.shape
    pad = (-P) % chunk
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
        bins = torch.nn.functional.pad(bins, (0, pad))
    h = torch.zeros((B, K, nb), dtype=w.dtype, device=w.device)
    with full_f32():
        for c in range(0, w.shape[-1], chunk):
            oh = torch.nn.functional.one_hot(bins[..., c : c + chunk], nb).to(w.dtype)
            h = h + torch.einsum("bkc,bkcn->bkn", w[..., c : c + chunk], oh)
    return h


def compute_orientations(grads: GradStack, kp: OctaveKeypoints,
                         cfg: SiftConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (theta [B, K, max_orientations], valid [B, K, max_orientations]).

    Slot 0 always carries an angle (0.0 when the histogram is empty); its
    validity equals the keypoint mask.  Higher slots are valid only when a
    distinct peak >= peak_ratio * max exists."""
    B, K = kp.y.shape
    R = cfg.orient_window_radius
    win = 2 * R + 1
    nb = cfg.orientation_bins
    S, Hp, Wp = grads.gx.shape[-3:]
    dev = grads.gx.device

    sy = (torch.round(kp.y).to(torch.int64) - R).clamp(0, Hp - win)      # [B, K]
    sx = (torch.round(kp.x).to(torch.int64) - R).clamp(0, Wp - win)
    lvl = kp.grad_level.to(torch.int64) - 1
    ar = torch.arange(win, device=dev)
    rows = sy[..., None] + ar                                             # [B, K, win]
    cols = sx[..., None] + ar
    b = torch.arange(B, device=dev)[:, None, None, None]
    flat = (((b * S + lvl[..., None, None]) * Hp + rows[..., :, None]) * Wp
            + cols[..., None, :])                                         # [B, K, win, win]
    # the stack is bf16 storage; the window math runs in f32
    wx = grads.gx.reshape(-1)[flat].to(torch.float32)
    wy = grads.gy.reshape(-1)[flat].to(torch.float32)

    oy = rows.to(torch.float32) - kp.y[..., None]
    ox = cols.to(torch.float32) - kp.x[..., None]
    r2 = oy[..., :, None] ** 2 + ox[..., None, :] ** 2
    sw = cfg.orientation_sigma_factor * kp.sigma
    radius = cfg.orientation_radius_factor * sw
    wgt = exp_window(-r2 / (2.0 * (sw * sw))[..., None, None])
    wgt = torch.where(r2 <= (radius * radius)[..., None, None], wgt, 0.0)
    grow = rows + grads.y0                                          # image rows
    row_ok = (grow >= 0) & (grow < grads.image_h)
    wgt = wgt * row_ok.to(torch.float32)[..., :, None]

    mag = torch.sqrt(wx * wx + wy * wy)
    ang = torch.atan2(wy, wx)
    ang = torch.where(ang < 0, ang + TWO_PI, ang)                  # floor-mod 2π
    bins = (ang * (nb / TWO_PI)).to(torch.int64).clamp(0, nb - 1)
    P = win * win
    hist = _hist_onehot((wgt * mag).reshape(B, K, P), bins.reshape(B, K, P), nb)

    for _ in range(6):  # circular box smoothing x6
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    mx = hist.amax(dim=-1, keepdim=True)
    is_peak = (hist > left) & (hist > right) & (hist >= cfg.orientation_peak_ratio * mx) & (mx > 0)
    peak_val = torch.where(is_peak, hist, float("-inf"))
    top, idx = torch.sort(peak_val, dim=-1, descending=True, stable=True)  # lax.top_k's ties
    top, idx = top[..., : cfg.max_orientations], idx[..., : cfg.max_orientations]

    li = torch.gather(hist, -1, (idx - 1) % nb)
    ri = torch.gather(hist, -1, (idx + 1) % nb)
    ci = torch.gather(hist, -1, idx)
    denom = li - 2.0 * ci + ri
    d = torch.where(denom.abs() < 1e-12, 0.0, 0.5 * (li - ri) / denom)
    theta = torch.remainder(TWO_PI * (idx.to(torch.float32) + 0.5 + d) / nb, TWO_PI)

    has_peak = torch.isfinite(top)
    theta = torch.where(has_peak, theta, 0.0)
    valid = has_peak & kp.mask[..., None]
    valid[..., 0] = kp.mask         # slot 0: one theta = 0 keypoint on an empty histogram
    return theta, valid
