"""Fused orientation assignment + descriptor gradient sampling: CUDA kernel
+ plain version.

Replaces `siftgpu_tpu/ops/kp_engine.py::orient_sample` (Pallas).  Per
keypoint, on the gradient plane of its level:

  1. a 36-bin histogram of gradient magnitude weighted by `exp_window`, over
     the (2R+1)^2 window clipped to the plane ∩ the radius circle ∩ the
     image's rows, binned by floor(atan2 · nb/2π);
  2. box smoothing x6, peaks > both neighbours and >= peak_ratio · max, the
     `nori` highest kept (ties to the lowest bin), parabola-refined angle;
  3. for slot 0 and every further slot that has a peak, bilinear samples of
     gx, gy on the rotated G x G grid, zero outside the image.

The image's rows are plane rows shifted by `y0g`: a spatial slab passes the
image row of its row 0 and the image's height `global_h`, as the
reference's kernel takes them (`siftgpu_tpu/ops/kp_engine.py:378, 730-731`);
a whole image has y0g = 0 and global_h its true height.

The semantics are those of the reference's XLA route
(`orient.compute_orientations` + `describe._sample_coords` / `_bilerp_xla`),
with the kernel's two conventions: sigma is clamped to `max_detect_sigma`,
and slots without a peak (and masked keypoints) get zero samples.

`orient_sample(...)` takes the plain version for CPU tensors and the CUDA
kernel (`csrc/kp_engine.cu`: one warp per keypoint, 8 per block) for CUDA
tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["orient_sample", "orient_sample_plain", "exp_window", "EXPW", "KERNEL"]

TWO_PI = 6.283185307179586

# degree-7 least-squares fit of exp(x) on [-4.75, 0], the reference's
# Gaussian-window polynomial (siftgpu_tpu/ops/kp_engine.py::_EXPW)
EXPW = (
    2.1755081222e-05, 5.1727565826e-04, 5.5559910437e-03, 3.6198773900e-02,
    1.6038511456e-01, 4.9620069315e-01, 9.9901960879e-01, 9.9993781360e-01,
)

KERNEL = _build.Kernel(
    "orient_sample", "kp_engine.cu",
    {"orient_sample_launch": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
     + [ctypes.c_float] * 8 + [ctypes.c_void_p]},
    flags=["-fmad=false"],
)


def exp_window(x: torch.Tensor) -> torch.Tensor:
    """Polynomial stand-in for exp(x) on [-4.75, 0] (inputs clamped)."""
    x = torch.clamp(x, min=-4.75)
    acc = torch.full_like(x, EXPW[0])
    for c in EXPW[1:]:
        acc = acc * x + c
    return acc


def _f32(x: float) -> float:
    return float(np.float32(x))


def _geometry(cfg):
    R = cfg.orient_window_radius
    return dict(
        R=R, win=2 * R + 1, nb=cfg.orientation_bins, nori=cfg.max_orientations,
        G=cfg.descriptor_grid, sig_f=cfg.orientation_sigma_factor,
        rad_f=cfg.orientation_radius_factor, peak=cfg.orientation_peak_ratio,
        spacing=cfg.descriptor_spacing, spc_cell=cfg.descriptor_samples_per_cell,
        smax=_f32(cfg.max_detect_sigma),
    )


def orient_sample_plain(gx, gy, plane, ky, kx, sigma, cfg, mask, global_h, w_true, y0g=0):
    """Plain PyTorch version; see `orient_sample` for the contract."""
    g = _geometry(cfg)
    R, win, nb, nori, G = g["R"], g["win"], g["nb"], g["nori"], g["G"]
    P, Hp, Wp = gx.shape
    N = plane.shape[0]
    dev = gx.device
    plane = plane.to(torch.int64)
    sigma = torch.clamp(sigma.to(torch.float32), max=g["smax"])

    # ---- orientation window (clipped to the plane) ----
    iy = torch.round(ky).to(torch.int64)
    ix = torch.round(kx).to(torch.int64)
    sy = (iy - R).clamp(0, Hp - win)
    sx = (ix - R).clamp(0, Wp - win)
    ar = torch.arange(win, device=dev)
    rows = sy[:, None] + ar                                  # [N, win]
    cols = sx[:, None] + ar
    flat = (plane[:, None, None] * Hp + rows[:, :, None]) * Wp + cols[:, None, :]
    wx = gx.reshape(-1)[flat].to(torch.float32)              # [N, win, win]
    wy = gy.reshape(-1)[flat].to(torch.float32)
    oy = rows.to(torch.float32) - ky[:, None]
    ox = cols.to(torch.float32) - kx[:, None]
    r2 = oy[:, :, None] * oy[:, :, None] + ox[:, None, :] * ox[:, None, :]
    sw = g["sig_f"] * sigma
    radius = g["rad_f"] * sw
    wgt = exp_window(-r2 / (2.0 * (sw * sw))[:, None, None])
    wgt = torch.where(r2 <= (radius * radius)[:, None, None], wgt, 0.0)
    grow = rows + int(y0g)                                    # image rows
    wgt = wgt * ((grow >= 0) & (grow < global_h)).to(torch.float32)[:, :, None]
    mag = torch.sqrt(wx * wx + wy * wy)
    ang = torch.atan2(wy, wx)
    ang = torch.where(ang < 0, ang + TWO_PI, ang)            # floor-mod 2π
    bins = (ang * (nb / TWO_PI)).to(torch.int64).clamp(0, nb - 1)
    hist = torch.zeros((N, nb), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, bins.reshape(N, -1), (wgt * mag).reshape(N, -1))

    for _ in range(6):  # circular box smoothing x6
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    mx = hist.amax(dim=-1, keepdim=True)
    is_peak = (hist > left) & (hist > right) & (hist >= g["peak"] * mx) & (mx > 0)
    pv = torch.where(is_peak, hist, float("-inf"))
    top, idx = torch.sort(pv, dim=-1, descending=True, stable=True)
    top, idx = top[:, :nori], idx[:, :nori]
    li = torch.gather(hist, 1, (idx - 1) % nb)
    ri = torch.gather(hist, 1, (idx + 1) % nb)
    ci = torch.gather(hist, 1, idx)
    denom = li - 2.0 * ci + ri
    d = torch.where(denom.abs() < _f32(1e-12), 0.0, 0.5 * (li - ri) / denom)
    theta = TWO_PI * (idx.to(torch.float32) + 0.5 + d) / nb
    theta = torch.where(theta >= _f32(TWO_PI), theta - TWO_PI, theta)
    haspk = torch.isfinite(top) & mask[:, None]
    theta = torch.where(haspk, theta, 0.0)

    # ---- descriptor sampling on the rotated grid ----
    half = (G - 1) / 2.0
    t = torch.tensor(np.arange(G) - half, dtype=torch.float32, device=dev)
    spc = g["spacing"] * sigma / g["spc_cell"]                # [N]
    u = t[None, None, :] * spc[:, None, None]                 # [N, 1, G] cols
    v = t[None, :, None] * spc[:, None, None]                 # [N, G, 1] rows
    base = (plane * Hp * Wp)[:, None, None]
    gxf, gyf = gx.reshape(-1), gy.reshape(-1)
    sgx, sgy = [], []
    for o in range(nori):
        th = theta[:, o][:, None, None]
        ct, st = torch.cos(th), torch.sin(th)
        px = kx[:, None, None] + ct * u - st * v              # [N, G, G]
        py = ky[:, None, None] + st * u + ct * v
        x0 = torch.floor(px).to(torch.int64).clamp(0, Wp - 1)
        y0 = torch.floor(py).to(torch.int64).clamp(0, Hp - 1)
        x1 = (x0 + 1).clamp(max=Wp - 1)
        y1 = (y0 + 1).clamp(max=Hp - 1)
        fx = (px - x0.to(torch.float32)).clamp(0.0, 1.0)
        fy = (py - y0.to(torch.float32)).clamp(0.0, 1.0)
        pyg = py + int(y0g)
        inb = ((px >= 0.0) & (px <= w_true - 1) & (pyg >= 0.0) & (pyg <= global_h - 1))
        keep = mask if o == 0 else haspk[:, o]
        inb = (inb & keep[:, None, None]).to(torch.float32)

        def bilerp(f):
            def at(yi, xi):
                return f[base + yi * Wp + xi].to(torch.float32)
            return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x1) * (1 - fy) * fx
                    + at(y1, x0) * fy * (1 - fx) + at(y1, x1) * fy * fx)

        sgx.append((bilerp(gxf) * inb).reshape(N, G * G))
        sgy.append((bilerp(gyf) * inb).reshape(N, G * G))
    return theta, haspk, torch.cat(sgx, dim=1), torch.cat(sgy, dim=1)


def _orient_sample_cuda(gx, gy, plane, ky, kx, sigma, cfg, mask, global_h, w_true, y0g=0):
    g = _geometry(cfg)
    P, Hp, Wp = gx.shape
    N = plane.shape[0]
    for name, t, dt in (("gx", gx, torch.bfloat16), ("gy", gy, torch.bfloat16)):
        _build.check_tensor(t, name, dt, 3)
    for name, t, dt in (("plane", plane, torch.int32), ("ky", ky, torch.float32),
                        ("kx", kx, torch.float32), ("sigma", sigma, torch.float32),
                        ("mask", mask, torch.bool)):
        _build.check_tensor(t, name, dt, 1)
        if t.shape[0] != N:
            raise ValueError(f"{name}: expected {N} entries, got {t.shape[0]}")
    if gy.shape != gx.shape or Hp < g["win"] or Wp < g["win"]:
        raise ValueError(f"gradient planes {tuple(gx.shape)} / {tuple(gy.shape)} "
                         f"must match and cover the {g['win']}-px window")
    nori, G2 = g["nori"], g["G"] ** 2
    dev = gx.device
    theta = torch.empty((N, nori), dtype=torch.float32, device=dev)
    haspk = torch.empty((N, nori), dtype=torch.bool, device=dev)
    sgx = torch.empty((N, nori * G2), dtype=torch.float32, device=dev)
    sgy = torch.empty((N, nori * G2), dtype=torch.float32, device=dev)
    if N == 0:
        return theta, haspk, sgx, sgy
    p = _build.ptr
    KERNEL.launch(
        "orient_sample_launch", dev,
        p(gx), p(gy), p(plane), p(ky), p(kx), p(sigma), p(mask),
        p(theta), p(haspk), p(sgx), p(sgy),
        N, Hp, Wp, int(global_h), int(w_true), int(y0g), g["R"], g["nb"], nori, g["G"],
        _f32(g["sig_f"]), _f32(g["rad_f"]), _f32(g["peak"]), _f32(g["spacing"]),
        _f32(g["spc_cell"]), g["smax"], _f32(g["nb"] / TWO_PI), _f32(TWO_PI),
    )
    return theta, haspk, sgx, sgy


def orient_sample(gx, gy, plane, ky, kx, sigma, cfg, mask, global_h: int, w_true: int,
                  y0g: int = 0):
    """Fused orientation + descriptor gradient sampling.

    gx, gy: [P, Hp, Wp] bf16 gradient planes (P = batch·levels); plane: [N]
    int32 plane of each keypoint; ky, kx, sigma: [N] f32 octave-local (slab)
    geometry; mask: [N] bool; global_h, w_true: the image's height and true
    width, y0g: the image row of plane row 0 (window rows and samples outside
    the image are zero).  Returns (theta [N, nori] f32, haspk [N, nori]
    bool, sgx, sgy [N, nori·G²] f32).  Masked keypoints give zeros."""
    if gx.device.type == "cpu":
        return orient_sample_plain(gx, gy, plane, ky, kx, sigma, cfg, mask,
                                   global_h, w_true, y0g)
    return _orient_sample_cuda(gx, gy, plane, ky, kx, sigma, cfg, mask,
                               global_h, w_true, y0g)
