"""Plain SIFT extraction: the benchmark's reference for the extraction cells.

A frozen copy of the plain PyTorch routes of `siftgpu_tpu_torch` at commit
72032356832fccc0fed74691f2666c2a15816fcf (`frontend/pyramid.py`,
`frontend/detect.py`, `frontend/fused.py`, `frontend/describe.py`,
`frontend/extract.py` and the plain versions in `ops/pyramid_kernel.py`,
`ops/detect_scores.py`, `ops/grad_stencil.py`, `ops/kp_engine.py`), with
every import of the port removed: it imports torch and NumPy only.  It
follows those routes operation for operation, on any device, so that a
sound program and this reference agree to rounding.

`extract(images, cfg, precision)` takes the frames the benchmark made and
works out every stage again: the 2x bilinear upsample where the first
octave is -1, pyramid, DoG extrema with the Cramer subpixel record, the
exact per-octave top-k and prefilter, orientation and the rotated
descriptor grid, binning and the top-K assembly with its truncation
preference (-tc, -tc1, -tc2).

`precision`: "f32" runs every convolution and matmul in full float32 (TF32
off, the configuration's precision); "tf32" rounds the operands of each of
them to TF32 (10 mantissa bits, nearest even) first, as the card's TF32
tensor cores do: the control that a comparison has to fail.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["SiftParams", "Features", "extract", "tf32_round", "TWO_PI"]

TWO_PI = 6.283185307179586

# degree-7 least-squares fit of exp(x) on [-4.75, 0] (ops/kp_engine.py::EXPW)
EXPW = (
    2.1755081222e-05, 5.1727565826e-04, 5.5559910437e-03, 3.6198773900e-02,
    1.6038511456e-01, 4.9620069315e-01, 9.9901960879e-01, 9.9993781360e-01,
)


@dataclasses.dataclass(frozen=True)
class SiftParams:
    """The extraction parameters the configuration file states (the
    `SiftConfig` fields that the extraction reads, same names)."""

    height: int
    width: int
    max_keypoints: int
    truncate_method: int = 0    # 0 the highest responses, 1 fine octaves first, 2 coarse first
    dog_levels: int = 3
    sigma0: float = 1.6
    sigma_n: float = 0.5
    first_octave: int = 0
    num_octaves: int = 0
    min_octave_dim: int = 16
    kernel_truncate: float = 4.0
    max_filter_width: int = 0
    dog_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    subpixel: bool = True
    border: int = 5
    max_orientations: int = 2
    orientation_bins: int = 36
    orientation_sigma_factor: float = 1.5
    orientation_radius_factor: float = 3.0
    orientation_peak_ratio: float = 0.8
    descriptor_width: int = 4
    descriptor_bins: int = 8
    descriptor_spacing: float = 3.0
    descriptor_samples_per_cell: int = 4
    descriptor_clip: float = 0.2

    def __post_init__(self):
        if self.first_octave not in (-1, 0):
            raise ValueError("the reference covers first_octave -1 and 0 only")

    @property
    def base_shape(self):
        """Octave 0's shape: the image's, twice it where the first octave is -1."""
        f = 2 if self.first_octave < 0 else 1
        return (self.height * f, self.width * f)

    @property
    def octaves(self) -> int:
        if self.num_octaves > 0:
            return self.num_octaves
        (h, w), n = self.base_shape, 0
        while min(h, w) >= self.min_octave_dim:
            n, h, w = n + 1, h // 2, w // 2
        return max(n, 1)

    def octave_shape(self, o: int):
        h, w = self.base_shape
        return (max(h >> o, 1), max(w >> o, 1))

    def octave_scale(self, o: int) -> float:
        """Octave o's pixel in image pixels."""
        return float(2.0 ** (o + self.first_octave))

    def octave_cap(self, o: int) -> int:
        h, w = self.octave_shape(o)
        return int(min(max(64, self.max_keypoints >> o), self.dog_levels * h * w))

    def level_sigmas(self) -> np.ndarray:
        s = np.arange(self.dog_levels + 3, dtype=np.float64)
        return (self.sigma0 * np.exp2(s / self.dog_levels)).astype(np.float64)

    def incremental_sigmas(self) -> np.ndarray:
        sig = self.level_sigmas()
        return np.sqrt(sig[1:] ** 2 - sig[:-1] ** 2)

    def initial_blur_sigma(self) -> float:
        """The blur that takes the input (its nominal blur doubled by an
        upsample) to sigma0."""
        sn = self.sigma_n * (2.0 if self.first_octave < 0 else 1.0)
        return math.sqrt(max(self.sigma0 * self.sigma0 - sn * sn, 1e-10))

    def gaussian_taps(self, sigma: float) -> np.ndarray:
        radius = max(1, int(math.ceil(self.kernel_truncate * sigma)))
        if self.max_filter_width > 0:
            radius = min(radius, self.max_filter_width)
        x = np.arange(-radius, radius + 1, dtype=np.float64)
        taps = np.exp(-(x * x) / (2.0 * sigma * sigma))
        taps /= taps.sum()
        return taps.astype(np.float32)

    @property
    def max_detect_sigma(self) -> float:
        return self.sigma0 * 2.0 ** ((self.dog_levels + 0.5) / self.dog_levels)

    @property
    def orient_window_radius(self) -> int:
        r = self.orientation_radius_factor * self.orientation_sigma_factor
        return int(math.ceil(r * self.max_detect_sigma))

    @property
    def descriptor_grid(self) -> int:
        return self.descriptor_width * self.descriptor_samples_per_cell


class Features(NamedTuple):
    x: torch.Tensor         # [B, K] f32, image coordinates
    y: torch.Tensor
    sigma: torch.Tensor
    theta: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor    # [B, K] int32
    desc: torch.Tensor      # [B, K, 128] uint8
    mask: torch.Tensor      # [B, K] bool


def _f32(x: float) -> float:
    return float(np.float32(x))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 explicit mantissa bits), nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    i = torch.where(i > 0x7FFFFFFF, i - (1 << 32), i)
    return i.to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class _Ops:
    """The contractions, in the precision asked for."""

    def __init__(self, precision: str):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision: 'f32' or 'tf32', got {precision!r}")
        self.round = tf32_round if precision == "tf32" else (lambda t: t)

    def conv2d(self, x, w):
        with _no_tf32():
            return F.conv2d(self.round(x), self.round(w))

    def matmul(self, a, b):
        with _no_tf32():
            return torch.matmul(self.round(a), self.round(b))


# ---------------- pyramid (frontend/pyramid.py, ops/pyramid_kernel.py) ----------------

def _blur_separable(x, taps, ops: _Ops):
    t = torch.from_numpy(np.asarray(taps, np.float32)).to(x.device)
    r = (t.shape[0] - 1) // 2
    out = []
    for xi in x:  # one image at a time, as the port does
        y = ops.conv2d(F.pad(xi[None, None], (r, r, 0, 0), mode="replicate"), t.view(1, 1, 1, -1))
        out.append(ops.conv2d(F.pad(y, (0, 0, r, r), mode="replicate"), t.view(1, 1, -1, 1))[:, 0])
    return torch.cat(out)


def _octave_levels(base, cfg: SiftParams, ops: _Ops):
    levels = [base]
    for s in cfg.incremental_sigmas():
        levels.append(_blur_separable(levels[-1], cfg.gaussian_taps(float(s)), ops))
    gauss = torch.stack(levels, dim=1)
    return gauss, gauss[:, 1:] - gauss[:, :-1]


def build_pyramid(images, cfg: SiftParams, ops: _Ops):
    x = images.to(torch.float32)
    if cfg.first_octave < 0:    # bilinear, half-pixel centres, edges clamped
        x = F.interpolate(x[:, None], scale_factor=2, mode="bilinear", align_corners=False)[:, 0]
    base = _blur_separable(x, cfg.gaussian_taps(cfg.initial_blur_sigma()), ops)
    octaves = []
    for _ in range(cfg.octaves):
        gauss, dog = _octave_levels(base, cfg, ops)
        octaves.append((gauss, dog))
        base = gauss[:, cfg.dog_levels][:, ::2, ::2].contiguous()
    return octaves


# ---------------- detect (frontend/detect.py, ops/detect_scores.py) ----------------

def _cramer_record(q):
    vc = q(0, 0, 0)
    d = q(0, 1, 0) + q(0, -1, 0) - 2 * vc
    f = q(0, 0, 1) + q(0, 0, -1) - 2 * vc
    e_ = 0.25 * (q(0, 1, 1) - q(0, 1, -1) - q(0, -1, 1) + q(0, -1, -1))
    gl = 0.5 * (q(1, 0, 0) - q(-1, 0, 0))
    gy = 0.5 * (q(0, 1, 0) - q(0, -1, 0))
    gx = 0.5 * (q(0, 0, 1) - q(0, 0, -1))
    a = q(1, 0, 0) + q(-1, 0, 0) - 2 * vc
    b_ = 0.25 * (q(1, 1, 0) - q(1, -1, 0) - q(-1, 1, 0) + q(-1, -1, 0))
    c_ = 0.25 * (q(1, 0, 1) - q(1, 0, -1) - q(-1, 0, 1) + q(-1, 0, -1))
    i00 = d * f - e_ * e_
    i01 = c_ * e_ - b_ * f
    i02 = b_ * e_ - c_ * d
    i11 = a * f - c_ * c_
    i12 = b_ * c_ - a * e_
    i22 = a * d - b_ * b_
    detH = a * i00 + b_ * i01 + c_ * i02
    ok_det = detH.abs() > _f32(1e-12)
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, detH, 1.0), torch.zeros_like(detH))
    off_l = -(i00 * gl + i01 * gy + i02 * gx) * inv_det
    off_y = -(i01 * gl + i11 * gy + i12 * gx) * inv_det
    off_x = -(i02 * gl + i12 * gy + i22 * gx) * inv_det
    val = vc + 0.5 * (gl * off_l + gy * off_y + gx * off_x)
    return val, off_l, off_y, off_x, (d, f, e_)


def _pack_corner(s, par):
    u = s.view(torch.int32)
    u = torch.where(s > 0, (u & ~3) | par, torch.zeros_like(u))
    return u.view(torch.float32)


def _dense_scores(dog, cfg: SiftParams):
    if not cfg.subpixel:
        raise ValueError("the reference covers subpixel refinement only")
    B, L, H, W = dog.shape
    S = L - 2
    v = dog[:, 1:S + 1]
    ninf = F.pad(dog, (1, 1, 1, 1), value=float("-inf"))
    pinf = F.pad(dog, (1, 1, 1, 1), value=float("inf"))
    nmax = nmin = None
    for dl in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if (dl, dy, dx) == (1, 1, 1):
                    continue
                a = ninf[:, dl:dl + S, dy:dy + H, dx:dx + W]
                b = pinf[:, dl:dl + S, dy:dy + H, dx:dx + W]
                nmax = a if nmax is None else torch.maximum(nmax, a)
                nmin = b if nmin is None else torch.minimum(nmin, b)
    r = cfg.edge_threshold
    thr08, edge_c = _f32(0.8 * cfg.dog_threshold), _f32((r + 1.0) ** 2 / r)
    pre = v.abs() > thr08
    is_max = (v > 0) & (v > nmax) & pre
    is_min = (v < 0) & (v < nmin) & pre
    dgp = F.pad(dog, (1, 1, 1, 1))

    def q(dl, dy, dx):
        return dgp[:, 1 + dl:1 + dl + S, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    val, off_l, off_y, off_x, (dyy, dxx, dxy) = _cramer_record(q)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr / torch.where(det > 0, det, 1.0) < edge_c)
    yy = torch.arange(H, device=dog.device, dtype=torch.int32)[:, None]
    xx = torch.arange(W, device=dog.device, dtype=torch.int32)[None, :]
    interior = (yy >= 1) & (yy <= H - 2) & (xx >= 1) & (xx <= W - 2)
    keep = edge_ok & interior
    par = (yy & 1) * 2 + (xx & 1)
    s_max = _pack_corner(v.abs() * (is_max & keep).to(torch.float32), par)
    s_min = _pack_corner(v.abs() * (is_min & keep).to(torch.float32), par)
    He, We = H + (H % 2), W + (W % 2)
    pad = (0, We - W, 0, He - H)
    planes = [F.pad(p, pad) for p in (s_max, s_min, val, off_l, off_y, off_x)]
    pooled = [p.view(B, S, He // 2, 2, We).amax(dim=3) for p in planes[:2]]
    return tuple(pooled) + tuple(planes[2:])


class _Keypoints(NamedTuple):
    y: torch.Tensor
    x: torch.Tensor
    grad_level: torch.Tensor
    sigma: torch.Tensor
    response: torch.Tensor
    mask: torch.Tensor


def _detect_octave(dog, cfg: SiftParams, cap: int) -> _Keypoints:
    B, L, H, W = dog.shape
    S = L - 2
    s_max, s_min, r_val, r_ol, r_oy, r_ox = _dense_scores(dog, cfg)
    Hs2, Ws = s_max.shape[-2:]
    Hs = r_val.shape[-2]
    nb1 = S * Hs2 * (Ws // 2)

    def pooled(score):
        return score.view(B, S, Hs2, Ws // 2, 2).amax(dim=4).reshape(B, nb1)

    bscore = torch.cat([pooled(s_max), pooled(s_min)], dim=1)
    k = min(cap, bscore.shape[1])
    top, bidx = torch.sort(bscore, dim=1, descending=True, stable=True)
    top, bidx = top[:, :k], bidx[:, :k].to(torch.int32)
    if k < cap:
        top = F.pad(top, (0, cap - k))
        bidx = F.pad(bidx, (0, cap - k))
    cand = top > 0.0
    bidx1 = bidx % nb1
    lvl = bidx1 // (Hs2 * (Ws // 2)) + 1
    rem = bidx1 % (Hs2 * (Ws // 2))
    corner = top.view(torch.int32) & 3
    py = (rem // (Ws // 2)) * 2 + (corner >> 1)
    px = (rem % (Ws // 2)) * 2 + (corner & 1)
    cell = ((lvl - 1).clamp(0, S - 1) * (Hs * Ws) + py * Ws + px).to(torch.int64)
    recs = [t.reshape(B, -1) for t in (r_val, r_ol, r_oy, r_ox)]
    val, off_l, off_y, off_x = (torch.gather(t, 1, cell) for t in recs)
    off_ok = (off_l.abs() <= 1.5) & (off_y.abs() <= 1.5) & (off_x.abs() <= 1.5)
    off_l = off_l.clamp(-0.5, 0.5)
    fy = py.to(torch.float32) + off_y
    fx = px.to(torch.float32) + off_x
    fl = lvl.to(torch.float32) + off_l
    bd = float(cfg.border)
    border_ok = (fy >= bd) & (fy < H - bd) & (fx >= bd) & (fx < W - bd)
    contrast_ok = val.abs() >= cfg.dog_threshold
    mask = cand & off_ok & border_ok & contrast_ok
    return _Keypoints(y=fy, x=fx, grad_level=torch.round(fl).to(torch.int32).clamp(1, S),
                      sigma=cfg.sigma0 * torch.exp2(fl / S), response=val.abs(), mask=mask)


def _prefilter(kps, cfg: SiftParams):
    """frontend/extract.py::prefilter_candidates (response-rank selection)."""
    K = cfg.max_keypoints
    resp = torch.cat([torch.where(k.mask, k.response, float("-inf")) for k in kps], dim=1)
    if resp.shape[1] <= K:
        return kps
    thr = torch.sort(resp, dim=1, descending=True, stable=True).values[:, K - 1:K]
    outs = []
    for k in kps:
        m = k.mask & (k.response >= thr)
        order = torch.argsort((~m).to(torch.int32), dim=1, stable=True)
        take = lambda a: torch.gather(a, 1, order)
        outs.append(_Keypoints(y=take(k.y), x=take(k.x), grad_level=take(k.grad_level),
                               sigma=take(k.sigma), response=take(k.response), mask=take(m)))
    return outs


# ---------------- gradients, orientation + sampling ----------------
# (ops/grad_stencil.py, ops/kp_engine.py)

def _grad_stack(gauss, S: int, min_hw: int):
    g = gauss[:, 1:S + 1]
    B, _, H, W = g.shape
    gp = F.pad(g, (1, 1, 1, 1), mode="replicate")
    gx = 0.5 * (gp[:, :, 1:H + 1, 2:] - gp[:, :, 1:H + 1, :W])
    gy = 0.5 * (gp[:, :, 2:, 1:W + 1] - gp[:, :, :H, 1:W + 1])
    gx[:, :, :, 0] = g[:, :, :, 1] - g[:, :, :, 0]
    gx[:, :, :, -1] = g[:, :, :, -1] - g[:, :, :, -2]
    gy[:, :, 0, :] = g[:, :, 1, :] - g[:, :, 0, :]
    gy[:, :, -1, :] = g[:, :, -1, :] - g[:, :, -2, :]
    ph, pw = max(0, min_hw - H), max(0, min_hw - W)
    gx = F.pad(gx, (0, pw, 0, ph))
    gy = F.pad(gy, (0, pw, 0, ph))
    return gx.to(torch.bfloat16), gy.to(torch.bfloat16)


def _exp_window(x):
    x = torch.clamp(x, min=-4.75)
    acc = torch.full_like(x, EXPW[0])
    for c in EXPW[1:]:
        acc = acc * x + c
    return acc


def _orient_sample(gx, gy, plane, ky, kx, sigma, cfg: SiftParams, mask, global_h, w_true):
    R = cfg.orient_window_radius
    win, nb, nori, G = 2 * R + 1, cfg.orientation_bins, cfg.max_orientations, cfg.descriptor_grid
    P, Hp, Wp = gx.shape
    N = plane.shape[0]
    dev = gx.device
    plane = plane.to(torch.int64)
    sigma = torch.clamp(sigma.to(torch.float32), max=_f32(cfg.max_detect_sigma))
    iy = torch.round(ky).to(torch.int64)
    ix = torch.round(kx).to(torch.int64)
    sy = (iy - R).clamp(0, Hp - win)
    sx = (ix - R).clamp(0, Wp - win)
    ar = torch.arange(win, device=dev)
    rows = sy[:, None] + ar
    cols = sx[:, None] + ar
    flat = (plane[:, None, None] * Hp + rows[:, :, None]) * Wp + cols[:, None, :]
    wx = gx.reshape(-1)[flat].to(torch.float32)
    wy = gy.reshape(-1)[flat].to(torch.float32)
    oy = rows.to(torch.float32) - ky[:, None]
    ox = cols.to(torch.float32) - kx[:, None]
    r2 = oy[:, :, None] * oy[:, :, None] + ox[:, None, :] * ox[:, None, :]
    sw = cfg.orientation_sigma_factor * sigma
    radius = cfg.orientation_radius_factor * sw
    wgt = _exp_window(-r2 / (2.0 * (sw * sw))[:, None, None])
    wgt = torch.where(r2 <= (radius * radius)[:, None, None], wgt, 0.0)
    wgt = wgt * ((rows >= 0) & (rows < global_h)).to(torch.float32)[:, :, None]
    mag = torch.sqrt(wx * wx + wy * wy)
    ang = torch.atan2(wy, wx)
    ang = torch.where(ang < 0, ang + TWO_PI, ang)
    bins = (ang * (nb / TWO_PI)).to(torch.int64).clamp(0, nb - 1)
    hist = torch.zeros((N, nb), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, bins.reshape(N, -1), (wgt * mag).reshape(N, -1))
    for _ in range(6):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    mx = hist.amax(dim=-1, keepdim=True)
    is_peak = (hist > left) & (hist > right) & (hist >= cfg.orientation_peak_ratio * mx) & (mx > 0)
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

    half = (G - 1) / 2.0
    t = torch.tensor(np.arange(G) - half, dtype=torch.float32, device=dev)
    spc = cfg.descriptor_spacing * sigma / cfg.descriptor_samples_per_cell
    u = t[None, None, :] * spc[:, None, None]
    v = t[None, :, None] * spc[:, None, None]
    base = (plane * Hp * Wp)[:, None, None]
    gxf, gyf = gx.reshape(-1), gy.reshape(-1)
    sgx, sgy = [], []
    for o in range(nori):
        th = theta[:, o][:, None, None]
        ct, st = torch.cos(th), torch.sin(th)
        px = kx[:, None, None] + ct * u - st * v
        py = ky[:, None, None] + st * u + ct * v
        x0 = torch.floor(px).to(torch.int64).clamp(0, Wp - 1)
        y0 = torch.floor(py).to(torch.int64).clamp(0, Hp - 1)
        x1 = (x0 + 1).clamp(max=Wp - 1)
        y1 = (y0 + 1).clamp(max=Hp - 1)
        fx = (px - x0.to(torch.float32)).clamp(0.0, 1.0)
        fy = (py - y0.to(torch.float32)).clamp(0.0, 1.0)
        inb = (px >= 0.0) & (px <= w_true - 1) & (py >= 0.0) & (py <= global_h - 1)
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


# ---------------- binning (frontend/describe.py) ----------------

def _grid_constants(G: int, D: int, spc: int):
    half = (G - 1) / 2.0
    t = np.arange(G) - half
    cell = t / spc + (D - 1) / 2.0
    w = np.zeros((G, D), np.float32)
    c0 = np.floor(cell).astype(int)
    fc = (cell - c0).astype(np.float32)
    for i in range(G):
        if 0 <= c0[i] < D:
            w[i, c0[i]] += 1.0 - fc[i]
        if 0 <= c0[i] + 1 < D:
            w[i, c0[i] + 1] += fc[i]
    sig = D / 2.0
    r = (cell - (D - 1) / 2.0) ** 2
    gw = np.exp(-(r[:, None] + r[None, :]) / (2.0 * sig * sig)).astype(np.float32)
    return w, gw


def _bin_descriptors(sgx, sgy, theta, cfg: SiftParams, ops: _Ops, chunk: int = 2048):
    G, D, NB = cfg.descriptor_grid, cfg.descriptor_width, cfg.descriptor_bins
    B, K2, _ = sgx.shape
    dev = sgx.device
    wrc, gw = _grid_constants(G, D, cfg.descriptor_samples_per_cell)
    gwf = torch.from_numpy(gw.reshape(G * G)).to(dev)
    W2 = torch.from_numpy(np.einsum("ir,jc->ijrc", wrc, wrc).reshape(G * G, D * D)).to(dev)
    bins = torch.arange(NB, dtype=torch.float32, device=dev)[:, None]
    outs = []
    for i in range(0, K2, chunk):
        gx, gy, th = sgx[:, i:i + chunk], sgy[:, i:i + chunk], theta[:, i:i + chunk]
        C = gx.shape[1]
        mag = torch.sqrt(gx * gx + gy * gy) * gwf
        ang = torch.fmod(torch.atan2(gy, gx) - th[..., None], TWO_PI)
        ang = torch.where(ang < 0, ang + TWO_PI, ang)
        ob = ang * (NB / TWO_PI)
        ad = (ob[..., None, :] - bins).abs()
        w = torch.clamp(1.0 - torch.minimum(ad, NB - ad), min=0.0)
        desc = ops.matmul(mag[..., None, :] * w, W2)
        outs.append(desc.transpose(-1, -2).reshape(B, C, D * D * NB))
    desc = torch.cat(outs, dim=1)
    n = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
    desc = desc / torch.clamp(n, min=1e-12)
    desc = torch.clamp(desc, max=cfg.descriptor_clip)
    n = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
    desc = desc / torch.clamp(n, min=1e-12)
    return torch.clamp(torch.floor(512.0 * desc + 0.5), 0, 255).to(torch.uint8)


# ---------------- one octave's candidates and the top-K (frontend/extract.py) ----------------

def _octave_candidates(gauss, kp: _Keypoints, cfg: SiftParams, o: int, ops: _Ops):
    B, cap = kp.y.shape
    S, n = cfg.dog_levels, cfg.max_orientations
    H, W = gauss.shape[-2:]
    gx, gy = _grad_stack(gauss, S, 2 * cfg.orient_window_radius + 1)
    Hp, Wp = gx.shape[-2:]
    b_idx = torch.arange(B, dtype=torch.int32, device=gauss.device)[:, None]
    plane = (b_idx * S + (kp.grad_level - 1)).reshape(B * cap)
    theta, haspk, sgx, sgy = _orient_sample(
        gx.reshape(B * S, Hp, Wp), gy.reshape(B * S, Hp, Wp), plane,
        kp.y.reshape(-1), kp.x.reshape(-1), kp.sigma.reshape(-1), cfg,
        kp.mask.reshape(-1), H, W)
    valid = haspk.reshape(B, cap, n) & kp.mask[..., None]
    valid[..., 0] = kp.mask
    G2 = cfg.descriptor_grid ** 2
    theta = theta.reshape(B, cap * n)
    desc = _bin_descriptors(sgx.reshape(B, cap * n, G2), sgy.reshape(B, cap * n, G2), theta,
                            cfg, ops)

    def dup(a):
        return a[..., None].expand(*a.shape, n).reshape(B, cap * n)

    scale = cfg.octave_scale(o)
    return dict(x=dup(kp.x) * scale, y=dup(kp.y) * scale, sigma=dup(kp.sigma) * scale,
                theta=theta, response=dup(kp.response), mask=valid.reshape(B, cap * n),
                desc=desc, octave=torch.full((B, cap * n), o, dtype=torch.int32,
                                             device=gauss.device))


def _assemble(parts, cfg: SiftParams) -> Features:
    cat = lambda k: torch.cat([p[k] for p in parts], dim=1)
    x, y, s, th, r, m, oc, d = map(cat, ("x", "y", "sigma", "theta", "response", "mask",
                                         "octave", "desc"))
    K = cfg.max_keypoints
    if m.shape[1] < K:
        pad = K - m.shape[1]
        pf = lambda a: F.pad(a, (0, pad))
        x, y, s, th, r, oc, m = map(pf, (x, y, s, th, r, oc, m))
        d = F.pad(d, (0, 0, 0, pad))
    resp = r
    if cfg.truncate_method == 1:        # fine octaves first
        resp = r - oc.to(r.dtype) * 4.0
    elif cfg.truncate_method == 2:      # coarse octaves first
        resp = r + oc.to(r.dtype) * 4.0
    score = torch.where(m, resp, float("-inf"))
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :K]
    take = lambda a: torch.gather(a, 1, idx)
    return Features(x=take(x), y=take(y), sigma=take(s), theta=take(th), response=take(r),
                    octave=take(oc), mask=take(m),
                    desc=torch.gather(d, 1, idx[..., None].expand(-1, -1, d.shape[-1])))


@torch.no_grad()
def extract(images: torch.Tensor, cfg: SiftParams, precision: str = "f32") -> Features:
    """images [B, H, W] f32 in [0, 1] -> Features, K = cfg.max_keypoints,
    ordered by response (descending), padded entries masked."""
    ops = _Ops(precision)
    pyr = build_pyramid(images, cfg, ops)
    kps = [_detect_octave(dog, cfg, cfg.octave_cap(o)) for o, (_, dog) in enumerate(pyr)]
    if cfg.truncate_method == 0:        # the prefilter keeps the response ranks alone
        kps = _prefilter(kps, cfg)
    parts = [_octave_candidates(gauss, kp, cfg, o, ops)
             for o, ((gauss, _), kp) in enumerate(zip(pyr, kps))]
    return _assemble(parts, cfg)
