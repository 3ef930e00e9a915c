"""Synthetic image fixtures: a NumPy copy of `siftgpu_tpu/oracle/fixtures.py`.

Only the JAX-free fixtures are copied (`two_plane_*` need the JAX geometry
module and wait for the port of `geometry/`).  The copies are verbatim, so a
seed gives the same image in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gaussian_blob_image", "checkerboard", "random_texture", "warp_affine",
    "warp_homography",
]


def gaussian_blob_image(h, w, blobs, background=0.0):
    """blobs: list of (y, x, sigma, amplitude). A blob of scale `sigma_b`
    produces a DoG extremum at sigma ~= sigma_b (detected scale).
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.full((h, w), background, np.float64)
    for (y, x, s, a) in blobs:
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def checkerboard(h, w, cell=8, lo=0.2, hi=0.8):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.where(((yy // cell) + (xx // cell)) % 2 == 0, lo, hi).astype(np.float32)


def random_texture(h, w, seed=0, smooth=2):
    """Smoothed random texture: dense in features, deterministic."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)).astype(np.float32)
    k = np.ones(2 * smooth + 1, np.float32)
    k /= k.sum()
    pad = np.pad(img, smooth, mode="edge")
    out = np.zeros_like(img)
    for i, t in enumerate(k):
        out += t * pad[smooth:-smooth or None, i : i + w]
    img2 = out
    out = np.zeros_like(img2)
    pad = np.pad(img2, smooth, mode="edge")
    for i, t in enumerate(k):
        out += t * pad[i : i + h, smooth:-smooth or None]
    return out


def warp_homography(img, H, out_shape=None):
    """Inverse-warp `img` by the 3x3 homography H (x' ~ H x), bilinear.
    Returns (warped, valid_mask)."""
    h, w = out_shape or img.shape
    Hh, Ww = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    Hinv = np.linalg.inv(H)
    sx = Hinv[0, 0] * xx + Hinv[0, 1] * yy + Hinv[0, 2]
    sy = Hinv[1, 0] * xx + Hinv[1, 1] * yy + Hinv[1, 2]
    sz = Hinv[2, 0] * xx + Hinv[2, 1] * yy + Hinv[2, 2]
    sz = np.where(np.abs(sz) < 1e-12, 1e-12, sz)
    sx, sy = sx / sz, sy / sz
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    valid = (x0 >= 0) & (y0 >= 0) & (x0 < Ww - 1) & (y0 < Hh - 1)
    x0c = np.clip(x0, 0, Ww - 2)
    y0c = np.clip(y0, 0, Hh - 2)
    out = (
        img[y0c, x0c] * (1 - fy) * (1 - fx)
        + img[y0c, x0c + 1] * (1 - fy) * fx
        + img[y0c + 1, x0c] * fy * (1 - fx)
        + img[y0c + 1, x0c + 1] * fy * fx
    )
    return np.where(valid, out, 0.0).astype(np.float32), valid


def warp_affine(img, A, t, out_shape=None):
    """Inverse-warp `img` by x' = A x + t (bilinear). Returns the warped image."""
    h, w = out_shape or img.shape
    H, W = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    Ainv = np.linalg.inv(A)
    sx = Ainv[0, 0] * (xx - t[0]) + Ainv[0, 1] * (yy - t[1])
    sy = Ainv[1, 0] * (xx - t[0]) + Ainv[1, 1] * (yy - t[1])
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx = sx - x0
    fy = sy - y0
    valid = (x0 >= 0) & (y0 >= 0) & (x0 < W - 1) & (y0 < H - 1)
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    out = (
        img[y0c, x0c] * (1 - fy) * (1 - fx)
        + img[y0c, x0c + 1] * (1 - fy) * fx
        + img[y0c + 1, x0c] * fy * (1 - fx)
        + img[y0c + 1, x0c + 1] * fy * fx
    )
    return np.where(valid, out, 0.0).astype(np.float32)
