"""Keypoint and match overlays (the TestWinGlut viewer of SiftGPU).

Port of `siftgpu_tpu/pipeline/viz.py`, pure NumPy: keypoints as circles of
radius 3 sigma with an orientation tick, matches as lines across the two
images side by side, rendered into RGB uint8 arrays for `core.image.save_ppm`.
For the same inputs the canvases are the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["draw_keypoints", "draw_matches", "KP_COLOR", "LINE_COLOR"]

KP_COLOR = (60, 220, 60)       # keypoint circles: green
TICK_COLOR = (250, 240, 60)    # orientation ticks: yellow
LINE_COLOR = (230, 80, 60)     # match lines: red


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """float [H, W] (0..1) or uint8 -> uint8 [H, W, 3]."""
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img.copy()


def _put(canvas: np.ndarray, ys, xs, color) -> None:
    H, W = canvas.shape[:2]
    ys = np.round(ys).astype(int)
    xs = np.round(xs).astype(int)
    ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    canvas[ys[ok], xs[ok]] = color


def _line(canvas: np.ndarray, y0, x0, y1, x1, color) -> None:
    n = int(max(abs(y1 - y0), abs(x1 - x0), 1)) + 1
    t = np.linspace(0.0, 1.0, n)
    _put(canvas, y0 + (y1 - y0) * t, x0 + (x1 - x0) * t, color)


def draw_keypoints(
    img: np.ndarray, x, y, sigma, theta=None, scale_factor: float = 3.0,
    color=KP_COLOR,
) -> np.ndarray:
    """Render keypoints as circles of radius `scale_factor * sigma` with an
    orientation tick.  Returns an RGB uint8 canvas."""
    canvas = _to_rgb(np.asarray(img))
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    sigma = np.asarray(sigma, np.float64)
    r = np.maximum(scale_factor * np.abs(sigma), 1.0)  # -sign kp: |sigma|
    ang = np.linspace(0.0, 2.0 * np.pi, 40)
    for i in range(len(x)):
        _put(canvas, y[i] + r[i] * np.sin(ang), x[i] + r[i] * np.cos(ang), color)
        if theta is not None:
            _line(canvas, y[i], x[i],
                  y[i] + r[i] * np.sin(theta[i]), x[i] + r[i] * np.cos(theta[i]),
                  TICK_COLOR)
    return canvas


def draw_matches(
    img0: np.ndarray, img1: np.ndarray, kp0, kp1, pairs,
    max_lines: int = 0,
) -> np.ndarray:
    """Side-by-side match view: both images on one canvas, a line per match.
    `kp0`/`kp1`: (x, y) arrays or [K, >=2] keypoint matrices; `pairs`: [M, 2]
    index pairs.  `max_lines` 0 = draw all."""
    a = _to_rgb(np.asarray(img0))
    b = _to_rgb(np.asarray(img1))
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]

    def xy(kp, idx):
        if isinstance(kp, (tuple, list)) and len(kp) == 2:
            xs, ys = kp                  # (x, y) array pair
            return np.asarray(xs)[idx], np.asarray(ys)[idx]
        kp = np.asarray(kp)
        if kp.ndim == 2:
            return kp[idx, 0], kp[idx, 1]
        raise ValueError("kp must be (x, y) arrays or [K, >=2] (x, y, ...)")

    pairs = np.asarray(pairs)
    if max_lines and len(pairs) > max_lines:
        pairs = pairs[:max_lines]
    for i, j in pairs:
        x0, y0 = xy(kp0, int(i))
        x1, y1 = xy(kp1, int(j))
        _line(canvas, y0, x0, y1, x1 + off, LINE_COLOR)
        _put(canvas, np.array([y0]), np.array([x0]), KP_COLOR)
        _put(canvas, np.array([y1]), np.array([x1 + off]), KP_COLOR)
    return canvas
