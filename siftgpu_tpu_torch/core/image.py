"""Host-side image IO (`GLTexInput::LoadImageFile`).

Port of `siftgpu_tpu/core/image.py`: PGM/PPM/BMP decode through the C++
loader of `native/` (`core/native.py`) where a compiler is on PATH, the
NumPy codecs (PGM/PPM) and PIL (other formats) where none is; NPY;
grayscale conversion and the `-maxd` pre-downsample.
"""

from __future__ import annotations

import os

import numpy as np

from . import native

__all__ = [
    "to_grayscale", "load_image", "load_pnm", "save_pgm", "save_ppm",
    "downsample_to_fit",
]

# SiftGPU's RGB -> luminance weights
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def to_grayscale(arr: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, 3/4] (uint8 or float) -> [H, W] float32 in [0, 1]."""
    a = np.asarray(arr)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    elif a.dtype == np.uint16:
        a = a.astype(np.float32) / 65535.0
    else:
        a = a.astype(np.float32)
    if a.ndim == 3:
        a = a[..., :3] @ _LUMA
    return np.ascontiguousarray(a)


def load_pnm(path: str) -> np.ndarray:
    """Minimal PGM (P2/P5) / PPM (P3/P6) reader."""
    with open(path, "rb") as f:
        data = f.read()

    def tokens():
        i = 0
        while i < len(data):
            if data[i : i + 1] == b"#":
                while i < len(data) and data[i : i + 1] != b"\n":
                    i += 1
            elif data[i : i + 1].isspace():
                i += 1
            else:
                j = i
                while j < len(data) and not data[j : j + 1].isspace():
                    j += 1
                yield data[i:j], j
                i = j

    t = tokens()
    magic, _ = next(t)
    (w, _), (h, pos) = next(t), next(t)
    w, h = int(w), int(h)
    maxval, pos = next(t)
    maxval = int(maxval)
    pos += 1  # single whitespace after maxval
    channels = 3 if magic in (b"P3", b"P6") else 1
    dtype = np.uint16 if maxval > 255 else np.uint8
    if magic in (b"P5", b"P6"):
        arr = np.frombuffer(data, dtype=">u2" if maxval > 255 else np.uint8,
                            count=h * w * channels, offset=pos)
    else:
        vals = []
        for tok, _ in t:
            vals.append(int(tok))
            if len(vals) == h * w * channels:
                break
        arr = np.asarray(vals, dtype)
    return arr.astype(dtype).reshape((h, w, channels) if channels == 3 else (h, w))


def _to_u8(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return a


def save_pgm(path: str, img: np.ndarray) -> None:
    """float [0,1] or uint8 grayscale -> binary PGM."""
    a = _to_u8(img)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(a.tobytes())


def save_ppm(path: str, img: np.ndarray) -> None:
    """uint8 [H, W, 3] (or float [0,1]) RGB -> binary PPM."""
    a = _to_u8(img)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"save_ppm expects [H, W, 3], got {a.shape}")
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(a.tobytes())


def load_image(path) -> np.ndarray:
    """File path -> grayscale float32 [0, 1].  PNM and BMP files go through
    the native loader where `native.available()`, else through NumPy / PIL."""
    if isinstance(path, bytes):
        path = path.decode()
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm", ".bmp") and native.available():
        return native.load_image(path)
    if ext in (".pgm", ".ppm", ".pnm"):
        return to_grayscale(load_pnm(path))
    if ext == ".npy":
        return to_grayscale(np.load(path))
    try:
        from PIL import Image  # optional dependency
    except ImportError as e:
        raise RuntimeError(f"cannot decode {ext!r} without PIL; use PGM/PPM/NPY") from e
    with Image.open(path) as im:
        return to_grayscale(np.asarray(im))


def downsample_to_fit(arr: np.ndarray, max_dim: int) -> np.ndarray:
    """2x2 box-filter halving until max(H, W) <= max_dim (SiftGPU's
    `_texMaxDim` pre-downsample).  Odd trailing rows/cols are dropped."""
    a = np.asarray(arr, np.float32)
    while max(a.shape[:2]) > max_dim:
        h2, w2 = a.shape[0] // 2 * 2, a.shape[1] // 2 * 2
        a = a[:h2, :w2]
        a = 0.25 * (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2])
    return a
