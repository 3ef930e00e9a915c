"""Feature files (`SiftPyramid::SaveSIFT`): Lowe ASCII and binary `.sift`.

Port of the writers and readers of `siftgpu_tpu/pipeline/siftio.py`; for the
same keys and descriptors the files are byte-identical.

Lowe ASCII: line 1 "<N> 128", then per keypoint "y x sigma theta" and the
128 uint8 values wrapped at 20 per line.

Binary (VisualSFM SIFT v4 layout): 5 x int32 header [magic 'SIFT', version
'V4.0', npoint, 5, 128], npoint x 5 float32 (x, y, color, scale,
orientation), npoint x 128 uint8 descriptors, int32 EOF marker 'EOF\\0'.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_lowe_ascii", "read_lowe_ascii", "write_binary_sift", "read_binary_sift"]

_MAGIC = struct.unpack("<i", b"SIFT")[0]
_V4 = struct.unpack("<i", b"V4.0")[0]
_EOF = struct.unpack("<i", b"\x46\x4f\x45\x00")[0]  # 'EOF\0' little-endian


def write_lowe_ascii(path: str, keys: np.ndarray, desc: np.ndarray) -> None:
    """keys: [N, 4] (x, y, sigma, theta); desc: [N, 128] uint8."""
    n = len(keys)
    with open(path, "w") as f:
        f.write(f"{n} {desc.shape[1] if n else 128}\n")
        for i in range(n):
            x, y, s, o = keys[i]
            f.write(f"{y:.6f} {x:.6f} {s:.6f} {o:.6f}\n")
            d = desc[i]
            for j in range(0, len(d), 20):
                f.write(" ".join(str(int(v)) for v in d[j : j + 20]) + "\n")


def read_lowe_ascii(path: str):
    with open(path) as f:
        toks = f.read().split()
    n, dim = int(toks[0]), int(toks[1])
    keys = np.zeros((n, 4), np.float32)
    desc = np.zeros((n, dim), np.uint8)
    p = 2
    for i in range(n):
        y, x, s, o = (float(t) for t in toks[p : p + 4])
        keys[i] = (x, y, s, o)
        p += 4
        desc[i] = [int(t) for t in toks[p : p + dim]]
        p += dim
    return keys, desc


def write_binary_sift(path: str, keys: np.ndarray, desc: np.ndarray) -> None:
    n = len(keys)
    loc = np.zeros((n, 5), np.float32)
    if n:
        loc[:, 0] = keys[:, 0]          # x
        loc[:, 1] = keys[:, 1]          # y
        loc[:, 3] = keys[:, 2]          # scale (column 2, packed color, stays 0)
        loc[:, 4] = keys[:, 3]          # orientation
    with open(path, "wb") as f:
        f.write(struct.pack("<5i", _MAGIC, _V4, n, 5, 128))
        f.write(loc.astype("<f4").tobytes())
        f.write(np.asarray(desc, np.uint8).tobytes())
        f.write(struct.pack("<i", _EOF))


def read_binary_sift(path: str):
    with open(path, "rb") as f:
        magic, _ver, n, ldim, ddim = struct.unpack("<5i", f.read(20))
        if magic != _MAGIC or ldim != 5:
            raise ValueError(f"{path}: not a binary sift file")
        loc = np.frombuffer(f.read(n * 5 * 4), "<f4").reshape(n, 5)
        desc = np.frombuffer(f.read(n * ddim), np.uint8).reshape(n, ddim)
    keys = np.stack([loc[:, 0], loc[:, 1], loc[:, 3], loc[:, 4]], axis=1)
    return keys.astype(np.float32), desc.copy()
