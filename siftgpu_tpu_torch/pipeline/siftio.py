"""Feature files (`SiftPyramid::SaveSIFT`): Lowe ASCII and binary `.sift`,
NPZ feature stores and TUM trajectories.

Port of `siftgpu_tpu/pipeline/siftio.py`; for the same keys and descriptors
the `.sift` files are byte-identical, the feature store has the same keys,
dtypes and shapes, and the TUM file the same layout.  Tensors on a card are
moved to the host explicitly.

Lowe ASCII: line 1 "<N> 128", then per keypoint "y x sigma theta" and the
128 uint8 values wrapped at 20 per line.

Binary (VisualSFM SIFT v4 layout): 5 x int32 header [magic 'SIFT', version
'V4.0', npoint, 5, 128], npoint x 5 float32 (x, y, color, scale,
orientation), npoint x 128 uint8 descriptors, int32 EOF marker 'EOF\\0'.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..geometry import pose as P

__all__ = [
    "write_lowe_ascii", "read_lowe_ascii", "write_binary_sift", "read_binary_sift",
    "save_feature_store", "load_feature_store", "save_trajectory_tum",
]

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


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_feature_store(path: str, feats, frame_ids=None) -> None:
    """Batched `Features` -> compressed NPZ with the reference's keys (x, y,
    sigma, theta, response, octave, desc, mask [B, K(, 128)], frame_ids)."""
    np.savez_compressed(
        path, **{f: _host(getattr(feats, f)) for f in
                 ("x", "y", "sigma", "theta", "response", "octave", "desc", "mask")},
        frame_ids=np.asarray(frame_ids if frame_ids is not None else []),
    )


def load_feature_store(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------- trajectory export (SLAM back end) ----------------

def _quat_from_rotation(R: np.ndarray) -> np.ndarray:
    """[4] (qx, qy, qz, qw) from a 3x3 rotation matrix (Shepperd's method)."""
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif m11 >= m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float64)
    return q / np.linalg.norm(q)


def save_trajectory_tum(path: str, trajectory, timestamps=None) -> None:
    """Write a [T, 6] world->cam twist trajectory in TUM RGB-D format:
    `timestamp tx ty tz qx qy qz qw` per line, the pose of the camera in the
    world frame (center -R^T t, orientation R^T), which the standard ATE/RPE
    tools read.  The twists go through `geometry.pose.exp_se3` in f32 on the
    CPU, as the reference computes them."""
    xi = torch.from_numpy(np.ascontiguousarray(_host(trajectory), np.float32))
    R, t = (a.numpy() for a in P.exp_se3(xi))
    T = len(xi)
    ts = np.arange(T, dtype=np.float64) if timestamps is None else timestamps
    with open(path, "w") as f:
        for k in range(T):
            Rwc = R[k].T
            C = -Rwc @ t[k]
            q = _quat_from_rotation(Rwc)
            f.write(
                f"{ts[k]:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )
