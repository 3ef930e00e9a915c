"""Synthetic image fixtures: a NumPy copy of `siftgpu_tpu/oracle/fixtures.py`.

The copies are verbatim, so a seed gives the same image in both packages.
`orient_windows` and `orient_keypoints` are the port's own: gradient
planes and keypoints for the orientation kernel's edge cases.
`two_plane_stereo` and the `two_plane_sequence*` fixtures take their
rotations from the port's `exp_so3` in float32, and the sequences their
ground-truth twists from its `log_se3` in float32, as the reference's do
from JAX's with 64-bit floats off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.pose import exp_so3, log_se3

__all__ = [
    "gaussian_blob_image", "checkerboard", "random_texture", "warp_affine",
    "warp_homography", "two_plane_stereo", "two_plane_sequence", "two_plane_sequence_poses",
    "orient_windows", "orient_keypoints",
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


def two_plane_stereo(h, w, intr, rvec, t, d_near=5.0, d_far=10.0, seed=0):
    """Synthetic calibrated stereo pair of two fronto-parallel textured planes
    (top half at depth d_far, bottom half at d_near) — non-degenerate for E.

    intr: (fx, fy, cx, cy); rvec/t: pose of cam1 (x_c1 = R x_c0 + t).
    Returns (img0, img1, meta) where meta holds K, R, t and plane depths.
    R is float32, computed as the reference computes it (Rodrigues in f32):
    the warps then see the same rotation, to the last bit wherever the two
    frameworks' f32 `cos` agree."""
    fx, fy, cx, cy = intr
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    R = exp_so3(torch.from_numpy(np.asarray(rvec, np.float32))).numpy()
    n = np.array([0.0, 0.0, 1.0])

    def plane_H(d):
        return K @ (R + np.outer(t, n) / d) @ Kinv

    tex_far = random_texture(h, w, seed=seed, smooth=2)
    tex_near = random_texture(h, w, seed=seed + 1, smooth=2)
    yy = np.mgrid[0:h, 0:w][0]
    top = yy < h // 2
    img0 = np.where(top, tex_far, tex_near).astype(np.float32)

    w_far, v_far = warp_homography(np.where(top, tex_far, 0.0).astype(np.float32), plane_H(d_far))
    w_near, v_near = warp_homography(
        np.where(~top, tex_near, 0.0).astype(np.float32), plane_H(d_near)
    )
    # near plane occludes far where both project
    img1 = np.where(w_near > 0, w_near, w_far).astype(np.float32)
    meta = dict(K=K, R=R, t=np.asarray(t, np.float64), d_near=d_near, d_far=d_far)
    return img0, img1, meta


def two_plane_sequence(n_frames, h, w, intr, rvec_step, t_step,
                       d_near=5.0, d_far=10.0, seed=0):
    """Synthetic calibrated monocular sequence over the two-plane scene.

    Frame k is rendered from the canonical (frame-0) textures via per-plane
    homographies for the pose (k*rvec_step, k*t_step) — exact ground truth
    for the SLAM loop's ATE metric (SURVEY §4.4).
    Returns (frames [T, h, w], poses_gt [T, 6] world->cam twists).
    """
    rvs = np.outer(np.arange(n_frames), np.asarray(rvec_step, np.float64))
    tvs = np.outer(np.arange(n_frames), np.asarray(t_step, np.float64))
    return two_plane_sequence_poses(rvs, tvs, h, w, intr,
                                    d_near=d_near, d_far=d_far, seed=seed)


def two_plane_sequence_poses(rvecs, tvecs, h, w, intr,
                             d_near=5.0, d_far=10.0, seed=0):
    """`two_plane_sequence` with EXPLICIT per-frame poses (rvecs/tvecs
    [T, 3]) — e.g. a loop trajectory that returns to its start, the
    loop-closure test scene.  Returns (frames [T, h, w], poses_gt [T, 6])."""
    fx, fy, cx, cy = intr
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    n = np.array([0.0, 0.0, 1.0])
    tex_far = random_texture(h, w, seed=seed, smooth=2)
    tex_near = random_texture(h, w, seed=seed + 1, smooth=2)
    yy = np.mgrid[0:h, 0:w][0]
    top = yy < h // 2
    far0 = np.where(top, tex_far, 0.0).astype(np.float32)
    near0 = np.where(~top, tex_near, 0.0).astype(np.float32)

    frames, poses = [], []
    for rv, tv in zip(np.asarray(rvecs, np.float64), np.asarray(tvecs, np.float64)):
        R = exp_so3(torch.from_numpy(rv.astype(np.float32)))
        Rn = R.numpy()
        w_far, _ = warp_homography(far0, K @ (Rn + np.outer(tv, n) / d_far) @ Kinv)
        w_near, _ = warp_homography(near0, K @ (Rn + np.outer(tv, n) / d_near) @ Kinv)
        frames.append(np.where(w_near > 0, w_near, w_far).astype(np.float32))
        # world->cam twist for (R, tv): translation needs V^-1, hence log_se3
        poses.append(log_se3(R, torch.from_numpy(tv.astype(np.float32))).numpy())
    return np.stack(frames), np.stack(poses).astype(np.float32)


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


def _bf16(x) -> np.ndarray:
    """Round f32 values to the nearest bf16 (ties to even), kept as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


# the windows of `orient_windows`, as gradient vectors (gx, gy) at offsets
# (dy, dx) from the keypoint.  At sigma 2 (default config: window sigma 3,
# radius 9) the window weight of an offset with r^2 = 9 is exp_window(-0.5),
# a value every route computes alike (its products with -0.5 are exact, so
# a fused multiply-add rounds as the separate ones).  "ratio": the smoothed
# histogram's bin 18 is exactly f32(0.8) * its bin 0 (found by search over
# bf16 magnitudes); "below": one bf16 step less, so bin 18 is no peak.
ORIENT_WINDOWS = {
    "flat": [],
    "tie": [((0, 3), (0.5, 0.0)), ((0, -3), (-0.5, 0.0))],
    "ratio": [((0, 3), (0.625, 0.0)), ((0, -3), (-0.5, 0.0))],
    "below": [((0, 3), (0.625, 0.0)), ((0, -3), (-0.498046875, 0.0))],
}


def orient_windows(kinds=tuple(ORIENT_WINDOWS), size=48, sigma=2.0):
    """One [size, size] gradient plane per window of `ORIENT_WINDOWS`, zero
    but for the listed gradients, with a keypoint at its centre: the
    orientation histogram's exact cases (an empty histogram, two equal
    peaks, a second peak at exactly the peak ratio, one just below it).
    Returns dict(gx, gy [N, size, size] f32 (bf16 values), plane int32,
    y, x, sigma f32, mask bool [N], kinds)."""
    n = len(kinds)
    gx = np.zeros((n, size, size), np.float32)
    gy = np.zeros((n, size, size), np.float32)
    c = size // 2
    for i, kind in enumerate(kinds):
        for (dy, dx), (vx, vy) in ORIENT_WINDOWS[kind]:
            gx[i, c + dy, c + dx], gy[i, c + dy, c + dx] = vx, vy
    return dict(gx=gx, gy=gy, plane=np.arange(n, dtype=np.int32),
                y=np.full(n, c, np.float32), x=np.full(n, c, np.float32),
                sigma=np.full(n, sigma, np.float32), mask=np.ones(n, bool), kinds=tuple(kinds))


def orient_keypoints(n, planes=3, h=61, w=53, seed=0, masked=0.0, corners=False):
    """Random bf16 gradient planes [planes, h, w] and n keypoints on them at
    random subpixel positions and scales, a share `masked` of them masked;
    if `corners`, the first (up to) four sit live at the plane corners.
    Returns the dict of `orient_windows`."""
    rng = np.random.default_rng(seed)
    gx = _bf16(rng.normal(0, 0.1, (planes, h, w)))
    gy = _bf16(rng.normal(0, 0.1, (planes, h, w)))
    y = rng.uniform(0, h - 1, n).astype(np.float32)
    x = rng.uniform(0, w - 1, n).astype(np.float32)
    if corners:
        k = min(n, 4)
        y[:k] = np.array([0, 0, h - 1, h - 1], np.float32)[:k]
        x[:k] = np.array([0, w - 1, 0, w - 1], np.float32)[:k]
    mask = rng.random(n) >= masked
    if corners:
        mask[:k] = True
    return dict(gx=gx, gy=gy, plane=rng.integers(0, planes, n).astype(np.int32), y=y, x=x,
                sigma=rng.uniform(1.0, 3.0, n).astype(np.float32), mask=mask,
                kinds=("random",) * n)
