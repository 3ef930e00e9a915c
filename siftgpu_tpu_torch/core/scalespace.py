"""Scale-space math: a NumPy copy of `siftgpu_tpu/core/scalespace.py`.

Copied verbatim so the PyTorch port computes the same sigma schedules and
Gaussian filter taps as the JAX package and its NumPy oracle without
importing either (the port must run where JAX is not installed).

Reference parity notes (SURVEY.md §2.1 "SIFT parameters" row; canonical upstream
SiftGPU `src/SiftGPU/SiftPyramid.h::SiftParam` ⚠ — mount empty, see SURVEY §0):
  - Gaussian levels per octave: S + 3 (S = dog_levels, default 3).
  - sigma(level l) = sigma0 * 2^(l / S), sigma0 = 1.6.  SiftGPU indexes levels
    -1..S+1 with sigma0' = 1.6*2^(1/S); that is the same schedule shifted by one
    index.  We use Lowe indexing l = 0..S+2.
  - Input nominal sigma sigma_n = 0.5 (1.0 after 2x upsampling, first_octave=-1).
  - Incremental blurs: sqrt(sigma_l^2 - sigma_{l-1}^2).
  - Filter taps truncated at `truncate * sigma` (reference uses width factor 4),
    odd width, renormalized.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "level_sigmas",
    "incremental_sigmas",
    "initial_blur_sigma",
    "gaussian_taps",
    "max_detect_sigma",
]


def level_sigmas(dog_levels: int, sigma0: float = 1.6) -> np.ndarray:
    """Absolute sigma of each Gaussian level within an octave, l = 0..S+2."""
    s = np.arange(dog_levels + 3, dtype=np.float64)
    return (sigma0 * np.exp2(s / dog_levels)).astype(np.float64)


def incremental_sigmas(dog_levels: int, sigma0: float = 1.6) -> np.ndarray:
    """Blur to apply to level l-1 to reach level l, for l = 1..S+2."""
    sig = level_sigmas(dog_levels, sigma0)
    return np.sqrt(sig[1:] ** 2 - sig[:-1] ** 2)


def initial_blur_sigma(sigma0: float, sigma_n: float, upsampled: bool) -> float:
    """Blur applied to the (possibly 2x-upsampled) input to reach sigma0.

    After 2x upsampling the nominal input sigma doubles.
    """
    sn = sigma_n * (2.0 if upsampled else 1.0)
    d2 = sigma0 * sigma0 - sn * sn
    return math.sqrt(max(d2, 1e-10))


def gaussian_taps(sigma: float, truncate: float = 4.0, max_radius: int = 0) -> np.ndarray:
    """Normalized odd-width 1-D Gaussian taps, radius = ceil(truncate * sigma).

    `max_radius > 0` caps the radius (the `GlobalUtil::_MaxFilterWidth` analog ⚠).
    """
    radius = max(1, int(math.ceil(truncate * sigma)))
    if max_radius > 0:
        radius = min(radius, max_radius)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-(x * x) / (2.0 * sigma * sigma))
    taps /= taps.sum()
    return taps.astype(np.float32)


def max_detect_sigma(dog_levels: int, sigma0: float = 1.6) -> float:
    """Upper bound on the intra-octave sigma of a refined keypoint.

    Keypoints are detected on DoG slices l = 1..S and the subpixel refinement
    moves the level by at most +-0.5, so sigma <= sigma0 * 2^((S + 0.5) / S).
    Used to size the static orientation / descriptor sampling windows.
    """
    return sigma0 * 2.0 ** ((dog_levels + 0.5) / dog_levels)
