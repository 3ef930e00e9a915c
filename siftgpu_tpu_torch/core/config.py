"""Frozen configuration of the PyTorch SIFT front end.

Field-for-field copy of `siftgpu_tpu/core/config.py` (same names, defaults
and derived helpers), so a config moves between the two packages with
`dataclasses.asdict` (see `siftgpu_tpu_torch.convert`).  All shapes derived
from it are static Python ints, as in the JAX package.

Fields that steer TPU-only mechanisms are carried for parity and IGNORED by
this package:
  detect_topk, topk_recall, topk_chunk_recall, topk_approx_min
      approximate top-k on the TPU; the port always runs exact top-k
  pyramid_precision
      bf16-pass emulation of f32 matmuls in the TPU's banded-matmul blur; the
      port blurs with plain f32 convolutions (TF32 off) on every device
  use_pallas
      the port picks its route from the input tensor's device: CUDA tensors
      go through the Hopper kernels, CPU tensors through the plain versions
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from . import scalespace

__all__ = ["SiftConfig", "MatchConfig"]


def _num_octaves(h: int, w: int, min_dim: int) -> int:
    n = 0
    while min(h, w) >= min_dim:
        n += 1
        h //= 2
        w //= 2
    return max(n, 1)


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """Static SIFT extraction parameters (flag parity as in the JAX package:
    dog_levels -d, dog_threshold -t, edge_threshold -e, first_octave -fo,
    max_keypoints -tc, max_orientations -m, subpixel -s, lowe_origin -loweo,
    unnormalized -unn, keep_sign -sign)."""

    # --- image geometry ---
    height: int = 480
    width: int = 640
    batch: int = 1

    # --- scale space ---
    dog_levels: int = 3            # S
    sigma0: float = 1.6
    sigma_n: float = 0.5
    first_octave: int = 0          # -1 => upsample input 2x
    num_octaves: int = 0           # 0 => auto from image size
    min_octave_dim: int = 16
    kernel_truncate: float = 4.0   # filter radius = ceil(truncate * sigma)
    max_filter_width: int = 0      # 0 => uncapped (radius cap, pixels)

    # --- detection ---
    dog_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    subpixel: bool = True
    keep_sign: bool = False        # -sign: signed response; minima get -sigma
    border: int = 5                # reject keypoints within `border` px of edge

    # --- keypoint capacities (static buffer sizes) ---
    max_keypoints: int = 2048      # final per-image cap K
    # -tc truncation preference when the cap binds: 0 keep the highest
    # responses, 1 prefer fine octaves, 2 prefer coarse octaves
    truncate_method: int = 0
    per_octave_cap: int = 0        # 0 => auto: max(64, max_keypoints >> octave)
    # TPU-only (ignored): approximate top-k policy of the JAX package
    detect_topk: str = "auto"
    topk_recall: float = 0.97
    topk_chunk_recall: float = 0.90
    topk_approx_min: int = 1 << 16

    # --- orientation ---
    max_orientations: int = 2
    orientation_bins: int = 36
    orientation_sigma_factor: float = 1.5   # sigma_w = 1.5 * sigma
    orientation_radius_factor: float = 3.0  # radius = 3 * sigma_w
    orientation_peak_ratio: float = 0.8

    # --- descriptor ---
    descriptor_width: int = 4      # 4x4 spatial cells
    descriptor_bins: int = 8       # orientation bins per cell
    descriptor_spacing: float = 3.0  # cell size = 3 * sigma (octave pixels)
    descriptor_samples_per_cell: int = 4  # 16x16 sample grid
    descriptor_clip: float = 0.2
    unnormalized: bool = False

    # --- conventions / numerics ---
    lowe_origin: bool = False
    pyramid_dtype: str = "float32"
    pyramid_precision: str = "high"  # TPU-only (ignored)
    use_pallas: bool = True          # ignored: the route follows the device
    process_obo: bool = False        # -obo: SiftTPU extracts octave by octave

    # ---------------- derived static geometry ----------------

    @property
    def gauss_levels(self) -> int:
        return self.dog_levels + 3

    @property
    def upsampled(self) -> bool:
        return self.first_octave < 0

    @property
    def base_shape(self) -> Tuple[int, int]:
        """Shape of octave 0 (2x for first_octave == -1; first_octave n > 0
        decimates the input n times, each halving a dimension as ceil(n/2))."""
        if self.upsampled:
            return (self.height * 2, self.width * 2)
        h, w = self.height, self.width
        for _ in range(self.first_octave):
            h, w = max((h + 1) // 2, 1), max((w + 1) // 2, 1)
        return (h, w)

    @property
    def octaves(self) -> int:
        if self.num_octaves > 0:
            return self.num_octaves
        h, w = self.base_shape
        return _num_octaves(h, w, self.min_octave_dim)

    def octave_shape(self, o: int) -> Tuple[int, int]:
        h, w = self.base_shape
        return (max(h >> o, 1), max(w >> o, 1))

    def octave_scale(self, o: int) -> float:
        """Multiply octave-local coordinates by this to get input-image coords."""
        return float(2 ** (o + self.first_octave))

    def octave_cap(self, o: int) -> int:
        """Static keypoint capacity for octave `o` (pre-orientation-split)."""
        if self.per_octave_cap > 0:
            cap = self.per_octave_cap
        else:
            cap = max(64, self.max_keypoints >> o)
        h, w = self.octave_shape(o)
        return int(min(cap, self.dog_levels * h * w))

    @property
    def total_candidate_cap(self) -> int:
        return sum(self.octave_cap(o) for o in range(self.octaves)) * self.max_orientations

    @property
    def max_detect_sigma(self) -> float:
        return scalespace.max_detect_sigma(self.dog_levels, self.sigma0)

    @property
    def orient_window_radius(self) -> int:
        """Static radius of the orientation window (covers max sigma)."""
        r = self.orientation_radius_factor * self.orientation_sigma_factor
        return int(math.ceil(r * self.max_detect_sigma))

    @property
    def descriptor_grid(self) -> int:
        """Samples per side of the rotated descriptor sampling grid (e.g. 16)."""
        return self.descriptor_width * self.descriptor_samples_per_cell

    @property
    def descriptor_dim(self) -> int:
        return self.descriptor_width * self.descriptor_width * self.descriptor_bins

    # ---------------- schedules (NumPy) ----------------

    def level_sigmas(self):
        return scalespace.level_sigmas(self.dog_levels, self.sigma0)

    def incremental_sigmas(self):
        return scalespace.incremental_sigmas(self.dog_levels, self.sigma0)

    def initial_blur_sigma(self) -> float:
        return scalespace.initial_blur_sigma(self.sigma0, self.sigma_n, self.upsampled)

    def gaussian_taps(self, sigma: float):
        return scalespace.gaussian_taps(sigma, self.kernel_truncate, self.max_filter_width)

    # ---------------- construction helpers ----------------

    @classmethod
    def for_image(cls, height: int, width: int, **kw) -> "SiftConfig":
        return cls(height=height, width=width, **kw)

    def replace(self, **kw) -> "SiftConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Static matcher parameters (`GetSiftMatch(max_match, distmax=0.7,
    ratiomax=0.8, mutual_best=1)` parity; angular distances in radians).

    The streaming knobs act as in the reference (`frontend/match.py::
    _effective_block`) on every set but uint8 on the card, which takes the
    fused best-2 kernel (`ops/match_kernel.py`) at every size:
    `block_size` > 0 streams d1 in blocks of that many columns when N1
    exceeds it, 0 streams `stream_block` columns when N1 exceeds
    `stream_threshold`, < 0 is always dense.  `use_pallas` is carried for
    parity: the route follows the device."""

    max_sift: int = 4096           # SetMaxSift analog: descriptor capacity
    max_match: int = 4096          # output match-buffer capacity
    dist_max: float = 0.7          # max angular distance (radians)
    ratio_max: float = 0.8         # best/second-best angle ratio
    mutual_best: bool = True
    block_size: int = 0
    stream_threshold: int = 4096
    stream_block: int = 1024
    use_pallas: bool = True

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)
