"""Data-parallel extraction over the ranks of a process group.

Port of `siftgpu_tpu/parallel/dp.py`.  The reference shards the batch over
the mesh's `data` axis with `shard_map` (no collective); here each rank
extracts its contiguous block of the batch on its own device.  Extraction
is batch-independent, so the blocks gathered in rank order
(`gather_features`) equal one process's `extract_features` of the whole
batch bit for bit.
"""

from __future__ import annotations

import torch

from ..core.config import SiftConfig
from ..frontend.extract import Features, extract_features
from . import comm

__all__ = ["extract_features_dp", "gather_features"]


def extract_features_dp(images, cfg: SiftConfig, group=None, device="cuda") -> Features:
    """images: [B, H, W] (NumPy or a tensor, the same on every rank) with B
    a multiple of the world size.  Returns the Features of this rank's
    contiguous block of B / world frames, on `device`."""
    n, r = comm.world_size(group), comm.rank(group)
    B = len(images)
    if B % n:
        raise ValueError(f"batch of {B} frames does not split over {n} ranks")
    b = B // n
    blk = images[r * b:(r + 1) * b]
    blk = blk if torch.is_tensor(blk) else torch.from_numpy(blk)
    return extract_features(blk.to(device=device, dtype=torch.float32), cfg)


def gather_features(feats: Features, group=None) -> Features:
    """Every rank's block of Features concatenated in rank order, on every
    rank (one row-block all-gather per field)."""
    return Features(*(comm.all_gather_rows(a, group) for a in feats))
