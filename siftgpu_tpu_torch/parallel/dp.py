"""Data-parallel extraction over the ranks of a process group.

Port of `siftgpu_tpu/parallel/dp.py`.  The reference shards the batch over
the mesh's `data` axis with `shard_map` (no collective); here each rank
extracts its contiguous block of the batch on its own device.  Extraction
is batch-independent, so the blocks gathered in rank order
(`gather_features`) equal one process's `extract_features` of the whole
batch bit for bit.  `extract_features_dp_jit` is the counterpart of the
reference's cached `_dp_fn`, and what config 5's sequence extraction
calls: the rank's block through the captured `extract_features_jit`.
Neither runs a collective; the gather lies outside them, as in the
reference.
"""

from __future__ import annotations

import torch

from ..core.config import SiftConfig
from ..frontend.extract import Features, extract_features, extract_features_jit
from . import comm

__all__ = ["extract_features_dp", "extract_features_dp_jit", "gather_features"]


def extract_features_dp(images, cfg: SiftConfig, group=None, device="cuda") -> Features:
    """images: [B, H, W] (NumPy or a tensor, the same on every rank) with B
    a multiple of the world size.  Returns the Features of this rank's
    contiguous block of B / world frames, on `device`."""
    return extract_features(_block(images, group, device), cfg)


def extract_features_dp_jit(images, cfg: SiftConfig, group=None, device="cuda") -> Features:
    """`extract_features_dp` through `extract_features_jit`: captured once
    per block shape on the card, the eager extraction on the CPU."""
    return extract_features_jit(_block(images, group, device), cfg)


def _block(images, group, device) -> torch.Tensor:
    """This rank's contiguous block of B / world frames, as f32 on `device`."""
    n, r = comm.world_size(group), comm.rank(group)
    B = len(images)
    if B % n:
        raise ValueError(f"batch of {B} frames does not split over {n} ranks")
    b = B // n
    blk = images[r * b:(r + 1) * b]
    blk = blk if torch.is_tensor(blk) else torch.from_numpy(blk)
    return blk.to(device=device, dtype=torch.float32)


def gather_features(feats: Features, group=None) -> Features:
    """Every rank's block of Features concatenated in rank order, on every
    rank (one row-block all-gather per field)."""
    return Features(*(comm.all_gather_rows(a, group) for a in feats))
