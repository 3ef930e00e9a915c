"""Float32 precision on the card.

A float32 convolution on the card defaults to TF32 in cuDNN, and a matmul
may too; TF32's ~1e-3 relative error is of the order of the DoG contrast
threshold (6.7e-3) and moves two-view geometry by tenths of a pixel.  The
reference runs these contractions at "highest" precision.  `full_f32()`
turns TF32 off for cuDNN convolutions and cuBLAS matmuls for the duration of
a call and restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32"]


@contextlib.contextmanager
def full_f32():
    """Run f32 convolutions and matmuls in full f32 (no TF32) inside."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
