"""128-D SIFT descriptor binning from pre-sampled gradients.

Port of the fused-path binning of `siftgpu_tpu/frontend/describe.py`:
`bin_descriptors` on the `_bin_chunk_fast` body in f32 (what the reference's
CPU route runs) — circular-tent orientation weights and one [G², D²]
contraction against the constant `W2` — then `finalize_descriptors`
(normalize -> clip 0.2 -> renormalize -> uint8).  The TPU's bf16 binning
has no counterpart: the port bins in f32 on every device.

Wrap edge: ob == NB (rounding of an angle ~2π) puts its weight on bin 0,
as the oracle's `floor(ob) % NB` does.

This is plain PyTorch on both devices (the reference's binning is XLA, not
Pallas); the contraction is a `torch.matmul` in full f32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.config import SiftConfig
from .pyramid import full_f32

__all__ = ["bin_descriptors", "finalize_descriptors"]

_TWO_PI = 6.283185307179586


@lru_cache(maxsize=None)
def _grid_constants(G: int, D: int, spc: int):
    """Constant sample-grid tensors: (t [G], wr/wc [G, D], gw [G, G])."""
    half = (G - 1) / 2.0
    t = np.arange(G) - half
    cell = t / spc + (D - 1) / 2.0
    w = np.zeros((G, D), np.float32)
    c0 = np.floor(cell).astype(int)
    fc = (cell - c0).astype(np.float32)
    for i in range(G):
        if 0 <= c0[i] < D:
            w[i, c0[i]] += 1.0 - fc[i]
        if 0 <= c0[i] + 1 < D:
            w[i, c0[i] + 1] += fc[i]
    sig = D / 2.0
    r = (cell - (D - 1) / 2.0) ** 2
    gw = np.exp(-(r[:, None] + r[None, :]) / (2.0 * sig * sig)).astype(np.float32)
    return t.astype(np.float32), w, gw


@lru_cache(maxsize=None)
def _w2_constant(G: int, D: int, spc: int) -> np.ndarray:
    """[G², D²] fused row x col spatial-tent matrix."""
    _, wrc, _ = _grid_constants(G, D, spc)
    return np.einsum("ir,jc->ijrc", wrc, wrc).reshape(G * G, D * D)


def _bin_chunk_fast(sgx, sgy, theta, cfg: SiftConfig):
    """Raw descriptors [B, C, 128] from samples [B, C, G²] and theta [B, C]."""
    B, C, G2 = sgx.shape
    NB, D, G = cfg.descriptor_bins, cfg.descriptor_width, cfg.descriptor_grid
    spc = cfg.descriptor_samples_per_cell
    dev = sgx.device
    _, _, gw = _grid_constants(G, D, spc)
    gwf = torch.from_numpy(gw.reshape(G2)).to(dev)
    mag = torch.sqrt(sgx * sgx + sgy * sgy) * gwf
    ang = torch.fmod(torch.atan2(sgy, sgx) - theta[..., None], _TWO_PI)
    ang = torch.where(ang < 0, ang + _TWO_PI, ang)           # floor-mod 2π
    ob = ang * (NB / _TWO_PI)
    bins = torch.arange(NB, dtype=torch.float32, device=dev)[:, None]
    ad = (ob[..., None, :] - bins).abs()                       # [B, C, NB, G2]
    w = torch.clamp(1.0 - torch.minimum(ad, NB - ad), min=0.0)
    mo = mag[..., None, :] * w
    W2 = torch.from_numpy(_w2_constant(G, D, spc)).to(dev)
    with full_f32():
        desc = torch.matmul(mo, W2)                            # [B, C, NB, D*D]
    return desc.transpose(-1, -2).reshape(B, C, D * D * NB)


def finalize_descriptors(desc: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """normalize -> clip -> renormalize -> uint8 quantize. desc: [..., 128]."""
    if not cfg.unnormalized:
        n = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
        desc = desc / torch.clamp(n, min=1e-12)
        desc = torch.clamp(desc, max=cfg.descriptor_clip)
        n = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
        desc = desc / torch.clamp(n, min=1e-12)
    return torch.clamp(torch.floor(512.0 * desc + 0.5), 0, 255).to(torch.uint8)


def bin_descriptors(sgx: torch.Tensor, sgy: torch.Tensor, theta: torch.Tensor,
                    cfg: SiftConfig, chunk: int = 2048) -> torch.Tensor:
    """uint8 descriptors [B, K2, 128] from samples sgx, sgy [B, K2, G²]
    (out-of-image samples zeroed) and theta [B, K2]; chunked over keypoints
    to bound the [B, chunk, NB, G²] intermediate."""
    B, K2, _ = sgx.shape
    outs = [
        _bin_chunk_fast(sgx[:, i : i + chunk], sgy[:, i : i + chunk],
                        theta[:, i : i + chunk], cfg)
        for i in range(0, K2, chunk)
    ]
    raw = torch.cat(outs, dim=1) if outs else sgx.new_zeros((B, 0, cfg.descriptor_dim))
    return finalize_descriptors(raw, cfg)
