"""128-D SIFT descriptors: rotated 16x16 grid sampling + trilinear binning.

Port of `siftgpu_tpu/frontend/describe.py`, two paths:

  - the fused path (`extract_features`): `bin_descriptors` bins samples that
    `ops/kp_engine.py` took, on the `_bin_chunk_fast` body in f32 (what the
    reference's CPU route runs) — circular-tent orientation weights and one
    [G², D²] contraction against the constant `W2`.  Wrap edge: ob == NB
    (an angle that rounds to 2π) puts its weight on bin 0, as the oracle's
    `floor(ob) % NB` does.
  - the unfused path (descriptor-only mode, `frontend/redetect.py`):
    `describe_octaves` takes every keypoint's grid coordinates once
    (`_sample_coords`), samples each octave's keypoints on that octave's
    gradient stack into one shared buffer (one `ops/desc_sampler.py` call
    per octave, the other octaves' keypoints skipped: the CUDA kernel on the
    card, the plain gather on the CPU), and bins all keypoints at once, in
    512-keypoint chunks, with `_bin_chunk`: one-hot soft assignment and a
    double spatial contraction in full f32.  Its wrap edge keeps
    `clip(floor(ob), 0, NB-1)`: ob == NB lands on bin NB-1.
    `compute_descriptors` is its one-octave case.

Both end in `finalize_descriptors` (normalize -> clip 0.2 -> renormalize ->
uint8).  The TPU's bf16 binning has no counterpart: the port bins in f32 on
every device.  Binning is plain PyTorch on both devices (the reference's
binning is XLA, not Pallas); its contractions run in full f32 (`full_f32`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..core.config import SiftConfig
from ..core.graphs import device_constant
from ..ops.desc_sampler import sample_gradients
from .orient import GradStack
from ..core.precision import full_f32

__all__ = ["bin_descriptors", "finalize_descriptors", "compute_descriptors", "describe_octaves"]

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


def _on_device(name: str, cfg: SiftConfig, device) -> torch.Tensor:
    """`_grid_constants`' "t", "wrc" or "gw" (flattened to [G²]), or "W2",
    on `device`, uploaded once (`core.graphs.device_constant`)."""
    G, D, spc = cfg.descriptor_grid, cfg.descriptor_width, cfg.descriptor_samples_per_cell

    def make():
        if name == "W2":
            return _w2_constant(G, D, spc)
        t, wrc, gw = _grid_constants(G, D, spc)
        return {"t": t, "wrc": wrc, "gw": gw.reshape(G * G)}[name]

    return device_constant((name, G, D, spc), device, make)


def _bin_chunk_fast(sgx, sgy, theta, cfg: SiftConfig):
    """Raw descriptors [B, C, 128] from samples [B, C, G²] and theta [B, C]."""
    B, C, G2 = sgx.shape
    NB, D = cfg.descriptor_bins, cfg.descriptor_width
    dev = sgx.device
    gwf = _on_device("gw", cfg, dev)
    mag = torch.sqrt(sgx * sgx + sgy * sgy) * gwf
    ang = torch.fmod(torch.atan2(sgy, sgx) - theta[..., None], _TWO_PI)
    ang = torch.where(ang < 0, ang + _TWO_PI, ang)           # floor-mod 2π
    ob = ang * (NB / _TWO_PI)
    bins = torch.arange(NB, dtype=torch.float32, device=dev)[:, None]
    ad = (ob[..., None, :] - bins).abs()                       # [B, C, NB, G2]
    w = torch.clamp(1.0 - torch.minimum(ad, NB - ad), min=0.0)
    mo = mag[..., None, :] * w
    W2 = _on_device("W2", cfg, dev)
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


# ---------------- the unfused path (descriptor-only mode) ----------------

def _sample_coords(y, x, sigma, theta, cfg: SiftConfig):
    """Rotated sample-grid coordinates. y..theta: [B, C] -> py, px [B, C, G, G]."""
    G = cfg.descriptor_grid
    t = _on_device("t", cfg, y.device)
    spc = cfg.descriptor_spacing * sigma / cfg.descriptor_samples_per_cell  # [B, C]
    u = t[None, None, None, :] * spc[..., None, None]      # [B, C, 1, G] (cols)
    v = t[None, None, :, None] * spc[..., None, None]      # [B, C, G, 1] (rows)
    ct = torch.cos(theta)[..., None, None]
    st = torch.sin(theta)[..., None, None]
    px = x[..., None, None] + ct * u - st * v              # [B, C, G, G]
    py = y[..., None, None] + st * u + ct * v
    return py, px


def _bin_chunk(sgx, sgy, theta, cfg: SiftConfig):
    """Raw descriptors [B, C, 128] from samples sgx, sgy [B, C, G²] (out of
    image samples zeroed) and theta [B, C]: one-hot soft orientation
    assignment, then the row and column cell tents contracted in full f32."""
    G, D, NB = cfg.descriptor_grid, cfg.descriptor_width, cfg.descriptor_bins
    B, C, G2 = sgx.shape
    dev = sgx.device
    wrc = _on_device("wrc", cfg, dev)
    gwf = _on_device("gw", cfg, dev)
    mag = torch.sqrt(sgx * sgx + sgy * sgy) * gwf           # [B, C, G2]
    ang = torch.fmod(torch.atan2(sgy, sgx) - theta[..., None], _TWO_PI)
    ang = torch.where(ang < 0, ang + _TWO_PI, ang)           # floor-mod 2π
    ob = ang * (NB / _TWO_PI)
    fl = torch.floor(ob)
    o0 = fl.to(torch.int64).clamp(0, NB - 1)
    fo = ob - fl
    oh0 = torch.nn.functional.one_hot(o0, NB).to(torch.float32)
    oh1 = torch.nn.functional.one_hot((o0 + 1) % NB, NB).to(torch.float32)
    mo = (mag * (1.0 - fo))[..., None] * oh0 + (mag * fo)[..., None] * oh1
    mo = mo.reshape(B, C, G, G, NB)
    with full_f32():
        desc = torch.einsum("bkijo,ir,jc->bkrco", mo, wrc, wrc)  # [B, C, D, D, NB]
    return desc.reshape(B, C, D * D * NB)


def describe_octaves(grads: Sequence[GradStack], octave, y, x, sigma, theta, grad_level,
                     cfg: SiftConfig, chunk: int = 512) -> torch.Tensor:
    """uint8 descriptors [B, K, 128] of keypoints described each on its own
    octave: `grads` holds the octaves' gradient stacks, octave [B, K] int
    the keypoint's octave (negative: not sampled), y, x, sigma (octave-local)
    and theta [B, K], grad_level [B, K] in [1, S].  Samples outside the
    keypoint's octave's image are zeroed (in image rows: a slab's `y0` and
    `global_h`, as the reference's in-bounds test); binning runs in chunks of
    `chunk` keypoints to bound the [B, chunk, G, G, NB] intermediate."""
    G = cfg.descriptor_grid
    B, K = y.shape
    dev = y.device
    py, px = _sample_coords(y, x, sigma, theta, cfg)       # [B, K, G, G]
    h = torch.zeros((B, K), dtype=torch.float32, device=dev)
    w = torch.zeros_like(h)
    pyg = py                                               # image rows
    for o, g in enumerate(grads):
        h = torch.where(octave == o, float(g.image_h), h)
        w = torch.where(octave == o, float(g.w), w)
        if g.y0:                                           # a slab's octave
            pyg = pyg + torch.where(octave == o, float(g.y0), 0.0)[..., None, None]
    h, w = h[..., None, None], w[..., None, None]
    inb = (px >= 0) & (px <= w - 1) & (pyg >= 0) & (pyg <= h - 1)
    pyf = py.reshape(B * K, G * G).contiguous()
    pxf = px.reshape(B * K, G * G).contiguous()
    out = (torch.zeros_like(pyf), torch.zeros_like(pyf))
    b_idx = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    lvl = grad_level.to(torch.int32) - 1
    for o, g in enumerate(grads):
        S, Hp, Wp = g.gx.shape[1:]
        plane = torch.where(octave == o, b_idx * S + lvl, -1).to(torch.int32).reshape(B * K)
        sample_gradients(g.gx.reshape(B * S, Hp, Wp), g.gy.reshape(B * S, Hp, Wp),
                         plane.contiguous(), pyf, pxf, out)
    sgx = (out[0].reshape(B, K, G, G) * inb).reshape(B, K, G * G)
    sgy = (out[1].reshape(B, K, G, G) * inb).reshape(B, K, G * G)
    outs = [_bin_chunk(sgx[:, i : i + chunk], sgy[:, i : i + chunk], theta[:, i : i + chunk], cfg)
            for i in range(0, K, chunk)]
    raw = torch.cat(outs, dim=1) if outs else y.new_zeros((B, 0, cfg.descriptor_dim))
    return finalize_descriptors(raw, cfg)


def compute_descriptors(grads: GradStack, y, x, sigma, theta, grad_level,
                        cfg: SiftConfig, chunk: int = 512, sampler=None) -> torch.Tensor:
    """uint8 descriptors [B, K2, 128] at keypoints y, x, sigma, theta,
    grad_level [B, K2] of one octave (octave-local; grad_level in [1, S]):
    `describe_octaves` with every keypoint on `grads`.  `sampler` is carried
    for call compatibility and ignored: the device picks the route."""
    return describe_octaves([grads], torch.zeros_like(grad_level), y, x, sigma, theta,
                            grad_level, cfg, chunk)
