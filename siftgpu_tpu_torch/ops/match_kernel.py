"""Best-2 descriptor match reduction: CUDA kernel + plain version.

Replaces `siftgpu_tpu/ops/match_kernel.py::match_best2` (Pallas), ungated.
For uint8 descriptor sets d0 [P, N0, 128] and d1 [P, N1, 128] (P pairs):

    sim[i, j] = (dot(d0[i], d1[j]) * rn1[j]) * rn0[i]    (-inf where masked)

and per row the best and second-best similarity and the argbest column, per
column the argbest row; ties go to the lowest index.  The integer dot is
exact (in the kernel by `__dp4a`, in the plain version by an f32 matmul of
values < 2^24), so with the same `rn0`/`rn1` the kernel
(`csrc/match_best2.cu`) and the plain version return identical selections
and bit-identical similarities.

`match_best2(...)` takes the plain version for CPU tensors and the kernel
for CUDA tensors.  The H/F-gated variant (guided matching) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..frontend.pyramid import full_f32

__all__ = ["match_best2", "match_best2_plain", "recip_norms", "KERNEL"]

KERNEL = _build.Kernel(
    "match_best2", "match_best2.cu",
    {"match_best2_launch": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
     + [ctypes.c_void_p]},
)


def recip_norms(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal L2 norm of each uint8 descriptor row, [..., 128] -> [...].

    Computed in float64 and rounded once to f32, so it is the correctly
    rounded value on every device (`torch.rsqrt` differs between the CPU and
    the card in the last ulp, and from the reference's `lax.rsqrt`)."""
    i = d.to(torch.int32)
    sq = (i * i).sum(dim=-1, dtype=torch.int32).to(torch.float64)
    return (1.0 / torch.sqrt(torch.clamp(sq, min=1e-24))).to(torch.float32)


def match_best2_plain(d0, d1, rn0, rn1, m0, m1):
    """Plain PyTorch version: the dense similarity matrix and its argmaxes."""
    with full_f32():
        dot = torch.matmul(d0.to(torch.float32), d1.to(torch.float32).transpose(-1, -2))
    sim = (dot * rn1[..., None, :]) * rn0[..., :, None]
    sim = torch.where(m0[..., :, None] & m1[..., None, :], sim, float("-inf"))
    best_j = torch.argmax(sim, dim=-1)
    bsim = torch.amax(sim, dim=-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    ssim = torch.where(cols == best_j[..., None], float("-inf"), sim).amax(dim=-1)
    col_best_i = torch.argmax(sim, dim=-2)
    return bsim, ssim, best_j.to(torch.int32), col_best_i.to(torch.int32)


def _match_best2_cuda(d0, d1, rn0, rn1, m0, m1):
    P, N0, D = d0.shape
    N1 = d1.shape[1]
    _build.check_tensor(d0, "d0", torch.uint8, 3)
    _build.check_tensor(d1, "d1", torch.uint8, 3)
    if D != 128 or d1.shape[0] != P or d1.shape[2] != 128:
        raise ValueError(f"descriptors must be [P, N, 128]: {tuple(d0.shape)}, {tuple(d1.shape)}")
    if N0 == 0 or N1 == 0 or d0.data_ptr() % 4 or d1.data_ptr() % 4:
        raise ValueError("descriptor sets must be non-empty and 4-byte aligned "
                         "(the kernel reads them as packed 32-bit words)")
    for name, t, dt, n in (("rn0", rn0, torch.float32, N0), ("rn1", rn1, torch.float32, N1),
                           ("m0", m0, torch.bool, N0), ("m1", m1, torch.bool, N1)):
        _build.check_tensor(t, name, dt, 2)
        if tuple(t.shape) != (P, n):
            raise ValueError(f"{name}: expected shape {(P, n)}, got {tuple(t.shape)}")
    dev = d0.device
    bsim = torch.empty((P, N0), dtype=torch.float32, device=dev)
    ssim = torch.empty((P, N0), dtype=torch.float32, device=dev)
    bestj = torch.empty((P, N0), dtype=torch.int32, device=dev)
    colb = torch.empty((P, N1), dtype=torch.int32, device=dev)
    colkey = torch.zeros((P, N1), dtype=torch.int64, device=dev)   # scratch
    p = _build.ptr
    KERNEL.launch("match_best2_launch", dev,
                  p(d0), p(d1), p(rn0), p(rn1), p(m0), p(m1),
                  p(bsim), p(ssim), p(bestj), p(colb), p(colkey), P, N0, N1)
    return bsim, ssim, bestj, colb


def match_best2(d0, d1, rn0, rn1, m0, m1):
    """d0 [P, N0, 128], d1 [P, N1, 128] uint8; rn0 [P, N0], rn1 [P, N1] f32
    reciprocal norms; m0, m1 bool masks -> (bsim, ssim [P, N0] f32,
    bestj [P, N0] int32, col_best_i [P, N1] int32)."""
    if d0.device.type == "cpu":
        return match_best2_plain(d0, d1, rn0, rn1, m0, m1)
    return _match_best2_cuda(d0, d1, rn0, rn1, m0, m1)
