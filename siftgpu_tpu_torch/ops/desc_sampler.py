"""Bilinear gradient sampling at per-keypoint rotated grids: CUDA kernel +
plain version.

Replaces `siftgpu_tpu/ops/desc_sampler.py::sample_gradients` (Pallas) with
its interface — flattened planes, a plane index per keypoint, absolute
sample coordinates — and the semantics of the reference's gather route
(`frontend/describe.py::_bilerp_xla`), not the TPU kernel's bf16 tent
matmul:

    x0 = clamp(floor(px), 0, W-1), x1 = min(x0+1, W-1)    (rows alike)
    fx = clamp(px - x0, 0, 1)                              (fy alike)
    s  = g00 (1-fy)(1-fx) + g01 (1-fy) fx + g10 fy (1-fx) + g11 fy fx

with the bf16 taps widened to f32 and the sum taken left to right.  The
kernel (`csrc/desc_sampler.cu`, built with -fmad=false) and the plain
version are bit-identical.  A keypoint with a negative plane is skipped, so
the sampling of several octaves can share one output buffer (`out`): each
octave's call fills the rows of its own keypoints.

`sample_gradients(...)` takes the plain version for CPU tensors and the
kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["sample_gradients", "sample_gradients_plain", "KERNEL"]

KERNEL = _build.Kernel(
    "sample_gradients", "desc_sampler.cu",
    {"sample_gradients_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
     + [ctypes.c_void_p]},
    flags=["-fmad=false"],
)


def sample_gradients_plain(gx, gy, plane, py, px, out=None):
    """Plain PyTorch version; see `sample_gradients` for the contract."""
    P, H, W = gx.shape
    x0 = torch.floor(px).to(torch.int64).clamp(0, W - 1)
    y0 = torch.floor(py).to(torch.int64).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    fx = (px - x0.to(torch.float32)).clamp(0.0, 1.0)
    fy = (py - y0.to(torch.float32)).clamp(0.0, 1.0)
    live = (plane >= 0)[:, None]
    base = plane.to(torch.int64).clamp(min=0)[:, None] * (H * W)

    def bilerp(f):
        flat = f.reshape(-1)

        def at(yi, xi):
            return flat[base + yi * W + xi].to(torch.float32)

        return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x1) * (1 - fy) * fx
                + at(y1, x0) * fy * (1 - fx) + at(y1, x1) * fy * fx)

    out = out if out is not None else (torch.zeros_like(py), torch.zeros_like(py))
    for o, f in zip(out, (gx, gy)):
        o.copy_(torch.where(live, bilerp(f), o))
    return out


def _sample_gradients_cuda(gx, gy, plane, py, px, out=None):
    _build.check_tensor(gx, "gx", torch.bfloat16, 3)
    _build.check_tensor(gy, "gy", torch.bfloat16, 3)
    _build.check_tensor(plane, "plane", torch.int32, 1)
    _build.check_tensor(py, "py", torch.float32, 2)
    _build.check_tensor(px, "px", torch.float32, 2)
    P, H, W = gx.shape
    N, G2 = py.shape
    if gy.shape != gx.shape or plane.shape[0] != N or px.shape != py.shape:
        raise ValueError(f"shapes: gx {tuple(gx.shape)}, gy {tuple(gy.shape)}, "
                         f"plane {tuple(plane.shape)}, py {tuple(py.shape)}, px {tuple(px.shape)}")
    if out is None:
        out = (torch.zeros_like(py), torch.zeros_like(py))
    for name, o in zip(("out[0]", "out[1]"), out):
        _build.check_tensor(o, name, torch.float32, 2)
        if o.shape != py.shape:
            raise ValueError(f"{name}: shape {tuple(o.shape)}, expected {tuple(py.shape)}")
    if N == 0 or G2 == 0:
        return out
    p = _build.ptr
    KERNEL.launch("sample_gradients_launch", gx.device, p(gx), p(gy), p(plane),
                  p(py), p(px), p(out[0]), p(out[1]), N, H, W, G2)
    return out


def sample_gradients(gx, gy, plane, py, px, out=None):
    """gx, gy: [P, H, W] bf16 gradient planes; plane: [N] int32 plane of each
    keypoint, in [0, P), or negative to skip the keypoint; py, px: [N, G²]
    f32 absolute sample coordinates; out: an optional pair of [N, G²] f32
    buffers to write into (new zero buffers otherwise).  Returns (sgx, sgy)
    [N, G²]: the bilinear samples of every keypoint that is not skipped
    (clamped at the plane's edges; the caller zeroes samples outside the
    true image); a skipped keypoint's rows keep their bytes."""
    if gx.device.type == "cpu":
        return sample_gradients_plain(gx, gy, plane, py, px, out)
    return _sample_gradients_cuda(gx, gy, plane, py, px, out)
