"""The system under test: the entry points of `siftgpu_tpu_torch` that a
kind names (`kinds/<kind>.py`'s ENTRIES), the kernels' build, and the
program's kernel sources and launch counters that the traced run reads.

Nothing else of the program is used.  The frame and match entry points
are the captured programs that `run_slam`, the facade and `bench_torch.py`
call (CUDA graphs on CUDA inputs, the eager functions on CPU inputs).
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import SimpleNamespace

__all__ = ["entries", "build_all", "hand_kernels", "launch_counts"]


def entries(spec: dict) -> SimpleNamespace:
    """{name: "module:attribute"} -> a namespace of those attributes."""
    out = {}
    for name, where in spec.items():
        mod, attr = where.split(":")
        out[name] = getattr(importlib.import_module(mod), attr)
    return SimpleNamespace(**out)


def _build():
    from siftgpu_tpu_torch.ops import _build
    return _build


def build_all() -> None:
    """Every kernel library at once; a later run of the checkout finds them built."""
    _build().build_all()


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)")


def hand_kernels() -> dict:
    """{kernel function name: source file name} for every `__global__`
    function of the program's CUDA sources."""
    out = {}
    for src in sorted(Path(_build().CSRC).glob("*.cu")):
        for name in _GLOBAL.findall(src.read_text()):
            out[name] = src.name
    return out


def launch_counts() -> dict:
    """{source file name: launches counted so far} summed over the
    program's kernels (each launch of a source's C entry launches each of
    its kernels once)."""
    out: dict = {}
    for k in _build().KERNELS.values():
        out[k.source.name] = out.get(k.source.name, 0) + int(k.launches)
    return out
