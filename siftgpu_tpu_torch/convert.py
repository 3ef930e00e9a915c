"""State carried across from the JAX package.

The system has no learned weights: its parameters are the frozen configs and
the numeric constants (copied into `core/`).  This module moves the JAX
package's configs and outputs into the port:

  - `sift_config_from_reference` / `match_config_from_reference` take
    `dataclasses.asdict()` of a `siftgpu_tpu` config;
  - `to_torch` turns a NumPy or JAX array (anything `np.asarray` accepts,
    bf16 included) into a tensor, and `tree_to_torch` does so field by field
    for a NamedTuple (features, match results, BA problems and states), so
    one stage's reference output can feed the next stage of the port;
  - `keypoints_from_reference` takes the valid (x, y, sigma, theta) rows of
    a reference `Features` (the list descriptor-only mode consumes), and
    `matrix_to_torch` a reference H or F as an f32 tensor.

Nothing here imports JAX: arrays arrive through `np.asarray`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.config import MatchConfig, SiftConfig

__all__ = [
    "sift_config_from_reference", "match_config_from_reference",
    "to_torch", "tree_to_torch", "keypoints_from_reference", "matrix_to_torch",
]


def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    if set(d) != names:
        raise ValueError(
            f"{cls.__name__}: fields differ from the reference "
            f"(missing {sorted(names - set(d))}, unknown {sorted(set(d) - names)})"
        )
    return cls(**d)


def sift_config_from_reference(d: dict) -> SiftConfig:
    """`SiftConfig` from `dataclasses.asdict(siftgpu_tpu.SiftConfig(...))`."""
    return _from_dict(SiftConfig, d)


def match_config_from_reference(d: dict) -> MatchConfig:
    """`MatchConfig` from `dataclasses.asdict(siftgpu_tpu.MatchConfig(...))`."""
    return _from_dict(MatchConfig, d)


def to_torch(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """NumPy / JAX array -> tensor on `device` (bf16 keeps its bits)."""
    n = np.asarray(a)
    if n.dtype.name == "bfloat16":
        u = torch.from_numpy(np.ascontiguousarray(n.view(np.uint16)).astype(np.int16))
        return u.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(n, copy=True)).to(device)


def tree_to_torch(nt, cls, device: str | torch.device = "cpu"):
    """Reference NamedTuple -> the port's NamedTuple `cls`, taking the fields
    `cls` names (Python ints and None pass through, arrays become tensors):
    `Features`, `MatchResult`, `BAProblem`, `BAState`, ..."""
    def conv(v):
        return v if v is None or isinstance(v, (int, float)) else to_torch(v, device)

    return cls(**{name: conv(getattr(nt, name)) for name in cls._fields})


def keypoints_from_reference(feats, b: int = 0) -> np.ndarray:
    """[N, 4] float32 (x, y, sigma, theta) of image b's valid keypoints of a
    reference `Features` (or the port's: any object with those fields)."""
    m = np.asarray(feats.mask)[b]
    keys = np.stack([np.asarray(getattr(feats, f))[b] for f in ("x", "y", "sigma", "theta")], -1)
    return keys[m].astype(np.float32)


def matrix_to_torch(M, device: str | torch.device = "cpu") -> torch.Tensor:
    """A reference homography or fundamental matrix [3, 3] -> f32 tensor."""
    return torch.from_numpy(np.asarray(M, np.float32).reshape(3, 3).copy()).to(device)
