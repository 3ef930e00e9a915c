"""Two-view epipolar geometry: 8-point essential matrix + batched RANSAC.

Port of `siftgpu_tpu/geometry/epipolar.py`.  A STATIC number of hypotheses
is evaluated at once — no early exit, no host sync; masked correspondences
never count in a score.  `eight_point` takes any leading batch, so the 512
minimal solves are one [512, 9, 9] `eigh` and one [512, 3, 3] `svd`
(`ops/small_eig.py`: the sync-free kernel on the card, `torch.linalg` on
the CPU).

The reference's `ransac_essential` is split in two here:
`sample_minimal_sets` draws the minimal sets (i.i.d. with probability
proportional to the mask, as `jax.random.choice(..., p=mask/sum)`; a
`torch.Generator` on the mask's device replaces the JAX key, so the two draw
different numbers from the same seed), and `ransac_from_samples` scores and
refines given draws — the tests feed it the reference's own draws.

Two departures from the reference's RANSAC, both where its result is a
matter of rounding: a minimal set that repeats a correspondence (its E is
undetermined) wins only where no set of 8 distinct ones scores, and a
refit replaces E only if it keeps at least as many inliers.  With 30-43
matches (a 144x192 SLAM bootstrap) 48-61% of 256 sets repeat one.

Conventions: points are 2-D in NORMALIZED camera coordinates (K^-1 applied)
for the essential path; `eight_point` itself is metric-agnostic.  E maps
image0 -> image1: x1^T E x0 = 0.  Matmuls run with TF32 off.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.graphs import graphed
from ..core.precision import full_f32
from ..ops import small_eig

__all__ = [
    "RansacResult", "eight_point", "sampson_distance", "sample_minimal_sets",
    "ransac_from_samples", "ransac_essential", "ransac_essential_jit",
]

_SQRT2 = math.sqrt(2.0)


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _normalize_for_dlt(x, w):
    """Hartley normalization (masked): center + sqrt(2) mean distance.
    x [..., N, 2], w [..., N] -> (normalized x, T [..., 3, 3])."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    mean = (x * w[..., None]).sum(-2) / wsum                    # [..., 2]
    d = torch.sqrt(((x - mean[..., None, :]) ** 2).sum(-1))
    md = torch.clamp((d * w).sum(-1, keepdim=True) / wsum, min=1e-9)
    scale = torch.full_like(md, _SQRT2) / md                    # [..., 1]; one rounding
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.cat([scale, zero, -mean[..., :1] * scale], -1),
        torch.cat([zero, scale, -mean[..., 1:] * scale], -1),
        torch.cat([zero, zero, one], -1),
    ], dim=-2)
    return (x - mean[..., None, :]) * scale[..., None], T


def eight_point(x0: torch.Tensor, x1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point algorithm.  x0, x1: [..., N, 2]; w: [..., N] weights.

    Returns E [..., 3, 3] with the essential constraint (two equal singular
    values, third zero) enforced.  Hartley normalization + the eigenvector
    of the smallest eigenvalue of A^T A (9x9 eigh, no [N, 9] SVD)."""
    x0n, T0 = _normalize_for_dlt(x0, w)
    x1n, T1 = _normalize_for_dlt(x1, w)
    u0, v0 = x0n[..., 0], x0n[..., 1]
    u1, v1 = x1n[..., 0], x1n[..., 1]
    A = torch.stack(
        [u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, torch.ones_like(u0)], dim=-1
    )                                                           # [..., N, 9]
    with full_f32():
        M = (A * w[..., None]).transpose(-1, -2) @ A            # [..., 9, 9]
        _, vecs = small_eig.eigh_sym(M)
        En = vecs[..., 0].reshape(*vecs.shape[:-2], 3, 3)       # smallest eigenvalue
        E = T1.transpose(-1, -2) @ En @ T0
        U, s, Vt = small_eig.svd3(E)
        sm = (s[..., 0] + s[..., 1]) / 2.0
        S = torch.stack([sm, sm, torch.zeros_like(sm)], -1)
        return (U * S[..., None, :]) @ Vt


def sampson_distance(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance per correspondence.
    E [..., 3, 3], x0 / x1 [N, 2] -> [..., N]."""
    h0, h1 = _homog(x0), _homog(x1)                             # [N, 3]
    with full_f32():
        Ex0 = h0 @ E.transpose(-1, -2)                          # [..., N, 3]
        Etx1 = h1 @ E
    num = (h1 * Ex0).sum(-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


class RansacResult(NamedTuple):
    E: torch.Tensor            # [3, 3] refined essential matrix
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # [] int32
    best_score: torch.Tensor   # [] int32


def sample_minimal_sets(mask: torch.Tensor, num_hypotheses: int,
                        generator: torch.Generator) -> torch.Tensor:
    """[num_hypotheses, 8] int64 indices drawn i.i.d. with probability
    proportional to `mask` [N] bool, from `generator` (on the mask's device).

    With no valid correspondence the draw is uniform over all N: the
    reference's zero distribution does not raise either, and none of those
    draws can score, since scores count only masked-in correspondences."""
    p = mask.to(torch.float32)
    p = torch.where(mask.any(), p, torch.ones_like(p))
    idx = torch.multinomial(p, num_hypotheses * 8, replacement=True, generator=generator)
    return idx.view(num_hypotheses, 8)


def ransac_from_samples(
    x0: torch.Tensor, x1: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
    threshold: float | torch.Tensor = 1e-4, refine_iters: int = 2,
) -> RansacResult:
    """Score the minimal sets `idx` [H, 8] and refine the best.  x0, x1:
    [N, 2] normalized coords; `threshold` is on squared Sampson distance
    (~ (px_tol / focal)^2), a float or a 0-d tensor."""
    idx = idx.to(torch.int64)
    Es = eight_point(x0[idx], x1[idx], torch.ones(idx.shape, dtype=x0.dtype, device=x0.device))
    inls = (sampson_distance(Es, x0, x1) < threshold) & mask    # [H, N]
    scores = inls.sum(-1)
    # a set that repeats a correspondence leaves its 9 x 9 normal matrix a
    # 2-D null space: its E is whichever vector of that plane the solver's
    # rounding gives, so it wins only where no set of 8 distinct ones scores
    distinct = (idx[:, :, None] == idx[:, None, :]).sum((-1, -2)) == idx.shape[1]
    rank = scores + distinct.to(scores.dtype) * (x0.shape[0] + 1)
    # a 1-element index: PyTorch reads a 0-d index tensor on the host
    best = torch.argmax(rank).reshape(1)
    E, inliers = Es[best][0], inls[best][0]
    # iterative weighted refinement on the full inlier set; a refit replaces
    # E only if it keeps at least as many inliers (on a nearly degenerate
    # inlier set the 8-point refit can collapse to a handful)
    for _ in range(refine_iters):
        E_new = eight_point(x0, x1, inliers.to(x0.dtype))
        inl_new = (sampson_distance(E_new, x0, x1) < threshold) & mask
        keep = inl_new.sum() >= inliers.sum()
        E = torch.where(keep, E_new, E)
        inliers = torch.where(keep, inl_new, inliers)
    return RansacResult(E=E, inliers=inliers, num_inliers=inliers.sum().to(torch.int32),
                        best_score=scores[best][0].to(torch.int32))


def ransac_essential(
    x0: torch.Tensor, x1: torch.Tensor, mask: torch.Tensor, generator: torch.Generator,
    num_hypotheses: int = 512, threshold: float | torch.Tensor = 1e-4, refine_iters: int = 2,
) -> RansacResult:
    """Fixed-iteration batched RANSAC for E.  x0, x1: [N, 2] normalized
    coords; mask [N] bool; `generator` on their device; `threshold` on
    squared Sampson distance, a float or a 0-d tensor on their device."""
    idx = sample_minimal_sets(mask, num_hypotheses, generator)
    return ransac_from_samples(x0, x1, mask, idx, threshold, refine_iters)


# the reference's jitted `ransac_essential` (`num_hypotheses`, `refine_iters`
# static, `threshold` traced): captured once per signature on CUDA inputs
# (`core/graphs.py`), the generator as state.  A 0-d tensor threshold is an
# input of the capture, so one capture serves every value (make it with
# `torch.full((), thr, device=dev)`: a fill, where `torch.tensor(thr,
# device=dev)` copies from pageable memory and synchronises); a float
# threshold is static, one capture per value
ransac_essential_jit = graphed(ransac_essential, "ransac_essential_jit")
