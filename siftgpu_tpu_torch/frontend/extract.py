"""Full feature extraction: pyramid -> detect -> orient + describe -> top-K.

Port of `siftgpu_tpu/frontend/extract.py` on its accelerator route (the
fused orientation + descriptor path).  Every stage works on fixed-capacity
padded buffers with validity masks.  Wherever the reference calls
`lax.top_k`, the port sorts stably in descending order, so ties resolve to
the lowest index as they do there; this matters in `assemble_features`,
where the orientation slots of one keypoint carry the same response.

`extract_features_obo` (-obo) runs the same stages one octave at a time,
as three programs (`_obo_prep`, `_obo_octave` per octave, `_obo_assemble`);
`extract_features_obo_jit` runs their captures.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import SiftConfig
from ..core.graphs import GraphFamily, graphed
from . import detect, fused, orient, pyramid

__all__ = [
    "Features", "octave_candidates", "prefilter_candidates",
    "assemble_features", "to_image_coords", "extract_features", "extract_features_jit",
    "extract_features_obo", "extract_features_obo_jit",
]


class Features(NamedTuple):
    """Padded per-image feature buffers, in input-image coordinates."""

    x: torch.Tensor         # [B, K] float32
    y: torch.Tensor         # [B, K]
    sigma: torch.Tensor     # [B, K]
    theta: torch.Tensor     # [B, K] radians in [0, 2pi)
    response: torch.Tensor  # [B, K] |DoG| at the keypoint (signed if keep_sign)
    octave: torch.Tensor    # [B, K] int32
    desc: torch.Tensor      # [B, K, 128] uint8
    mask: torch.Tensor      # [B, K] bool

    @property
    def count(self):
        return self.mask.sum(dim=-1).to(torch.int32)

    @property
    def keypoints(self):
        """[B, K, 4] (x, y, sigma, theta)."""
        return torch.stack([self.x, self.y, self.sigma, self.theta], dim=-1)


def octave_candidates(oc: pyramid.Octave, cfg: SiftConfig, cap: int, y0=None, global_h=None,
                      owned_rows=None, kp=None):
    """Detect (unless `kp` is given) + orient + describe one octave.
    Returns a dict of [B, cap * max_orientations] octave-local arrays (y, x
    relative to the given plane).  A spatial slab passes `y0` (the image row
    of its row 0), `global_h` (the image's height at this octave) and
    `owned_rows=(lo, hi)`, the slab rows whose candidates it keeps."""
    B = oc.gauss.shape[0]
    if kp is None:
        kp = detect.detect_octave(oc, cfg, cap, owned_rows=owned_rows)
    grads = orient.gradient_stack(oc.gauss, cfg, y0=y0, global_h=global_h)
    n = cfg.max_orientations

    def dup(a):
        return a[..., None].expand(*a.shape, n).reshape(B, cap * n)

    y2, x2, s2, r2 = map(dup, (kp.y, kp.x, kp.sigma, kp.response))
    th2, m2, d2 = fused.orient_describe_fused(grads, kp, cfg)
    return dict(y=y2, x=x2, sigma=s2, theta=th2, response=r2, mask=m2, desc=d2)


def prefilter_candidates(kps, cfg: SiftConfig):
    """Mask out candidates that cannot reach the final top-K (strictly below
    the K-th largest valid response) and front-compact the survivors of each
    octave with a stable argsort.  Output-preserving, a work saver for the
    keypoint kernel."""
    K = cfg.max_keypoints
    rank = (lambda r: r.abs()) if cfg.keep_sign else (lambda r: r)
    resp = torch.cat(
        [torch.where(k.mask, rank(k.response), float("-inf")) for k in kps], dim=1
    )
    if resp.shape[1] <= K:
        return kps
    thr = torch.sort(resp, dim=1, descending=True, stable=True).values[:, K - 1 : K]
    masks = [k.mask & (rank(k.response) >= thr) for k in kps]

    outs = []
    for k, m in zip(kps, masks):
        order = torch.argsort((~m).to(torch.int32), dim=1, stable=True)
        take = lambda a: torch.gather(a, 1, order)
        outs.append(k._replace(
            y=take(k.y), x=take(k.x), level=take(k.level),
            grad_level=take(k.grad_level), sigma=take(k.sigma),
            response=take(k.response), mask=take(m),
        ))
    return outs


def assemble_features(parts, cfg: SiftConfig) -> Features:
    """parts: per-octave dicts with image-coordinate fields + 'octave'.
    Concatenates and keeps the K highest responses (ties: lowest slot)."""
    cat = lambda k: torch.cat([p[k] for p in parts], dim=1)
    x, y, s, th, r = map(cat, ("x", "y", "sigma", "theta", "response"))
    m, oc_, d = cat("mask"), cat("octave"), cat("desc")
    K = cfg.max_keypoints
    if m.shape[1] < K:  # tiny images: fewer candidates than the cap
        pad = K - m.shape[1]
        pf = lambda a: torch.nn.functional.pad(a, (0, pad))
        x, y, s, th, r, oc_, m = map(pf, (x, y, s, th, r, oc_, m))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad))
    resp = r.abs() if cfg.keep_sign else r
    if cfg.truncate_method == 1:    # -tc1: fine octaves first
        resp = resp - oc_.to(resp.dtype) * 4.0
    elif cfg.truncate_method == 2:  # -tc2: coarse octaves first
        resp = resp + oc_.to(resp.dtype) * 4.0
    score = torch.where(m, resp, float("-inf"))
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :K]
    take = lambda a: torch.gather(a, 1, idx)
    return Features(
        x=take(x), y=take(y), sigma=take(s), theta=take(th),
        response=take(r), octave=take(oc_),
        desc=torch.gather(d, 1, idx[..., None].expand(-1, -1, d.shape[-1])),
        mask=take(m),
    )


def to_image_coords(cand: dict, cfg: SiftConfig, o: int) -> dict:
    """Octave-local candidate dict -> image-coordinate dict (+ octave field)."""
    scale = cfg.octave_scale(o)
    shift = 0.5 if cfg.lowe_origin else 0.0
    out = dict(cand)
    out["x"] = (cand["x"] + shift) * scale
    out["y"] = (cand["y"] + shift) * scale
    out["sigma"] = cand["sigma"] * scale
    if cfg.keep_sign:  # minima download a negated scale
        out["sigma"] = torch.where(cand["response"] < 0, -out["sigma"], out["sigma"])
    out["octave"] = torch.full(cand["mask"].shape, o, dtype=torch.int32,
                               device=cand["mask"].device)
    return out


def extract_features(images: torch.Tensor, cfg: SiftConfig) -> Features:
    """images: [B, H, W] grayscale float in [0, 1] on the CPU or a CUDA
    device -> Features with K = cfg.max_keypoints on that device, ordered
    by response (descending), padded entries masked."""
    pyr = pyramid.build_pyramid(images, cfg)
    kps = detect.detect_pyramid(pyr, cfg)
    if cfg.truncate_method == 0:  # the prefilter assumes response-rank selection
        kps = prefilter_candidates(kps, cfg)
    parts = []
    for o, oc in enumerate(pyr):
        cand = octave_candidates(oc, cfg, cfg.octave_cap(o), kp=kps[o])
        parts.append(to_image_coords(cand, cfg, o))
    return assemble_features(parts, cfg)


# the reference's `extract_features_jit`: captured once per signature on
# CUDA inputs (`core/graphs.py`)
extract_features_jit = graphed(extract_features, "extract_features_jit")


def _obo_prep(images: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """-obo's first program: input conditioning and the initial blur ->
    octave 0's Gaussian level 0."""
    return pyramid.octave0_base(images, cfg)


def _obo_octave(base: torch.Tensor, cfg: SiftConfig, o: int):
    """-obo's program of octave o: its levels and DoGs, detect, orient +
    describe -> (the image-coordinate candidate dict, octave o+1's base).
    Only `base` and the candidates outlive it."""
    oc = pyramid._octave_levels(base, cfg)
    cand = octave_candidates(oc, cfg, cfg.octave_cap(o))
    return to_image_coords(cand, cfg, o), pyramid.downsample2x(oc.gauss[:, cfg.dog_levels])


def _obo_assemble(parts, cfg: SiftConfig) -> Features:
    """-obo's last program: the top-K over a tuple of octave dicts."""
    return assemble_features(list(parts), cfg)


def _obo_chain(images, cfg, prep, octave, assemble) -> Features:
    base = prep(images, cfg)
    parts = []
    for o in range(cfg.octaves):
        part, base = octave(base, cfg, o)
        parts.append(part)
    return assemble(tuple(parts), cfg)


def extract_features_obo(images: torch.Tensor, cfg: SiftConfig) -> Features:
    """Octave-by-octave extraction (`GlobalUtil::_ProcessOBO`, -obo): blur
    chain, detect, orient + describe and the image-coordinate candidates of
    one octave, then the next octave from its decimated level S; the final
    top-K over all octaves.  Only one octave's pyramid and gradients are
    alive at a time.  There is no cross-octave prefilter, which only saves
    work, so the outputs are identical to `extract_features`'."""
    return _obo_chain(images, cfg, _obo_prep, _obo_octave, _obo_assemble)


# the reference's -obo programs, captured on CUDA inputs into one shared
# pool (`core/graphs.py`), so that -obo keeps its cap of about one octave's
# working set.  A call at one size captures 2 + octaves programs (10 at
# 2160x3840), so the limit holds two such sizes, or more smaller ones.
OBO_CAPTURES = 24
OBO_FAMILY = GraphFamily("obo", limit=OBO_CAPTURES)
_obo_prep_jit = graphed(_obo_prep, "_obo_prep_jit", OBO_FAMILY)
_obo_octave_jit = graphed(_obo_octave, "_obo_octave_jit", OBO_FAMILY)
_obo_assemble_jit = graphed(_obo_assemble, "_obo_assemble_jit", OBO_FAMILY)


def extract_features_obo_jit(images: torch.Tensor, cfg: SiftConfig) -> Features:
    """`extract_features_obo` through the captured programs (the
    reference's `extract_features_obo`, which always runs compiled): on CPU
    inputs the eager functions."""
    return _obo_chain(images, cfg, _obo_prep_jit, _obo_octave_jit, _obo_assemble_jit)
