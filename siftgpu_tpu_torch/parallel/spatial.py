"""BASELINE config 3 on `torch.distributed`: a frame split into row slabs.

Port of `siftgpu_tpu/parallel/spatial.py`.  1080p and 4K frames are
extracted exactly, their rows split over the ranks of a group (SiftGPU
downsamples such frames instead).  Every rank holds the whole batch and
takes its block of rows; per octave:

  1. the slab is ringed with `halo` rows of its neighbours
     (`comm.exchange_halo`, one all-gather), image rows outside the frame
     replicating its edge row;
  2. the levels are blurred from the padded slab with the image's outer
     rows re-clamped after every blur (`_reclamp`), which is the
     single-process blur's replicate padding, exact at the frame's edges;
  3. detection, orientation and description run on the padded slab with
     its place in the frame (`octave_candidates`: `y0`, `global_h`,
     `owned_rows`): candidates only on the slab's own rows, the gradient's
     edge-row factor and the window and sample masks in frame rows; then
     the rows are shifted to the frame and its border applied;
  4. the next octave's base is the decimated own rows.

Octaves whose slabs would drop below `min_rows` rows run gathered: their
base is all-gathered once and the rest of the pyramid runs whole on every
rank, rank 0 owning its candidates.  The candidates of every rank are then
all-gathered (rank-major within an octave, the reference's order, which
the top-K's stable sort sees) and assembled on every rank.

The slab octaves blur with the plain separable convolution
(`blur_separable`): the octave kernel (`ops/pyramid_kernel.py`) builds its
levels without the re-clamp between them, as the reference's Pallas kernel
does, so it is not on the slab path.  The gathered octaves are whole
images and take it.  Kernels 1-3 run on every octave with the slab's
arguments.

With `halo` (96 rows) above the blur's accumulated radius (~40) plus the
descriptor window's reach (~56), a slab's keypoints are those of one
process's extraction up to the blur's rounding (the kernel against the
convolutions) and the order of equal responses.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.config import SiftConfig
from ..frontend import extract as fe
from ..frontend import pyramid
from ..frontend.extract import Features
from ..frontend.pyramid import Octave
from . import comm

__all__ = ["extract_features_spatial", "plan_octaves"]


def plan_octaves(rows: int, octaves: int, min_rows: int = 32) -> List[str]:
    """The reference's static plan: "spatial" while a slab keeps at least
    max(min_rows, 2) rows and an even count (it halves), then "gathered"."""
    plan = []
    for _ in range(octaves):
        if rows >= max(min_rows, 2) and rows % 2 == 0:
            plan.append("spatial")
            rows //= 2
        else:
            plan.append("gathered")
    return plan


def _reclamp(padded: torch.Tensor, h: int, idx: int, n: int) -> torch.Tensor:
    """Replicate padding re-imposed on the outer halo of the frame's first
    and last slabs: their h outer rows become the frame's edge row."""
    if idx not in (0, n - 1):
        return padded
    R = padded.shape[1]
    rows = torch.arange(R, device=padded.device)
    if idx == 0:
        rows[:h] = h
    if idx == n - 1:
        rows[R - h:] = R - h - 1
    return padded.index_select(1, rows)


def _slab_levels(base: torch.Tensor, cfg: SiftConfig, first: bool, h: int, idx: int,
                 n: int) -> Octave:
    """Gaussian levels and DoGs of a padded slab, re-clamped after every blur
    (the initial blur too, in octave 0)."""
    x = base
    if first:
        x = _reclamp(pyramid.blur_separable(x, cfg.gaussian_taps(cfg.initial_blur_sigma())),
                     h, idx, n)
    levels = [x]
    for s in cfg.incremental_sigmas():
        x = _reclamp(pyramid.blur_separable(x, cfg.gaussian_taps(float(s))), h, idx, n)
        levels.append(x)
    gauss = torch.stack(levels, dim=1)
    return Octave(gauss=gauss, dog=gauss[:, 1:] - gauss[:, :-1])


_FLOATS = ("x", "y", "sigma", "theta", "response")


def _gather_candidates(parts: List[dict], group) -> List[dict]:
    """Every rank's candidate dicts, each octave's laid out rank-major
    ([n, B, K] -> [B, n K]), on every rank: one all-gather of all octaves,
    every field's bits packed into one int32 buffer (floats as their bits,
    descriptor bytes as words), so that nothing is rounded on the way."""
    n = comm.world_size(group)
    if n == 1:
        return parts
    B = parts[0]["mask"].shape[0]
    word = lambda a: a.contiguous().view(torch.int32)
    packed = torch.cat([torch.cat([word(p[f])[..., None] for f in _FLOATS]
                                  + [p["octave"].to(torch.int32)[..., None],
                                     p["mask"].to(torch.int32)[..., None], word(p["desc"])],
                                  dim=2) for p in parts], dim=1)   # [B, sum K, 7 + 32]
    allp = comm.all_gather_rows(packed[None], group)                # [n, B, sum K, 39]
    out, off = [], 0
    for p in parts:
        K = p["mask"].shape[1]
        blk = allp[:, :, off : off + K].transpose(0, 1).reshape(B, n * K, -1)
        off += K
        d = {f: blk[..., i].contiguous().view(torch.float32) for i, f in enumerate(_FLOATS)}
        d.update(octave=blk[..., 5].contiguous(), mask=blk[..., 6] != 0,
                 desc=blk[..., 7:].contiguous().view(torch.uint8))
        out.append(d)
    return out


def extract_features_spatial(images, cfg: SiftConfig, group=None, device="cuda",
                             halo: int = 96, min_rows: int = 32,
                             stats: Optional[list] = None) -> Features:
    """images: [B, H, W] (NumPy or a tensor, the same on every rank), H
    split into equal row slabs over the ranks of `group` (None: the
    default group once one is initialised, else one process).  Returns the
    Features of the whole frames, the same on every rank, on `device`.

    `halo`: rows exchanged per octave; `min_rows`: the least slab rows of a
    spatial octave.  `stats`, if given, gets one dict per octave: its mode,
    the slab rows and the halo exchange's calls, bytes and host ms (the
    device synchronised around each collective).  Raises ValueError for
    `first_octave = -1` (the reference's spatial mode refuses it too), for
    a frame that does not match `cfg`, and for rows that do not split."""
    if cfg.first_octave < 0:
        raise ValueError("extract_features_spatial: first_octave -1 (upsampling) is not "
                         "supported on row slabs")
    group = comm.resolve(group)
    n, idx = comm.world_size(group), comm.rank(group)
    if images.shape[-2:] != (cfg.height, cfg.width):
        raise ValueError(f"extract_features_spatial: frames {tuple(images.shape)} do not match "
                         f"the config's {cfg.height}x{cfg.width}")
    step = 1 << cfg.first_octave            # -fo n > 0: n decimations before the split
    images = images[:, ::step, ::step]
    B, H, W = images.shape
    if H % n:
        raise ValueError(f"extract_features_spatial: {H} rows do not split over {n} ranks")
    r = H // n
    plan = plan_octaves(r, cfg.octaves, min_rows)
    blk = images[:, idx * r : (idx + 1) * r]
    blk = blk if torch.is_tensor(blk) else torch.from_numpy(np.ascontiguousarray(blk))
    base = blk.to(device=device, dtype=torch.float32).contiguous()   # [B, r_o, W_o]

    parts, o = [], 0
    while o < cfg.octaves and plan[o] == "spatial":
        H_o = cfg.octave_shape(o)[0]
        r_o = base.shape[1]
        ex = [] if stats is not None else None
        padded = _reclamp(comm.exchange_halo(base, halo, group, ex), halo, idx, n)
        oc = _slab_levels(padded, cfg, o == 0, halo, idx, n)
        y0 = idx * r_o - halo
        cand = fe.octave_candidates(oc, cfg, cfg.octave_cap(o), y0=y0, global_h=H_o,
                                    owned_rows=(halo, halo + r_o))
        gy = cand["y"] + float(y0)           # frame rows, then the frame's border
        bd = float(cfg.border)
        cand["mask"] = cand["mask"] & (gy >= bd) & (gy < H_o - bd)
        cand["y"] = gy
        parts.append(fe.to_image_coords(cand, cfg, o))
        base = pyramid.downsample2x(oc.gauss[:, cfg.dog_levels, halo : halo + r_o])
        if stats is not None:
            stats.append(dict(octave=o, mode="spatial", **ex[0]))
        o += 1

    if o < cfg.octaves:                      # the gathered octaves, whole on every rank
        ex = [] if stats is not None else None
        x = comm.gather_slabs(base, group, ex).contiguous()
        if stats is not None:
            stats.append(dict(octave=o, mode="gathered", **ex[0]))
        if o == 0:                           # no spatial octave ran: the initial blur
            x = pyramid.blur_separable(x, cfg.gaussian_taps(cfg.initial_blur_sigma()))
        for o in range(o, cfg.octaves):
            oc = pyramid._octave_levels(x, cfg)
            cand = fe.octave_candidates(oc, cfg, cfg.octave_cap(o))
            cand["mask"] = cand["mask"] & (idx == 0)   # rank 0 owns the whole octaves
            parts.append(fe.to_image_coords(cand, cfg, o))
            x = pyramid.downsample2x(oc.gauss[:, cfg.dog_levels])
    return fe.assemble_features(_gather_candidates(parts, group), cfg)
