"""Two-view SfM: match -> RANSAC essential -> pose -> triangulate -> BA.

Port of `siftgpu_tpu/pipeline/twoview.py` (BASELINE config 4: the minimum
incremental-SfM slice on one device).  Everything downstream of extraction
is fixed-shape: the match buffer defines the (padded) point set and validity
flows through weights, so nothing waits on the host between the stages.
The RANSAC draws come from a `torch.Generator` on the images' device; pass
`samples` to `two_view_from_features` to score given draws instead.
`two_view_reconstruct_jit` is the reference's jitted `two_view_reconstruct`:
captured once per signature on CUDA inputs (`core/graphs.py`; the
generator is state, registered with the graph, not part of the signature).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import MatchConfig, SiftConfig
from ..core.graphs import graphed
from ..frontend.extract import Features, extract_features
from ..frontend.match import MatchResult, match_descriptors
from ..geometry import epipolar, pose
from ..optim import ba

__all__ = ["TwoViewResult", "two_view_from_features", "two_view_reconstruct",
           "two_view_reconstruct_jit"]


class TwoViewResult(NamedTuple):
    R: torch.Tensor           # [3, 3] cam0 -> cam1
    t: torch.Tensor           # [3] baseline (unit norm before BA)
    points: torch.Tensor      # [max_match, 3] triangulated (cam0 frame), padded
    point_mask: torch.Tensor  # [max_match] bool
    pairs: torch.Tensor       # [max_match, 2] matched keypoint indices
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    ba_state: ba.BAState
    rms: torch.Tensor         # post-BA RMS reprojection error (pixels, valid obs)


def _normalized(xy: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    return (xy - intr[2:]) / intr[:2]


def two_view_from_features(
    feats: Features, match_res: MatchResult, intr: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 512, sampson_px: float = 2.0,
    ba_iters: int = 10, n_cg: int = 30, samples: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """feats: Features with batch 2 (image 0 and 1); match_res: one pair's
    MatchResult; intr: [4] fx fy cx cy f32 on their device.  The minimal
    sets are drawn from `generator`, or taken from `samples`
    [num_hypotheses, 8] when given."""
    pairs = match_res.pairs                       # [Q, 2], -1 padded
    Q = pairs.shape[0]
    dev = pairs.device
    valid = pairs[:, 0] >= 0
    i0 = torch.clamp(pairs[:, 0], min=0).long()
    i1 = torch.clamp(pairs[:, 1], min=0).long()
    uv0 = torch.stack([feats.x[0][i0], feats.y[0][i0]], dim=1)
    uv1 = torch.stack([feats.x[1][i1], feats.y[1][i1]], dim=1)
    x0, x1 = _normalized(uv0, intr), _normalized(uv1, intr)

    # threshold in normalized coords: (px / f)^2 on squared Sampson distance
    f_mean = (intr[0] + intr[1]) / 2.0
    thr = (torch.full_like(f_mean, sampson_px) / f_mean) ** 2
    if samples is None:
        samples = epipolar.sample_minimal_sets(valid, num_hypotheses, generator)
    rr = epipolar.ransac_from_samples(x0, x1, valid, samples, thr)
    tv = pose.recover_pose(rr.E, x0, x1, rr.inliers)

    w = tv.good.to(torch.float32)
    cams = torch.zeros((2, 6), dtype=torch.float32, device=dev)
    cams[1, :3] = pose.log_so3(tv.R)
    cams[1, 3:] = tv.t
    cam_idx = torch.cat([torch.zeros(Q, dtype=torch.int32, device=dev),
                         torch.ones(Q, dtype=torch.int32, device=dev)])
    pt_idx = torch.arange(Q, dtype=torch.int32, device=dev).repeat(2)
    ww = torch.cat([w, w])
    prob = ba.BAProblem(cams=cams, points=tv.points.to(torch.float32), intrinsics=intr,
                        cam_idx=cam_idx, pt_idx=pt_idx, uv=torch.cat([uv0, uv1]), w=ww)
    state = ba.run_ba(prob, ba_iters, n_cg)

    r = ba.reprojection_residuals(prob, state.cams, state.points)
    rms = torch.sqrt((r * r).sum() / torch.clamp(ww.sum(), min=1.0))
    return TwoViewResult(
        R=pose.exp_so3(state.cams[1, :3]), t=state.cams[1, 3:], points=state.points,
        point_mask=tv.good, pairs=pairs, num_matches=match_res.count,
        num_inliers=rr.num_inliers, ba_state=state, rms=rms,
    )


def two_view_reconstruct(images: torch.Tensor, intr: torch.Tensor, cfg: SiftConfig,
                         mcfg: MatchConfig, generator: torch.Generator) -> TwoViewResult:
    """images: [2, H, W] grayscale in [0, 1]; intr [4] and `generator` on
    the images' device.  The whole config-4 pipeline: extract, match, then
    `two_view_from_features`."""
    feats = extract_features(images, cfg)
    res = match_descriptors(feats.desc[0], feats.desc[1], feats.mask[0], feats.mask[1], mcfg)
    return two_view_from_features(feats, res, intr, generator)


two_view_reconstruct_jit = graphed(two_view_reconstruct, "two_view_reconstruct_jit")
