"""Per-stage timing table (SiftGPU's `-v 2..4` ClockTimer table).

Port of `siftgpu_tpu/pipeline/profile.py` on its accelerator branch: the
port runs the fused orientation + descriptor route on every device, so the
table always has one `orient+desc` stage where the reference's CPU run has
`orient` and `describe`.  `detect` includes the prefilter that
`extract_features` applies to response-ranked truncation.

The reference jits each stage afresh for every call of
`profile_extraction`, so its table times compiled stages.  Here each stage
(`STAGES`, plain functions of their inputs and configs) is an entry point
made for the call (`core.graphs.graphed`), all of one `GraphFamily` that
is released when the call returns: on CUDA inputs the stage's warm-up call
captures it and the timed calls replay it (input copies and output clones
included); on CPU inputs the stages run as they are.  `time_stages` is the
protocol over any such set of stages: each stage runs once to warm up,
then `iters` times on the host clock, and the device is synchronised once
at the end of the stage's calls, so a stage's time includes its launches
and its kernels but not the other stages'.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..core import graphs
from ..core.config import MatchConfig, SiftConfig
from ..frontend import detect, extract, fused, match, orient, pyramid

__all__ = ["STAGES", "profile_extraction", "time_stages", "format_stage_table"]


def pyramid_stage(images, cfg: SiftConfig):
    return pyramid.build_pyramid(images, cfg)


def detect_stage(pyr, cfg: SiftConfig):
    kps = detect.detect_pyramid(pyr, cfg)
    return extract.prefilter_candidates(kps, cfg) if cfg.truncate_method == 0 else kps


def gradients_stage(pyr, cfg: SiftConfig):
    return [orient.gradient_stack(oc.gauss, cfg) for oc in pyr]


def orient_desc_stage(grads, kps, cfg: SiftConfig):
    return [fused.orient_describe_fused(g, kp, cfg) for g, kp in zip(grads, kps)]


def assemble_stage(kps, fouts, cfg: SiftConfig):
    n = cfg.max_orientations
    parts = []
    for o, (kp, (theta, valid, desc)) in enumerate(zip(kps, fouts)):
        B, cap = kp.y.shape

        def dup(a):
            return a[..., None].expand(*a.shape, n).reshape(B, cap * n)

        cand = dict(y=dup(kp.y), x=dup(kp.x), sigma=dup(kp.sigma), theta=theta,
                    response=dup(kp.response), mask=valid, desc=desc)
        parts.append(extract.to_image_coords(cand, cfg, o))
    return extract.assemble_features(parts, cfg)


def match_stage(feats, mcfg: MatchConfig):
    return match.match_descriptors(feats.desc[0], feats.desc[1], feats.mask[0], feats.mask[1],
                                   mcfg)


# name -> the plain stage, in the table's order
STAGES: Dict[str, Callable] = {
    "pyramid": pyramid_stage, "detect": detect_stage, "gradients": gradients_stage,
    "orient+desc": orient_desc_stage, "assemble": assemble_stage, "match": match_stage,
}


def time_stages(stages: Dict[str, Callable], images: torch.Tensor, cfg: SiftConfig,
                iters: int = 20, match_pairs: bool = True,
                mcfg: Optional[MatchConfig] = None) -> Dict[str, float]:
    """The table's protocol over `stages` (the keys of `STAGES`, each a
    function with its plain stage's arguments): {stage: seconds per call},
    then TOTAL.  `match` runs when `match_pairs` and B >= 2."""
    mcfg = mcfg or MatchConfig(max_sift=cfg.max_keypoints, max_match=cfg.max_keypoints)
    sync = torch.cuda.synchronize if images.device.type == "cuda" else (lambda: None)

    def timeit(fn, *args):
        out = fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync()
        return (time.perf_counter() - t0) / iters, out

    times: Dict[str, float] = {}
    times["pyramid"], pyr = timeit(stages["pyramid"], images, cfg)
    times["detect"], kps = timeit(stages["detect"], pyr, cfg)
    times["gradients"], grads = timeit(stages["gradients"], pyr, cfg)
    times["orient+desc"], fouts = timeit(stages["orient+desc"], grads, kps, cfg)
    times["assemble"], feats = timeit(stages["assemble"], kps, fouts, cfg)
    if match_pairs and images.shape[0] >= 2:
        times["match"], _ = timeit(stages["match"], feats, mcfg)
    times["TOTAL"] = sum(times.values())
    return times


def profile_extraction(
    images: torch.Tensor, cfg: SiftConfig, iters: int = 20, match_pairs: bool = True,
    mcfg: Optional[MatchConfig] = None,
) -> Dict[str, float]:
    """images [B, H, W] on the CPU or a CUDA device.  Returns {stage:
    seconds per call} for pyramid / detect / gradients / orient+desc /
    assemble, then match (when `match_pairs` and B >= 2) and TOTAL; on a
    CUDA device each a replay of the stage captured for this call."""
    family = graphs.GraphFamily("profile_extraction")
    stages = {name: graphs.graphed(fn, f"profile_extraction {name}", family)
              for name, fn in STAGES.items()}
    try:
        return time_stages(stages, images, cfg, iters, match_pairs, mcfg)
    finally:
        family.release()


def format_stage_table(times: Dict[str, float], batch: int = 1) -> str:
    lines = [f"{'stage':<10} {'ms/iter':>10} {'ms/frame':>10}"]
    for k, v in times.items():
        lines.append(f"{k:<10} {v * 1e3:>10.2f} {v * 1e3 / batch:>10.2f}")
    return "\n".join(lines)
