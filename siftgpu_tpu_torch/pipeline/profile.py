"""Per-stage timing table (SiftGPU's `-v 2..4` ClockTimer table).

Port of `siftgpu_tpu/pipeline/profile.py` on its accelerator branch: the
port runs the fused orientation + descriptor route on every device, so the
table always has one `orient+desc` stage where the reference's CPU run has
`orient` and `describe`.  Each stage runs once to warm up, then `iters`
times on the host clock, and the device is synchronised once at the end of
the stage's calls, so a stage's time includes its launches and its kernels
but not the other stages'.  `detect` includes the prefilter that
`extract_features` applies to response-ranked truncation.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..core.config import MatchConfig, SiftConfig
from ..frontend import detect, extract, fused, match, orient, pyramid

__all__ = ["profile_extraction", "format_stage_table"]


def profile_extraction(
    images: torch.Tensor, cfg: SiftConfig, iters: int = 20, match_pairs: bool = True,
    mcfg: Optional[MatchConfig] = None,
) -> Dict[str, float]:
    """images [B, H, W] on the CPU or a CUDA device.  Returns {stage:
    seconds per call} for pyramid / detect / gradients / orient+desc /
    assemble, then match (when `match_pairs` and B >= 2) and TOTAL."""
    B = images.shape[0]
    mcfg = mcfg or MatchConfig(max_sift=cfg.max_keypoints, max_match=cfg.max_keypoints)
    sync = torch.cuda.synchronize if images.device.type == "cuda" else (lambda: None)
    n = cfg.max_orientations

    def timeit(fn, *args):
        out = fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync()
        return (time.perf_counter() - t0) / iters, out

    def detect_fn(pyr):
        kps = detect.detect_pyramid(pyr, cfg)
        return extract.prefilter_candidates(kps, cfg) if cfg.truncate_method == 0 else kps

    def grad_fn(pyr):
        return [orient.gradient_stack(oc.gauss, cfg) for oc in pyr]

    def fused_fn(grads, kps):
        return [fused.orient_describe_fused(g, kp, cfg) for g, kp in zip(grads, kps)]

    def assemble_fn(kps, fouts):
        parts = []
        for o, (kp, (theta, valid, desc)) in enumerate(zip(kps, fouts)):
            cap = kp.y.shape[1]

            def dup(a):
                return a[..., None].expand(*a.shape, n).reshape(B, cap * n)

            cand = dict(y=dup(kp.y), x=dup(kp.x), sigma=dup(kp.sigma), theta=theta,
                        response=dup(kp.response), mask=valid, desc=desc)
            parts.append(extract.to_image_coords(cand, cfg, o))
        return extract.assemble_features(parts, cfg)

    times: Dict[str, float] = {}
    times["pyramid"], pyr = timeit(pyramid.build_pyramid, images, cfg)
    times["detect"], kps = timeit(detect_fn, pyr)
    times["gradients"], grads = timeit(grad_fn, pyr)
    times["orient+desc"], fouts = timeit(fused_fn, grads, kps)
    times["assemble"], feats = timeit(assemble_fn, kps, fouts)
    if match_pairs and B >= 2:
        times["match"], _ = timeit(match.match_descriptors, feats.desc[0], feats.desc[1],
                                   feats.mask[0], feats.mask[1], mcfg)
    times["TOTAL"] = sum(times.values())
    return times


def format_stage_table(times: Dict[str, float], batch: int = 1) -> str:
    lines = [f"{'stage':<10} {'ms/iter':>10} {'ms/frame':>10}"]
    for k, v in times.items():
        lines.append(f"{k:<10} {v * 1e3:>10.2f} {v * 1e3 / batch:>10.2f}")
    return "\n".join(lines)
