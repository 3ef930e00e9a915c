"""`orient_sample_kernel`'s share of its roofline over the profiled calls:
the frozen `orient_sample_work` of each octave of each call, counted from
what the call's outputs need: the distinct keypoints kept in the octave
(all of them live) and their orientation slots (each one sampled)."""

import torch

from benchmark.metrics import _frames
from benchmark.roofline.orient_sample_work import orient_sample_work


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    p = _frames.params(run)
    win = 2 * p.orient_window_radius + 1
    nb, nori, G2 = p.orientation_bins, p.max_orientations, p.descriptor_grid ** 2
    S, B = p.dog_levels, run.loop.batch
    works = []
    for _, out in t.outputs:
        feats = out.feats
        for o, H, W in _frames.octaves(run):
            kept = feats.mask & (feats.octave == o)
            slots = int(kept.sum())
            points = 0
            for b in range(feats.mask.shape[0]):
                xy = torch.stack([feats.x[b][kept[b]], feats.y[b][kept[b]]], dim=1)
                points += int(torch.unique(xy, dim=0).shape[0]) if xy.numel() else 0
            works.append(orient_sample_work(B * S, max(H, win), max(W, win), points, points,
                                            slots, win, nb, nori, G2))
    return _frames.share(run, "orient_sample_kernel", works)
