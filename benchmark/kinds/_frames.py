"""What the frame kinds share: a ring of frames made in set-up, `extract`
of `extract_per_call` consecutive frames a call, and then, by the mix's
`match`: "consecutive" (the call's frames matched pair by pair in one
`match_batch` call), "previous" (the call's frame matched with the
previous call's by `match`) or "none".  A frame kind subclasses
`FrameLoop` with `make_frames`."""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from benchmark.lib import compare, inputs
from benchmark.reference import match as ref_match
from benchmark.reference import sift as ref_sift

ENTRIES = {
    "SiftConfig": "siftgpu_tpu_torch:SiftConfig",
    "MatchConfig": "siftgpu_tpu_torch:MatchConfig",
    "extract": "siftgpu_tpu_torch:extract_features_jit",
    "match": "siftgpu_tpu_torch.frontend.match:match_descriptors_jit",
    "match_batch": "siftgpu_tpu_torch.frontend.match:match_descriptors_batch_jit",
}
MODES = ("consecutive", "previous", "none")


class FrameOut(NamedTuple):
    feats: object               # the call's Features
    matches: Optional[object]   # its MatchResult, or None
    prev: Optional[object]      # for "previous": the Features it matched with


class FrameLoop:
    def __init__(self, traffic: dict, config: dict, entries, device, seed: int):
        self.traffic, self.config, self.entries = traffic, config, entries
        self.device = torch.device(device)
        self.seed = int(seed)
        self.scfg = entries.SiftConfig(**config["sift"])
        self.mcfg = entries.MatchConfig(**config["match"])
        self.mode = traffic["match"]
        if self.mode not in MODES:
            raise ValueError(f"frames are matched {MODES}, not {self.mode!r}")
        self.batch = int(traffic["extract_per_call"])
        self.pairs_per_call = {"consecutive": self.batch - 1, "previous": 1, "none": 0}[self.mode]
        self.prev = None

    def make_frames(self, g, H: int, W: int) -> torch.Tensor:
        raise NotImplementedError

    def setup(self) -> None:
        cfg = self.config["sift"]
        g = inputs.generator(self.device, self.seed)
        self.frames = self.make_frames(g, cfg["height"], cfg["width"])
        if self.frames.shape[0] % self.batch:
            raise ValueError(f"a ring of {self.frames.shape[0]} frames does not split into "
                             f"calls of {self.batch}")

    def frame_indices(self, i: int):
        R = self.frames.shape[0]
        return [(i * self.batch + k) % R for k in range(self.batch)]

    def step(self, i: int) -> FrameOut:
        e = self.entries
        lo = (i * self.batch) % self.frames.shape[0]
        feats = e.extract(self.frames[lo:lo + self.batch], self.scfg)
        res, prev = None, self.prev
        if self.mode == "consecutive":
            res = e.match_batch(feats.desc[:-1], feats.desc[1:], feats.mask[:-1], feats.mask[1:],
                                self.mcfg)
        elif self.mode == "previous":
            if prev is not None:
                res = e.match(prev.desc[-1], feats.desc[0], prev.mask[-1], feats.mask[0],
                              self.mcfg)
            self.prev = feats
        return FrameOut(feats, res, prev)

    def work(self, out: FrameOut) -> tuple:
        return self.batch, (self.pairs_per_call if out.matches is not None else 0)

    def check(self, kept, precision: dict) -> dict:
        """kept: [(call index, FrameOut)]; every frame's keypoints and every
        pair's matches against the reference's."""
        mcfg = self.config["match"]
        params = ref_sift.SiftParams(**self.config["sift"])
        tally = compare.FrameTally()
        for i, out in kept:
            ref = ref_sift.extract(self.frames[self.frame_indices(i)], params, precision["extract"])
            for b in range(self.batch):
                tally.frame((i, b), out.feats, b, ref, b)
            if self.mode == "consecutive":
                for q in range(self.batch - 1):
                    rm = ref_match.match_pair(ref.desc[q], ref.desc[q + 1], ref.mask[q],
                                              ref.mask[q + 1], mcfg, precision["match"])
                    tally.matches((i, q), (i, q + 1), out.matches.pairs[q], out.matches.count[q],
                                  rm.pairs, rm.count)
            elif self.mode == "previous" and out.matches is not None:
                j = self.frame_indices(i - 1)[-1]
                rprev = ref_sift.extract(self.frames[[j]], params, precision["extract"])
                tally.frame((i, "prev"), out.prev, out.prev.mask.shape[0] - 1, rprev, 0)
                rm = ref_match.match_pair(rprev.desc[0], ref.desc[0], rprev.mask[0], ref.mask[0],
                                          mcfg, precision["match"])
                tally.matches((i, "prev"), (i, 0), out.matches.pairs, out.matches.count,
                              rm.pairs, rm.count)
            del ref
        return tally.numbers(with_matches=self.mode != "none")


def control(precision: dict) -> SimpleNamespace:
    """The reference under ENTRIES' names, in the precisions given."""
    return SimpleNamespace(
        SiftConfig=lambda **kw: ref_sift.SiftParams(**kw),
        MatchConfig=lambda **kw: dict(kw),
        extract=lambda frames, cfg: ref_sift.extract(frames, cfg, precision["extract"]),
        match=lambda d0, d1, m0, m1, cfg: ref_match.match_pair(d0, d1, m0, m1, cfg,
                                                               precision["match"]),
        match_batch=lambda d0, d1, m0, m1, cfg: ref_match.match_batch(d0, d1, m0, m1, cfg,
                                                                      precision["match"]),
    )
