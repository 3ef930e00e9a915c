"""A block of uint8 descriptor sets matched exhaustively: `sets` sets of
the configuration's K rows (`inputs.descriptor_sets`: neighbours share
`neighbour_overlap` of their rows, `noise_share` of each observation's
bytes move by up to `noise_max`), every unordered pair of them,
`pairs_per_call` pairs a `match_batch` call, the calls cycled.  Every
entry of a kept call's MatchResult is compared with the reference's."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark.lib import compare, inputs
from benchmark.reference import match as ref_match

ENTRIES = {
    "MatchConfig": "siftgpu_tpu_torch:MatchConfig",
    "match_batch": "siftgpu_tpu_torch.frontend.match:match_descriptors_batch_jit",
}


class Loop:
    batch = 0

    def __init__(self, traffic: dict, config: dict, entries, device, seed: int):
        self.traffic, self.config, self.entries = traffic, config, entries
        self.device = torch.device(device)
        self.seed = int(seed)
        self.mcfg = entries.MatchConfig(**config["match"])
        self.pairs_per_call = int(traffic["pairs_per_call"])

    def setup(self) -> None:
        t, K = self.traffic, self.config["sift"]["max_keypoints"]
        g = inputs.generator(self.device, self.seed)
        self.sets = inputs.descriptor_sets(t["sets"], K, t["neighbour_overlap"], t["noise_share"],
                                           t["noise_max"], g, self.device)
        pairs, P = inputs.all_pairs(t["sets"]), self.pairs_per_call
        if len(pairs) % P:
            raise ValueError(f"{len(pairs)} pairs do not split into calls of {P}")
        self.call_pairs = [pairs[i:i + P] for i in range(0, len(pairs), P)]
        self.d0 = [self.sets[[a for a, _ in c]] for c in self.call_pairs]
        self.d1 = [self.sets[[b for _, b in c]] for c in self.call_pairs]
        self.m = torch.ones((P, K), dtype=torch.bool, device=self.device)

    def step(self, i: int):
        c = i % len(self.call_pairs)
        return self.entries.match_batch(self.d0[c], self.d1[c], self.m, self.m, self.mcfg)

    def work(self, out) -> tuple:
        return 0, self.pairs_per_call

    def check(self, kept, precision: dict) -> dict:
        differing = 0
        m = torch.ones(self.sets.shape[1], dtype=torch.bool, device=self.device)
        for i, res in kept:
            refs = [ref_match.match_pair(self.sets[a], self.sets[b], m, m, self.config["match"],
                                         precision["match"])
                    for a, b in self.call_pairs[i % len(self.call_pairs)]]
            differing += compare.match_sets_differing(res, refs)
        return {"match_entries_differing": float(differing)}


def control(precision: dict) -> SimpleNamespace:
    """The reference under ENTRIES' names, in the precisions given."""
    return SimpleNamespace(
        MatchConfig=lambda **kw: dict(kw),
        match_batch=lambda d0, d1, m0, m1, cfg: ref_match.match_batch(d0, d1, m0, m1, cfg,
                                                                      precision["match"]))
