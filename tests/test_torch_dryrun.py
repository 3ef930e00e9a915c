"""The port's multi-rank dry run (`parallel/dryrun.py::run_dryrun`) in 2
gloo ranks on the CPU: every leg of `parallel/` runs, the config-5 run's
Sim(3)-aligned ATE stays under its own bound (10% of the span) on both
ranks, and the ranks agree on every summary (replicated results)."""

import numpy as np
import pytest
import torch

from siftgpu_tpu_torch.parallel import dryrun


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_two_ranks():
    ranks = dryrun.run_dryrun(2, device="cpu", timeout=300, threads=1)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["ate"] < 0.1 * r["span"] and len(r["keyframes"]) >= 2
        assert np.isfinite(r["ba_cost"]) and r["pg_poses_finite"]
    # the one pair of ranks: its row-slab extraction of frames 0-1 (64x80
    # noise, a few keypoints each) keeps the data-parallel extraction's counts
    assert ranks[0]["spatial_count"] == ranks[0]["dp_count"][:2]
    for key in ("dp_count", "spatial_count", "match_count", "ba_cost", "keyframes", "ate"):
        assert ranks[0][key] == ranks[1][key], key
