"""The port's multi-rank dry run (`parallel/dryrun.py::run_dryrun`) in 2
and 4 gloo ranks on the CPU: every leg of `parallel/` runs, the config-5
run's Sim(3)-aligned ATE stays under its own bound (10% of the span) on
every rank, and the ranks agree on every summary (replicated results).  At
4 ranks the summaries are held to the reference's `run_dryrun(4)` on 4 of
conftest's 8 CPU devices: its steps' results are recorded from the
reference's own calls as it makes them."""

import numpy as np
import pytest

from siftgpu_tpu_torch.parallel import dryrun
from torch_threads import one_thread  # noqa: F401 (autouse)


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


@pytest.fixture(scope="module")
def four_ranks():
    return dryrun.run_dryrun(4, device="cpu", timeout=300, threads=1)


def test_dryrun_four_ranks(four_ranks):
    """Two data rows of two spatial pairs: every rank creates both pairs'
    groups in one order, each pair extracts frames 0-1 on its row slabs,
    and all four ranks agree on every summary."""
    ranks = four_ranks
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert len(ranks[0]["dp_count"]) == 4            # 2 frames a data row
    for r in ranks:
        assert r["ate"] < 0.1 * r["span"] and len(r["keyframes"]) >= 2
        assert np.isfinite(r["ba_cost"]) and r["pg_poses_finite"]
        assert r["spatial_count"] == r["dp_count"][:2]
        assert not any(r["launches"].values())          # the CPU runs the plain versions
        for key in ("dp_count", "spatial_count", "match_count", "ba_cost", "keyframes", "ate"):
            assert r[key] == ranks[0][key], (r["rank"], key)


def test_dryrun_four_ranks_matches_reference(four_ranks, monkeypatch):
    """The reference's `run_dryrun(4)` (a 2 x 2 data x spatial mesh), run
    live with its data-parallel extraction, row-slab extraction, match and
    config-5 run wrapped to record their results: the port's ranks have
    its keypoint counts per frame (data-parallel and row slabs), its match
    count and its config-5 keyframes."""
    import jax

    from siftgpu_tpu.parallel import dp as jdp
    from siftgpu_tpu.parallel import dryrun as jdryrun
    from siftgpu_tpu.parallel import sequence as jsequence
    from siftgpu_tpu.parallel import spatial as jspatial

    assert len(jax.devices()) >= 4
    seen = {}

    def record(module, name, key, summary):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(key, summary(out))    # the dry run's own call comes first
            return out

        monkeypatch.setattr(module, name, wrapped)

    count = lambda f: np.asarray(f.mask).sum(-1).tolist()
    record(jdp, "extract_features_dp", "dp_count", count)
    record(jspatial, "extract_features_spatial", "spatial_count", count)
    record(jdryrun, "match_descriptors", "match_count", lambda r: int(r.count))
    record(jsequence, "run_slam_distributed", "keyframes",
           lambda r: [int(i) for i in r.keyframe_indices])
    jdryrun.run_dryrun(4)
    assert set(seen) == {"dp_count", "spatial_count", "match_count", "keyframes"}
    for r in four_ranks:
        for key, want in seen.items():
            assert r[key] == want, (r["rank"], key, r[key], want)
