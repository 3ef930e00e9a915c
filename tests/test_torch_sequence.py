"""The port's config-5 pipeline (`parallel/sequence.py::run_slam_distributed`)
in 2 gloo ranks on the CPU, on tests/test_multiprocess.py:24-47's scene (T
= 8, 96x128, K = 256).

- Both ranks return the same bits (trajectory, map, keyframes).
- The same keyframes as the port's one-process `run_slam` plus the final
  pose-graph pass, the trajectory within 1e-3 (the reference's own
  cross-process bound, tests/test_multiprocess.py:127-132).
- Sim(3) ATE below 10% of the span (tests/test_multiprocess.py:118).
- `resident_map=False` (the window re-partitioned per solve) agrees with
  the resident run within 5e-3, its points within 5e-2
  (tests/test_resident_ba.py:32-37).
- Rank 0's metric event kinds, in order, equal the reference's
  `run_slam_distributed` on a 2-device mesh; rank 1 writes its own
  `.h1` file.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_worker as worker
from siftgpu_tpu.parallel import sequence as jsequence
from siftgpu_tpu.pipeline import metrics as jmetrics
from siftgpu_tpu_torch.geometry import align
from siftgpu_tpu_torch.parallel import comm, sequence
from siftgpu_tpu_torch.pipeline import slam

from test_multiprocess import slam_scene_and_configs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank results of the resident run and the re-partitioning run (one
    spawn), and the metrics path of the resident run."""
    path = str(tmp_path_factory.mktemp("seq") / "m.jsonl")
    ranks = comm.spawn(worker.run_slam_variants, 2, "gloo", "cpu",
                       [dict(resident_map=True), dict(resident_map=False)], path, timeout=180,
                       threads=1)
    return ranks, path


def test_ranks_bit_identical(runs):
    (a, b), _ = runs
    for ra, rb in zip(a, b):
        assert ra["keyframe_indices"] == rb["keyframe_indices"]
        for k in ("trajectory", "map_points", "map_mask"):
            assert np.array_equal(ra[k], rb[k]), k


def test_matches_one_process_and_ground_truth(runs):
    res, _ = runs[0][0]
    frames, gt, intr, cfg, mcfg, scfg = worker.scene()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = slam.run_slam(frames, intr, cfg, mcfg, scfg, device="cpu")
        one = sequence._pose_graph_refine(one, None, intr=intr, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert res["keyframe_indices"] == list(one.keyframe_indices)
    assert len(res["keyframe_indices"]) >= 2
    err = np.abs(res["trajectory"] - one.trajectory).max()
    assert err < 1e-3, err
    est_c, gt_c = align.camera_centers(res["trajectory"]), align.camera_centers(gt)
    ate, _ = align.ate_rmse(est_c, gt_c, with_scale=True)
    span = np.linalg.norm(gt_c[-1] - gt_c[0])
    assert ate < 0.1 * span, (ate, span)


def test_repartitioning_path_agrees(runs):
    res, rep = runs[0][0]
    assert res["keyframe_indices"] == rep["keyframe_indices"]
    err = np.abs(res["trajectory"] - rep["trajectory"]).max()
    assert err < 5e-3, err
    m = res["map_mask"] & rep["map_mask"]
    perr = np.abs(res["map_points"][m] - rep["map_points"][m]).max()
    assert perr < 5e-2, perr


def test_metric_event_kinds_match_reference(runs, tmp_path):
    _, path = runs
    frames, _, intr, cfg, mcfg, scfg = slam_scene_and_configs()
    jpath = str(tmp_path / "ref.jsonl")
    with jmetrics.MetricsLogger(jpath) as m:
        jsequence.run_slam_distributed(frames, intr, cfg, mcfg, scfg,
                                       Mesh(np.array(jax.devices()[:2]), axis_names=("data",)),
                                       data_axis="data", metrics=m)
    kinds = lambda p: [json.loads(ln)["event"] for ln in open(p)]
    port = kinds(path)
    assert port == kinds(jpath)
    assert {"sequence_start", "extract_chunk", "ba_window", "sequence_done"} <= set(port)
    assert kinds(path + ".h1") == port
