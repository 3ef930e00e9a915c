"""The port's distributed BA (`parallel/dist_ba.py`, `ba.run_ba(group=)`)
against the reference's (`siftgpu_tpu/parallel/dist_ba.py`) at n = 2.

- `partition_problem` gives the reference's arrays, array for array
  (zero-weight padding included), for 2 and 3 shards.
- `run_ba_distributed` in 2 gloo ranks on the CPU, on tests/test_ba.py's
  `_make_problem(n_cams=4, n_pts=64, seed=7)`, meets
  tests/test_parallel.py:66-88's bounds against both the port's
  one-process `run_ba` and the reference's `run_ba_distributed` on a
  2-device mesh: cost < 1e-4; rotations within 1e-3; translations within
  1e-3 and points within 5e-3 after the scale gauge (central projection
  with camera 0 frozen leaves the scene's scale free).  Both ranks return
  the same bits.
- `comm.spawn` raises when a rank fails (the others are stopped), and
  refuses NCCL ranks that would share a device: no fallback.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_worker as worker
from siftgpu_tpu.parallel import dist_ba as jdist_ba
from siftgpu_tpu_torch.convert import tree_to_torch
from siftgpu_tpu_torch.optim import ba
from siftgpu_tpu_torch.parallel import comm, dist_ba

from test_ba import _make_problem

ITERS, N_CG = 8, 25


def _pt_fixed(prob):
    """tests/test_ba.py's problem with a few fixed points (the windowed BA's
    retired anchors), so that the fixed blocks are partitioned too."""
    fixed = np.zeros(prob.points.shape[0], bool)
    fixed[[3, 40]] = True
    return prob._replace(pt_fixed=jax.numpy.asarray(fixed))


@pytest.mark.parametrize("n", [2, 3])
def test_partition_problem_matches_reference(n):
    prob = _pt_fixed(_make_problem(n_cams=4, n_pts=64, seed=7)[0])
    ref = jdist_ba.partition_problem(prob, n)
    out = dist_ba.partition_problem(tree_to_torch(prob, ba.BAProblem), n)
    for name, a, b in zip(ref._fields, ref, out):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def _gauge_close(cams, points, ref_cams, ref_points):
    np.testing.assert_allclose(cams[:, :3], ref_cams[:, :3], atol=1e-3)
    t_ref, t = ref_cams[1:, 3:].ravel(), cams[1:, 3:].ravel()
    s = float(t @ t_ref) / max(float(t @ t), 1e-12)
    np.testing.assert_allclose(t * s, t_ref, atol=1e-3)
    np.testing.assert_allclose(points * s, ref_points, atol=5e-3)


def test_run_ba_distributed_two_ranks():
    prob, _, _ = _make_problem(n_cams=4, n_pts=64, seed=7)
    n_pts = prob.points.shape[0]
    port = tree_to_torch(prob, ba.BAProblem)
    sprob = dist_ba.partition_problem(port, 2)
    (cams, pts, cost), other = comm.spawn(worker.run_ba_distributed, 2, "gloo", "cpu", sprob,
                                          ITERS, N_CG, timeout=120, threads=1)
    assert all(np.array_equal(a, b) for a, b in zip((cams, pts), other[:2])) and cost == other[2]
    pts = pts.reshape(-1, 3)[:n_pts]
    assert cost < 1e-4

    one = ba.run_ba(port, iters=ITERS, n_cg=N_CG)
    assert float(one.cost) < 1e-4
    _gauge_close(cams, pts, one.cams.numpy(), one.points.numpy())

    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("ba",))
    ref, _ = jdist_ba.run_ba_distributed(jdist_ba.partition_problem(prob, 2), mesh, axis="ba",
                                         iters=ITERS, n_cg=N_CG)
    assert float(ref.cost) < 1e-4
    _gauge_close(cams, pts, np.asarray(ref.cams),
                 np.asarray(ref.points).reshape(-1, 3)[:n_pts])


def test_spawn_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 failed"):
        comm.spawn(worker.fail_on_rank, 2, "gloo", "cpu", 1, timeout=60, threads=1)


@pytest.mark.parametrize("collective", [False, True], ids=["alone", "in_a_collective"])
def test_spawn_reports_a_dead_ranks_stack(collective):
    """A rank that dies of a signal raises nothing in Python: `spawn`
    reports its signal and the stacks its faulthandler wrote, down to the
    line that aborted, ahead of whatever its peers raised in the
    collective it left."""
    with pytest.raises(RuntimeError, match="^rank 1 died of signal SIGABRT") as err:
        comm.spawn(worker.abort_on_rank, 2, "gloo", "cpu", 1, collective, timeout=60, threads=1)
    assert "Fatal Python error: Aborted" in str(err.value)
    assert "in abort_on_rank" in str(err.value)


def test_spawn_refuses_nccl_ranks_sharing_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share"):
        comm.spawn(worker.fail_on_rank, 2, "nccl", "cuda", 0)
