"""The port's pose graph (`optim/pose_graph.py`) and trajectory alignment
(`geometry/align.py`) against the reference.

The graphs of tests/test_pose_graph.py are built once by the reference and
copied into the port.  SE(3) dense, Sim(3) dense and Sim(3) PCG give poses
within 1e-4 of the reference's (f32 GN over 10-12 iterations; both take
their Jacobians by forward-mode autodiff through the same maps, so they
differ only in rounding) and costs within 1e-4 relative (or 1e-9 absolute
once converged).  The port also meets test_pose_graph.py's own asserts.
`umeyama` / `ate_rmse` are NumPy copies: bit-equal; `camera_centers`
within 1e-6.  The reference's distributed-parity cases are
tests/test_torch_dist_pose_graph.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.geometry import align as jalign
from siftgpu_tpu.optim import pose_graph as jpg
from siftgpu_tpu_torch.geometry import align
from siftgpu_tpu_torch.geometry import pose as P
from siftgpu_tpu_torch.optim import pose_graph as pg

from test_pose_graph import _circle_graph, _long_chain_graph, _sim3_circle_graph
from torch_threads import one_thread  # noqa: F401 (autouse)


def _to_torch(g, cls):
    return cls(*(torch.from_numpy(np.array(x)) for x in g))


def _close_costs(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= 1e-4 * np.abs(b) + 1e-9), (a, b)


@pytest.fixture(scope="module")
def circle():
    g, _ = _circle_graph()
    return g, jpg.optimize_pose_graph(g, iters=10)


@pytest.fixture(scope="module")
def sim3_circle():
    g, gt7 = _sim3_circle_graph()
    return g, gt7, jpg.optimize_pose_graph_sim3(g, iters=12)


def test_se3_dense_matches_reference(circle):
    g, (ref, ref_costs) = circle
    out, costs = pg.optimize_pose_graph(_to_torch(g, pg.PoseGraph), iters=10)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    _close_costs(costs.numpy(), ref_costs)
    assert float(costs[-1]) < float(costs[0])
    np.testing.assert_allclose(out.poses[0].numpy(), np.asarray(g.poses[0]), atol=1e-7)


def test_se3_zero_weight_edge_ignored():
    g, _ = _circle_graph(seed=3)
    g2 = g._replace(
        edge_i=jnp.concatenate([g.edge_i, jnp.asarray([0], jnp.int32)]),
        edge_j=jnp.concatenate([g.edge_j, jnp.asarray([5], jnp.int32)]),
        t_meas=jnp.concatenate([g.t_meas, jnp.full((1, 6), 9.0, jnp.float32)]),
        weight=jnp.concatenate([g.weight, jnp.zeros(1, jnp.float32)]),
    )
    out1, _ = pg.optimize_pose_graph(_to_torch(g, pg.PoseGraph), iters=5)
    out2, _ = pg.optimize_pose_graph(_to_torch(g2, pg.PoseGraph), iters=5)
    np.testing.assert_allclose(out2.poses.numpy(), out1.poses.numpy(), atol=1e-5)
    ref, _ = jpg.optimize_pose_graph(g2, iters=5)
    np.testing.assert_allclose(out2.poses.numpy(), np.asarray(ref.poses), atol=1e-4)


def test_sim3_dense_matches_reference(sim3_circle):
    g, gt7, (ref, ref_costs) = sim3_circle
    out, costs = pg.optimize_pose_graph_sim3(_to_torch(g, pg.Sim3PoseGraph), iters=12)
    got = out.poses.numpy()
    np.testing.assert_allclose(got, np.asarray(ref.poses), atol=1e-4)
    _close_costs(costs.numpy(), ref_costs)
    # tests/test_pose_graph.py's bounds
    assert float(costs[-1]) < 1e-6 * float(costs[0])
    np.testing.assert_allclose(np.exp(got[:, 6]), np.exp(gt7[:, 6]), rtol=2e-3)
    np.testing.assert_allclose(got[:, 3:6], gt7[:, 3:6], atol=5e-3)


def test_sim3_dense_n_fix_freezes_nodes(sim3_circle):
    g = _to_torch(sim3_circle[0], pg.Sim3PoseGraph)
    out, _ = pg.optimize_pose_graph_sim3(g, iters=6, n_fix=4)
    ref, _ = jpg.optimize_pose_graph_sim3(sim3_circle[0], iters=6, n_fix=4)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    np.testing.assert_allclose(out.poses[:4].numpy(), g.poses[:4].numpy(), atol=1e-6)


def test_sim3_cg_matches_reference_and_dense(sim3_circle):
    g, gt7, (dense, _) = sim3_circle
    ref, ref_costs = jpg.optimize_pose_graph_sim3_cg(g, iters=12, n_cg=80)
    out, costs = pg.optimize_pose_graph_sim3_cg(_to_torch(g, pg.Sim3PoseGraph), iters=12,
                                                n_cg=80)
    got = out.poses.numpy()
    np.testing.assert_allclose(got, np.asarray(ref.poses), atol=1e-4)
    _close_costs(costs.numpy(), ref_costs)
    assert float(costs[-1]) < 1e-6 * float(costs[0])
    np.testing.assert_allclose(got, np.asarray(dense.poses), atol=5e-4)
    np.testing.assert_allclose(np.exp(got[:, 6]), np.exp(gt7[:, 6]), rtol=2e-3)


def test_sim3_cg_long_chain_matches_reference():
    """A 120-node chain (the reference's distributed-parity graph) through
    the PCG solver, n_fix = 1 and an online-style n_fix = 100."""
    g, _ = _long_chain_graph(M=120, n_loop=8)
    for n_fix in (1, 100):
        ref, ref_costs = jpg.optimize_pose_graph_sim3_cg(g, iters=6, n_cg=60, n_fix=n_fix)
        out, costs = pg.optimize_pose_graph_sim3_cg(_to_torch(g, pg.Sim3PoseGraph), iters=6,
                                                    n_cg=60, n_fix=n_fix)
        np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
        _close_costs(costs.numpy(), ref_costs)
        assert np.isfinite(out.poses.numpy()).all()


def test_sim3_matches_se3_when_scales_trivial():
    """tests/test_pose_graph.py's case on the port: unit scales and
    se3-consistent edges give the SE(3) solution."""
    g6, _ = _circle_graph(seed=5)
    g6 = _to_torch(g6, pg.PoseGraph)
    R, t = P.exp_se3(g6.poses)
    Rm, tm = P.exp_se3(g6.t_meas)
    g7 = pg.Sim3PoseGraph(
        poses=pg.srt_to_sim7(torch.ones(R.shape[0]), R, t), edge_i=g6.edge_i,
        edge_j=g6.edge_j, t_meas=pg.srt_to_sim7(torch.ones(Rm.shape[0]), Rm, tm),
        weight=g6.weight)
    out6, _ = pg.optimize_pose_graph(g6, iters=10)
    out7, _ = pg.optimize_pose_graph_sim3(g7, iters=10)
    s7, _, t7 = pg.sim7_to_srt(out7.poses)
    np.testing.assert_allclose(s7.numpy(), 1.0, atol=2e-2)
    np.testing.assert_allclose(t7.numpy(), P.exp_se3(out6.poses)[1].numpy(), atol=5e-2)


def test_srt_sim7_round_trip():
    rng = np.random.default_rng(4)
    v = rng.normal(0, 0.6, (16, 7)).astype(np.float32)
    got = pg.srt_to_sim7(*pg.sim7_to_srt(torch.from_numpy(v))).numpy()
    np.testing.assert_allclose(got, v, atol=1e-5)
    ref = np.asarray(jpg.srt_to_sim7(*jpg.sim7_to_srt(jnp.asarray(v))))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_align_matches_reference():
    rng = np.random.default_rng(6)
    poses = rng.normal(0, 0.5, (20, 6)).astype(np.float32)
    c = align.camera_centers(poses)
    np.testing.assert_allclose(c, jalign.camera_centers(poses), atol=1e-6)
    np.testing.assert_allclose(align.camera_centers(torch.from_numpy(poses)), c, atol=0)
    gt = c * 1.7 + rng.normal(0, 0.01, c.shape)
    a, b = align.umeyama(c, gt), jalign.umeyama(c, gt)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    ra, ea = align.ate_rmse(c, gt)
    rb, eb = jalign.ate_rmse(c, gt)
    assert ra == rb
    np.testing.assert_array_equal(ea, eb)
    assert ra < 0.05
