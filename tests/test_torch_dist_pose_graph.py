"""The port's edge-sharded pose graphs (`parallel/dist_pose_graph.py`) in 2
gloo ranks on the CPU against the reference's distributed optimizers on a
2-device mesh and against the port's one-process optimizers.

SE(3) dense (tests/test_pose_graph.py's `_circle_graph(seed=11)`), Sim(3)
dense and Sim(3) PCG (`_sim3_circle_graph(seed=7)`), each with its last
edge dropped so that the edge count is odd and the weight-0 padding runs.
Bounds, tests/test_parallel.py:99-142's: poses within 1e-4, costs within
rtol 1e-4 and atol 1e-10 (the converged costs reach ~1e-13, where the
reduction order's noise dominates).  Both ranks return the same bits.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_worker as worker
from siftgpu_tpu.optim import pose_graph as jpg
from siftgpu_tpu.parallel import dist_pose_graph as jdpg
from siftgpu_tpu_torch.optim import pose_graph as pg
from siftgpu_tpu_torch.parallel import comm

from test_pose_graph import _circle_graph, _sim3_circle_graph

ITERS = 8
KINDS = {
    "se3": (lambda: _circle_graph(seed=11)[0], jdpg.optimize_pose_graph_distributed,
            pg.optimize_pose_graph),
    "sim3": (lambda: _sim3_circle_graph(seed=7)[0], jdpg.optimize_pose_graph_sim3_distributed,
             pg.optimize_pose_graph_sim3),
    "sim3_cg": (lambda: _sim3_circle_graph(seed=7)[0],
                jdpg.optimize_pose_graph_sim3_cg_distributed, pg.optimize_pose_graph_sim3_cg),
}


def _odd(g):
    e = g.edge_i.shape[0]
    g = g._replace(edge_i=g.edge_i[: e - 1 + e % 2], edge_j=g.edge_j[: e - 1 + e % 2],
                   t_meas=g.t_meas[: e - 1 + e % 2], weight=g.weight[: e - 1 + e % 2])
    assert g.edge_i.shape[0] % 2 == 1
    return g


@pytest.fixture(scope="module")
def graphs():
    return {kind: [np.asarray(a) for a in _odd(make())] for kind, (make, _, _) in KINDS.items()}


@pytest.fixture(scope="module")
def two_ranks(graphs):
    """{kind: (poses, costs) of rank 0}, all three kinds in one spawn."""
    out = comm.spawn(worker.optimize_pose_graphs, 2, "gloo", "cpu", graphs, ITERS, timeout=120,
                     threads=1)
    for kind in KINDS:
        assert all(np.array_equal(a, b) for a, b in zip(out[0][kind], out[1][kind])), kind
    return out[0]


def _close_costs(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-10)


@pytest.mark.parametrize("kind", list(KINDS))
def test_distributed_pose_graph_matches(kind, graphs, two_ranks):
    _, jopt, opt = KINDS[kind]
    poses, costs = two_ranks[kind]
    cls = jpg.PoseGraph if kind == "se3" else jpg.Sim3PoseGraph
    g = cls(*(jax.numpy.asarray(a) for a in graphs[kind]))
    ref, ref_costs = jopt(g, Mesh(np.array(jax.devices()[:2]), axis_names=("pg",)), axis="pg",
                          iters=ITERS)
    np.testing.assert_allclose(poses, np.asarray(ref.poses), atol=1e-4)
    _close_costs(costs, ref_costs)

    tcls = pg.PoseGraph if kind == "se3" else pg.Sim3PoseGraph
    one, one_costs = opt(tcls(*(torch.from_numpy(a.copy()) for a in graphs[kind])), iters=ITERS)
    np.testing.assert_allclose(poses, one.poses.numpy(), atol=1e-4)
    _close_costs(costs, one_costs.numpy())
