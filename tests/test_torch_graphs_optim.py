"""The captured entry points of geometry/ and optim/ on the CPU:
`optim.ba.refine_points_jit`, `optim.pose_graph.optimize_pose_graph_jit`
and `geometry.epipolar.ransac_essential_jit` (`core/graphs.py`; on CUDA
inputs chip_smoke.py phase 5c holds every replay bit for bit to the eager
port on the card).  Here:

- on CPU tensors each equals its eager function bit for bit, captures
  nothing and leaves the launch counters as they were; RANSAC leaves its
  generator where the eager call leaves it;
- each against the reference's compiled counterpart on the same NumPy
  inputs, within the eager tests' budgets: `refine_points_jit` within 1e-4
  of the jitted `refine_points` on tests/test_torch_ba.py's problem, and on
  that problem padded to pow2 rows of weight 0, whose padded points come
  back unchanged; `optimize_pose_graph_jit` as
  tests/test_torch_pose_graph.py (poses within 1e-4, costs within 1e-4
  relative or 1e-9 absolute) on its circle graph; `ransac_essential_jit`,
  whose draws differ from the reference's (a torch.Generator against a JAX
  key), as tests/test_torch_geometry.py (inlier sets equal but for 1%, E up
  to sign within 1e-3, >= 80 inliers, no outlier);
- the signature: a 0-d tensor threshold is an input (one signature for
  every value), a float threshold is static (one per value), and a tensor
  threshold gives the bits of its float.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.geometry import epipolar as jepi
from siftgpu_tpu.optim import ba as jba
from siftgpu_tpu.optim import pose_graph as jpg
from siftgpu_tpu_torch.convert import tree_to_torch
from siftgpu_tpu_torch.geometry import epipolar
from siftgpu_tpu_torch.optim import ba
from siftgpu_tpu_torch.optim import pose_graph as pg

import chip_smoke
from test_ba import _make_problem
from test_geometry import _synthetic_two_view
from test_pose_graph import _circle_graph
from test_torch_geometry import _same_up_to_sign
from test_torch_graphs import check_cpu_route, same_bits
from test_torch_pose_graph import _close_costs, _to_torch
from torch_threads import one_thread  # noqa: F401 (autouse)

PG_ITERS = 10
RANSAC_KW = dict(num_hypotheses=256, threshold=1e-5)


def _refine_problem():
    """tests/test_torch_ba.py's refine_points problem: points moved by
    N(0, 0.05), every 17th observation an outlier for the Huber weights."""
    prob = _make_problem(seed=7, perturb=0.0)[0]
    rng = np.random.default_rng(7)
    X0 = np.asarray(prob.points) + rng.normal(0, 0.05, np.asarray(prob.points).shape)
    uv = np.asarray(prob.uv).copy()
    uv[::17] += 20.0
    return prob._replace(points=jnp.asarray(X0, jnp.float32), uv=jnp.asarray(uv))


def _padded(prob, extra_points=4):
    """The problem with `extra_points` more points, observed only by the
    weight-0 rows that pad the observations to the next pow2 (the SLAM
    loop's bucket layout, its padded rows pointing at the new points)."""
    n, P = int(prob.w.shape[0]), int(prob.points.shape[0])
    nb = 1 << (n - 1).bit_length()
    assert nb > n
    rng = np.random.default_rng(3)
    pad = np.arange(nb - n)
    points = np.concatenate([np.asarray(prob.points),
                             rng.uniform([-2, -2, 6], [2, 2, 10], (extra_points, 3))])
    cat = lambda a, b: jnp.asarray(np.concatenate([np.asarray(a), b]))
    return prob._replace(
        points=jnp.asarray(points, jnp.float32),
        cam_idx=cat(prob.cam_idx, (pad % prob.cams.shape[0]).astype(np.int32)),
        pt_idx=cat(prob.pt_idx, (P + pad % extra_points).astype(np.int32)),
        uv=cat(prob.uv, rng.uniform(0, 600, (nb - n, 2)).astype(np.float32)),
        w=cat(prob.w, np.zeros(nb - n, np.float32)))


@pytest.fixture(scope="module")
def refine():
    """(problem, padded problem, the reference's jitted refine_points of each)."""
    prob = _refine_problem()
    padded = _padded(prob)
    return prob, padded, np.asarray(jba.refine_points(prob, 3)), \
        np.asarray(jba.refine_points(padded, 3))


@pytest.fixture(scope="module")
def circle():
    g, _ = _circle_graph()
    return g, jpg.optimize_pose_graph_jit(g, PG_ITERS)


@pytest.fixture(scope="module")
def two_view():
    """tests/test_torch_geometry.py's RANSAC scene: 120 correspondences, 30
    outliers, two masked out, and the reference's compiled RANSAC on it."""
    x0, x1, _, _, _, bad = _synthetic_two_view(120, seed=2, noise=1e-4, outliers=30)
    mask = np.ones(120, bool)
    mask[[3, 50]] = False
    ref = jepi.ransac_essential(x0, x1, jnp.asarray(mask), jax.random.PRNGKey(0), **RANSAC_KW)
    return np.asarray(x0), np.asarray(x1), mask, bad, ref


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------- the CPU route is the eager function ----------------

def _case(name, refine, circle, two_view):
    """(entry point, eager function, args, kwargs) of one CPU-route case."""
    prob, padded, _, _ = refine
    x0, x1, mask, _, _ = two_view
    thr = RANSAC_KW["threshold"]
    if name.startswith("refine_points"):
        p, kw = (padded, dict(iters=3, huber_px=2.0)) if name.endswith("padded") else \
            (prob, dict(iters=3))
        return ba.refine_points_jit, ba.refine_points, (tree_to_torch(p, ba.BAProblem),), kw
    if name == "pose_graph":
        return (pg.optimize_pose_graph_jit, pg.optimize_pose_graph,
                (_to_torch(circle[0], pg.PoseGraph),), dict(iters=PG_ITERS))
    if name == "pose_graph_64_free":     # the dense solver's cap: a [384, 384] system
        g = pg.PoseGraph(*map(_t, chip_smoke.circle_graphs(n=64, seed=5)["se3"]))
        return (pg.optimize_pose_graph_jit, pg.optimize_pose_graph, (g,),
                dict(iters=3, lam=1e-4, fix_first=False))
    return (epipolar.ransac_essential_jit, epipolar.ransac_essential,
            (_t(x0), _t(x1), _t(mask), torch.Generator().manual_seed(3)),
            dict(num_hypotheses=256, threshold=thr if name == "ransac_float"
                 else torch.full((), thr)))


@pytest.mark.parametrize("name", ["refine_points", "refine_points_padded", "pose_graph",
                                  "pose_graph_64_free", "ransac_float", "ransac_tensor"])
def test_cpu_route_is_the_eager_function(name, refine, circle, two_view):
    check_cpu_route(*_case(name, refine, circle, two_view))


# ---------------- each against the reference's compiled counterpart ----------------

def test_refine_points_jit_matches_reference(refine):
    prob, _, ref, _ = refine
    got = ba.refine_points_jit(tree_to_torch(prob, ba.BAProblem), iters=3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_refine_points_jit_padded_rows_leave_their_points(refine):
    """Padded to pow2 rows of weight 0: the real points as on the unpadded
    problem (and as the reference's on either), the padded ones unchanged."""
    prob, padded, ref, ref_padded = refine
    P = int(prob.points.shape[0])
    p = tree_to_torch(padded, ba.BAProblem)
    got = ba.refine_points_jit(p, iters=3)
    assert torch.equal(got[P:], p.points[P:])
    np.testing.assert_array_equal(ref_padded[P:], np.asarray(padded.points)[P:])
    np.testing.assert_allclose(got[:P].numpy(), ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:P].numpy(), ref_padded[:P], rtol=0, atol=1e-4)


def test_optimize_pose_graph_jit_matches_reference(circle):
    g, (ref, ref_costs) = circle
    tg = _to_torch(g, pg.PoseGraph)
    out, costs = pg.optimize_pose_graph_jit(tg, PG_ITERS)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    _close_costs(costs.numpy(), ref_costs)
    assert float(costs[-1]) < float(costs[0])
    assert torch.equal(out.poses[0], pg.optimize_pose_graph(tg, PG_ITERS)[0].poses[0])
    np.testing.assert_allclose(out.poses[0].numpy(), np.asarray(g.poses[0]), atol=1e-7)
    for f in ("edge_i", "edge_j", "t_meas", "weight"):
        assert torch.equal(getattr(out, f), getattr(tg, f))


@pytest.mark.parametrize("kind", ["float", "tensor"])
def test_ransac_essential_jit_matches_reference(kind, two_view):
    x0, x1, mask, bad, ref = two_view
    thr = RANSAC_KW["threshold"]
    got = epipolar.ransac_essential_jit(
        _t(x0), _t(x1), _t(mask), torch.Generator().manual_seed(0), num_hypotheses=256,
        threshold=thr if kind == "float" else torch.full((), thr))
    inl, rinl = got.inliers.numpy(), np.asarray(ref.inliers)
    assert (inl != rinl).mean() <= 0.01
    assert _same_up_to_sign(got.E.numpy(), np.asarray(ref.E)) < 1e-3
    assert int(got.num_inliers) >= 80 and not any(inl[i] for i in bad) and not inl[~mask].any()


# ---------------- the threshold's place in the signature ----------------

def test_tensor_threshold_is_one_signature():
    jit = epipolar.ransac_essential_jit
    x, m, g = torch.zeros(40, 2), torch.ones(40, dtype=torch.bool), torch.Generator()
    key = lambda thr: jit.signature(x, x, m, g, 256, thr)[0]
    assert key(torch.full((), 1e-5)) == key(torch.full((), 4e-5))
    assert key(1e-5) != key(4e-5)
    assert key(torch.full((), 1e-5)) != key(1e-5)
    assert key(torch.full((), 1e-5)) != key(torch.full((), 1e-5, dtype=torch.float64))
    assert not jit.captures


def test_tensor_threshold_gives_the_bits_of_its_float(two_view):
    x0, x1, mask, _, _ = two_view
    run = lambda thr: epipolar.ransac_essential_jit(
        _t(x0), _t(x1), _t(mask), torch.Generator().manual_seed(4), num_hypotheses=256,
        threshold=thr)
    for thr in (1e-5, 3e-6, (2.0 / 500.0) ** 2):
        assert same_bits(run(thr), run(torch.full((), thr)))
