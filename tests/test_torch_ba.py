"""The port's bundle adjustment (`optim/ba.py`) against the reference on
tests/test_ba.py's synthetic scenes, carried across with `tree_to_torch`.

Bounds: closed-form Jacobians within 1e-5 of `jax.jacfwd`'s, relative to
the largest entry of each block; residuals within 1e-4 px (one f32 ulp of a
~300 px coordinate is 3e-5); after `run_ba` the final cost within 1e-3
relative of the reference's (or 1e-6 of the initial cost where both converge
to ~0: the noise-free scenes), camera 0 frozen bit for bit, observations of
weight 0 ignored; `refine_points` within 1e-4 of the reference's points.
The cameras themselves are not compared: with camera 0 frozen the scene's
scale stays free, damped only by lambda, so two runs may drift apart along
it at the same cost."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.optim import ba as jba
from siftgpu_tpu_torch.convert import tree_to_torch
from siftgpu_tpu_torch.optim import ba

from test_ba import _make_problem


def _port(prob):
    return tree_to_torch(prob, ba.BAProblem)


def _with_rotation_free_camera(prob):
    """Camera 0 with an exactly zero rotation (the theta < 1e-8 branch) and
    non-uniform observation weights."""
    cams = np.asarray(prob.cams).copy()
    cams[0, :3] = 0.0
    w = np.random.default_rng(9).uniform(0.5, 2.0, np.asarray(prob.w).shape).astype(np.float32)
    return prob._replace(cams=jnp.asarray(cams), w=jnp.asarray(w))


def test_jacobians_match_reference():
    prob = _with_rotation_free_camera(_make_problem(seed=1)[0])
    rr, rJc, rJp = (np.asarray(a) for a in jax.jit(jba._jacobians)(prob, prob.cams, prob.points))
    p = _port(prob)
    r, Jc, Jp = ba._jacobians(p, p.cams, p.points)
    np.testing.assert_allclose(r.numpy(), rr.reshape(-1, 2), rtol=0, atol=1e-4)
    for got, ref in ((Jc.numpy(), rJc), (Jp.numpy(), rJp)):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(
        ba.reprojection_residuals(p, p.cams, p.points).numpy(),
        np.asarray(jba.reprojection_residuals(prob, prob.cams, prob.points)), rtol=0, atol=1e-4)


def test_inv3_matches_reference():
    A = np.random.default_rng(2).normal(0, 1, (20, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(ba._inv3(torch.from_numpy(A)).numpy(),
                               np.asarray(jba._inv3(jnp.asarray(A))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,kw,iters,n_cg", [
    (0, {}, 15, 40),                                   # test_ba_reduces_cost_to_zero
    (3, {}, 5, 20),                                    # test_ba_first_camera_frozen
    (4, {}, 15, 40),                                   # test_ba_masked_observations_ignored
    (5, dict(perturb=0.03, pix_noise=0.3), 15, 40),    # test_ba_with_noise_converges_to_gt_scale
], ids=["converge", "frozen", "masked", "noise"])
def test_run_ba_matches_reference(seed, kw, iters, n_cg):
    prob, cams_gt, _ = _make_problem(seed=seed, **kw)
    if seed == 4:  # corrupt 10 observations and mask them out
        uv, w = np.asarray(prob.uv).copy(), np.asarray(prob.w).copy()
        uv[:10] += 500.0
        w[:10] = 0.0
        prob = prob._replace(uv=jnp.asarray(uv), w=jnp.asarray(w))
    ref = jba.run_ba(prob, iters=iters, n_cg=n_cg)
    p = _port(prob)
    got = ba.run_ba(p, iters=iters, n_cg=n_cg)
    c0, cr, cg = float(ba._cost(p, p.cams, p.points)), float(ref.cost), float(got.cost)
    assert abs(cg - cr) <= max(1e-3 * cr, 1e-6 * c0), (cg, cr, c0)
    assert torch.equal(got.cams[0], p.cams[0])                  # gauge: frozen exactly
    r = ba.reprojection_residuals(p, got.cams, got.points).numpy()
    if seed == 5:
        assert np.abs(got.cams[1:, 3:].numpy() - cams_gt[1:, 3:]).max() < 0.05
    else:
        assert np.sqrt((r ** 2).mean()) < 1e-2                  # masked outliers ignored


def test_schur_solve_matches_reference_step():
    """One damped Gauss-Newton step on the same Jacobians, with fixed points:
    within 1e-3 of the largest entry (30 f32 CG steps on a system whose
    scale gauge is damped only by lambda = 1e-3 amplify rounding)."""
    prob = _make_problem(seed=6)[0]
    fixed = np.zeros(np.asarray(prob.points).shape[0], bool)
    fixed[:5] = True
    r, Jc, Jp = jax.jit(jba._jacobians)(prob, prob.cams, prob.points)
    M, P = prob.cams.shape[0], prob.points.shape[0]
    gauge = jnp.ones(M).at[0].set(0.0)
    solve = jax.jit(jba.schur_solve, static_argnums=(5, 6, 9))
    rd, rp = solve(r.reshape(-1, 2), Jc, Jp, prob.cam_idx, prob.pt_idx, M, P,
                   jnp.float32(1e-3), gauge, 30, pt_fixed=jnp.asarray(fixed))
    t = lambda a: torch.from_numpy(np.array(a))
    gd, gp = ba.schur_solve(t(r).reshape(-1, 2), t(Jc), t(Jp), t(prob.cam_idx), t(prob.pt_idx),
                            M, P, torch.tensor(1e-3), t(gauge), 30, pt_fixed=t(fixed))
    assert np.abs(gd.numpy() - np.asarray(rd)).max() <= 1e-3 * np.abs(np.asarray(rd)).max()
    assert np.abs(gp.numpy() - np.asarray(rp)).max() <= 1e-3 * np.abs(np.asarray(rp)).max()
    assert not bool(gp[:5].any()) and not bool(gd[0].any())


def test_refine_points_matches_reference():
    prob = _make_problem(seed=7, perturb=0.0)[0]
    rng = np.random.default_rng(7)
    X0 = np.asarray(prob.points) + rng.normal(0, 0.05, np.asarray(prob.points).shape)
    uv = np.asarray(prob.uv).copy()
    uv[::17] += 20.0                                            # outliers for the Huber weights
    prob = prob._replace(points=jnp.asarray(X0, jnp.float32), uv=jnp.asarray(uv))
    ref = np.asarray(jba.refine_points(prob, iters=3))
    got = ba.refine_points(_port(prob), iters=3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _index_add(x, idx, n):
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype).index_add_(0, idx, x)


@pytest.mark.parametrize("case", ["shuffled", "empty segments", "one segment", "3x3 rows",
                                  "no rows"])
def test_segment_sum_matches_index_add_bits(case):
    """The fixed-order segment sum adds each segment's rows in their
    original order from 0: on the CPU, `index_add_`'s bits exactly."""
    rng = np.random.default_rng(11)
    n, N, shape = {"shuffled": (40, 500, (3,)), "empty segments": (600, 300, (6,)),
                   "one segment": (1, 700, (6, 6)), "3x3 rows": (90, 400, (3, 3)),
                   "no rows": (5, 0, (3,))}[case]
    idx = rng.integers(0, n, N)
    if case == "empty segments":
        idx = rng.choice(np.arange(0, n, 7), N)            # 6 of every 7 segments empty
    x = torch.from_numpy(rng.normal(0, 1, (N, *shape)).astype(np.float32))
    idx_t = torch.from_numpy(idx)
    seg = ba.Segments.of(idx_t.to(torch.int32), n)
    got = ba._segment_sum(x, seg)
    ref = _index_add(x, idx_t, n)
    assert got.shape == ref.shape
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(seg.offsets.diff(), torch.bincount(idx_t, minlength=n))


def test_run_ba_repeats_bit_for_bit():
    """Two runs on the same problem give the same bits (the card's property
    that `index_add_`'s atomics lacked; on the CPU a check of the plan's
    reuse across LM steps)."""
    p = _port(_make_problem(seed=5, perturb=0.03, pix_noise=0.3)[0])
    a, b = ba.run_ba(p, iters=4, n_cg=10), ba.run_ba(p, iters=4, n_cg=10)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    r = ba.refine_points(p, iters=2)
    assert torch.equal(r.view(torch.int32), ba.refine_points(p, iters=2).view(torch.int32))
