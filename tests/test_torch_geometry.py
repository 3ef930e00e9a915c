"""The port's `geometry/` (pose, epipolar) against the reference on the same
inputs, made with numpy from a seed (the scenes of tests/test_geometry.py).

Bounds: E up to sign within 1e-4 of the reference's (both normalised to unit
Frobenius norm: the eigen- and singular-vector solvers differ); Sampson
distances within 1e-5 relative; triangulated points within 1e-4 relative;
`recover_pose` R within 1e-4 rad, t up to sign within 1e-4, `good` masks
differing in at most 0.5% of the points; so3/se3 maps within f32 rounding;
RANSAC scoring on the reference's own draws: inlier sets equal but for 1%."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from siftgpu_tpu.geometry import epipolar as jepi
from siftgpu_tpu.geometry import pose as jpose
from siftgpu_tpu_torch.geometry import epipolar, pose

from test_geometry import _essential_from_rt, _synthetic_two_view

# the reference's geometry is plain jax.numpy; one compile per function is
# much faster on the CPU than op-by-op dispatch
j_eight_point = jax.jit(jepi.eight_point)
j_recover_pose = jax.jit(jpose.recover_pose)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _same_up_to_sign(a, b):
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def _rot_angle(Ra, Rb):
    """Angle of Ra Rb^T in radians, from atan2 of its skew and symmetric parts
    (arccos of the trace cannot resolve angles below ~5e-4 rad in f32)."""
    dR = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2
    return float(np.arctan2(s, (np.trace(dR) - 1) / 2))


def test_eight_point_matches_reference():
    x0, x1, R, t, _, _ = _synthetic_two_view(60, seed=1, noise=1e-3)
    w = np.random.default_rng(0).uniform(0.2, 1.0, 60).astype(np.float32)
    ref = np.asarray(j_eight_point(x0, x1, jnp.asarray(w)))
    got = epipolar.eight_point(T(x0), T(x1), T(w)).numpy()
    assert _same_up_to_sign(got, ref) < 1e-4
    # noise-free: exact, and equal to the ground truth up to scale and sign
    x0, x1, R, t, _, _ = _synthetic_two_view(60, seed=1)
    got = epipolar.eight_point(T(x0), T(x1), torch.ones(60)).numpy()
    assert _same_up_to_sign(got, _essential_from_rt(R, t)) < 1e-4


def test_eight_point_batched_minimal_sets():
    """The 8-point minimal sets of RANSAC as one batch.  A minimal set's
    null space can have more than one dimension (sets drawn with
    replacement), where the two frameworks' eigh pick different vectors, so
    each solution is held to what the reference's achieves: it fits its own
    8 points within 10x the reference's Sampson residual, or 1e-6 (squared
    normalized units: the 9x9 eigh of A^T A squares the set's condition
    number, and f32 leaves ~1e-7 on well-posed sets in both frameworks);
    and the batch equals the sets solved one by one."""
    x0, x1, *_ = _synthetic_two_view(100, seed=4)
    idx = np.random.default_rng(1).integers(0, 100, (16, 8))
    ref = np.asarray(jax.vmap(lambda i: jepi.eight_point(x0[i], x1[i], jnp.ones(8)))(idx))
    got = epipolar.eight_point(T(x0)[idx], T(x1)[idx], torch.ones(16, 8))
    one = torch.stack([epipolar.eight_point(T(x0)[i], T(x1)[i], torch.ones(8)) for i in idx])
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5)
    for g, r, i in zip(got, ref, idx):
        dg = epipolar.sampson_distance(g, T(x0)[i], T(x1)[i]).numpy()
        dr = np.asarray(jepi.sampson_distance(jnp.asarray(r), x0[i], x1[i]))
        assert dg.max() <= max(10 * dr.max(), 1e-6)


def test_sampson_distance_matches_reference():
    x0, x1, R, t, _, _ = _synthetic_two_view(80, seed=2, noise=1e-3, outliers=10)
    E = np.asarray(j_eight_point(x0, x1, jnp.ones(80)))
    ref = np.asarray(jepi.sampson_distance(jnp.asarray(E), x0, x1))
    got = epipolar.sampson_distance(T(E), T(x0), T(x1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
    # a batch of E at once
    got2 = epipolar.sampson_distance(T(np.stack([E, 2 * E])), T(x0), T(x1)).numpy()
    np.testing.assert_array_equal(got2[0], got)


def test_triangulate_matches_reference():
    x0, x1, R, t, X, _ = _synthetic_two_view(80, seed=3, noise=1e-4)
    R32, t32 = R.astype(np.float32), t.astype(np.float32)
    ref = np.asarray(jpose.triangulate(jnp.eye(3), jnp.zeros(3), jnp.asarray(R32),
                                       jnp.asarray(t32), x0, x1))
    got = pose.triangulate(torch.eye(3), torch.zeros(3), T(R32), T(t32), T(x0), T(x1)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.abs(got - X).max() < 0.1       # near the ground truth despite the noise


def test_recover_pose_matches_reference():
    x0, x1, R, t, _, _ = _synthetic_two_view(200, seed=6, noise=5e-4)
    m = np.random.default_rng(2).random(200) > 0.1
    E = np.asarray(j_eight_point(x0, x1, jnp.asarray(m, jnp.float32)))
    ref = j_recover_pose(jnp.asarray(E), x0, x1, jnp.asarray(m))
    got = pose.recover_pose(T(E), T(x0), T(x1), torch.from_numpy(m))
    assert _rot_angle(got.R.numpy(), np.asarray(ref.R)) < 1e-4
    assert _same_up_to_sign(got.t.numpy(), np.asarray(ref.t)) < 1e-4
    assert (got.good.numpy() != np.asarray(ref.good)).mean() <= 0.005
    assert abs(int(got.num_good) - int(ref.num_good)) <= 1
    assert _rot_angle(got.R.numpy(), R) < 1e-2


def test_recover_pose_exact_scene():
    """tests/test_geometry.py's exact scene, held to its own bounds."""
    x0, x1, R, t, X, _ = _synthetic_two_view(80, seed=3)
    tv = pose.recover_pose(T(_essential_from_rt(R, t)), T(x0), T(x1), torch.ones(80, dtype=torch.bool))
    assert int(tv.num_good) == 80
    assert np.abs(tv.R.numpy() - R).max() < 1e-4
    tn = tv.t.numpy() / np.linalg.norm(tv.t.numpy())
    assert np.abs(tn - t / np.linalg.norm(t)).max() < 1e-4
    assert np.abs(tv.points.numpy() * np.linalg.norm(t) - X).max() < 1e-2


def test_so3_se3_maps_match_reference():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 1, (16, 3)).astype(np.float32)
    # near pi (the symmetric-part branch) and near zero (the series branches)
    axis = rng.normal(0, 1, (4, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = np.concatenate([w, (axis * (np.pi - 1e-3)).astype(np.float32),
                        np.array([[0, 0, 0], [1e-9, 0, 0], [3e-7, -2e-7, 1e-7]], np.float32)])
    v = rng.normal(0, 1, (len(w), 3)).astype(np.float32)
    Rr = np.asarray(jpose.exp_so3(jnp.asarray(w)))
    Rg = pose.exp_so3(T(w)).numpy()
    np.testing.assert_allclose(Rg, Rr, atol=2e-6)
    np.testing.assert_allclose(pose.log_so3(T(Rr)).numpy(), np.asarray(jpose.log_so3(jnp.asarray(Rr))),
                               atol=2e-5)
    np.testing.assert_allclose(pose.log_so3(T(Rr)).numpy()[:20], w[:20], atol=1e-3)   # round trip
    xi = np.concatenate([w, v], 1)
    (Rs, ts), (Rj, tj) = pose.exp_se3(T(xi)), jpose.exp_se3(jnp.asarray(xi))
    np.testing.assert_allclose(Rs.numpy(), np.asarray(Rj), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(pose.log_se3(Rs, ts).numpy()[:16], xi[:16], atol=1e-4)  # round trip
    np.testing.assert_allclose(pose.log_se3(Rs, ts).numpy(),
                               np.asarray(jpose.log_se3(jnp.asarray(Rs.numpy()), jnp.asarray(ts.numpy()))),
                               atol=1e-4)


def test_compose_inverse_relative_match_reference():
    rng = np.random.default_rng(7)
    Ra, Rb = (np.asarray(jpose.exp_so3(jnp.asarray(rng.normal(0, 0.5, (5, 3)), jnp.float32)))
              for _ in range(2))
    ta, tb = (rng.normal(0, 1, (5, 3)).astype(np.float32) for _ in range(2))
    sa, sb = (rng.uniform(0.5, 2.0, 5).astype(np.float32) for _ in range(2))
    pairs = [
        (pose.compose(T(Ra), T(ta), T(Rb), T(tb)), jpose.compose(Ra, ta, Rb, tb)),
        (pose.inverse(T(Ra), T(ta)), jpose.inverse(Ra, ta)),
        (pose.relative(T(Ra), T(ta), T(Rb), T(tb)), jpose.relative(Ra, ta, Rb, tb)),
        (pose.compose_sim3(T(sa), T(Ra), T(ta), T(sb), T(Rb), T(tb)),
         jpose.compose_sim3(sa, Ra, ta, sb, Rb, tb)),
        (pose.inverse_sim3(T(sa), T(Ra), T(ta)), jpose.inverse_sim3(sa, Ra, ta)),
        (pose.relative_sim3(T(sa), T(Ra), T(ta), T(sb), T(Rb), T(tb)),
         jpose.relative_sim3(sa, Ra, ta, sb, Rb, tb)),
    ]
    for got, ref in pairs:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def _reference_draws(mask, key, num_hypotheses):
    """The minimal sets the reference's ransac_essential draws for `key`."""
    probs = jnp.asarray(mask, jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-9)
    return np.array(jax.random.choice(key, len(mask), shape=(num_hypotheses, 8), p=probs))


def test_ransac_scoring_on_reference_draws():
    x0, x1, R, t, X, bad = _synthetic_two_view(120, seed=2, noise=1e-4, outliers=30)
    mask = np.ones(120, bool)
    mask[[3, 50]] = False
    key = jax.random.PRNGKey(0)
    ref = jepi.ransac_essential(x0, x1, jnp.asarray(mask), key, num_hypotheses=256, threshold=1e-5)
    idx = _reference_draws(mask, key, 256)
    got = epipolar.ransac_from_samples(T(x0), T(x1), torch.from_numpy(mask),
                                       torch.from_numpy(idx), threshold=1e-5)
    inl, rinl = got.inliers.numpy(), np.asarray(ref.inliers)
    assert (inl != rinl).mean() <= 0.01
    assert abs(int(got.best_score) - int(ref.best_score)) <= 1
    assert _same_up_to_sign(got.E.numpy(), np.asarray(ref.E)) < 1e-3
    assert int(got.num_inliers) >= 80 and not any(inl[i] for i in bad) and not inl[[3, 50]].any()


def test_ransac_essential_with_a_generator():
    """The port's own draws (torch.multinomial) meet the reference's test."""
    x0, x1, R, t, X, bad = _synthetic_two_view(120, seed=2, noise=1e-4, outliers=30)
    res = epipolar.ransac_essential(T(x0), T(x1), torch.ones(120, dtype=torch.bool),
                                    torch.Generator().manual_seed(0), num_hypotheses=256,
                                    threshold=1e-5)
    inl = res.inliers.numpy()
    assert int(res.num_inliers) >= 80 and not any(inl[i] for i in bad)
    d = epipolar.sampson_distance(res.E, T(x0), T(x1)).numpy()[inl]
    assert d.max() < 1e-5


def test_sample_minimal_sets_follows_the_mask():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[4, 17, 33]] = True
    idx = epipolar.sample_minimal_sets(mask, 64, torch.Generator().manual_seed(1))
    assert idx.shape == (64, 8) and set(idx.flatten().tolist()) <= {4, 17, 33}


def test_ransac_with_no_valid_match():
    """A pair without one valid match: no inlier, no error (the reference
    does not raise either)."""
    x0, x1, *_ = _synthetic_two_view(40, seed=8)
    mask = np.zeros(40, bool)
    ref = jepi.ransac_essential(x0, x1, jnp.asarray(mask), jax.random.PRNGKey(1), num_hypotheses=32)
    got = epipolar.ransac_essential(T(x0), T(x1), torch.from_numpy(mask),
                                    torch.Generator().manual_seed(1), num_hypotheses=32)
    assert int(got.num_inliers) == int(ref.num_inliers) == 0
    assert int(got.best_score) == int(ref.best_score) == 0
    assert not bool(got.inliers.any())
