"""The small-matrix eigen / SVD kernel's arithmetic (`ops/small_eig.py`) on
the CPU, where no kernel is built.

The kernel (`csrc/small_eig.cu`) and its plain version, `eigh_sym_plain` /
`svd3_plain`, are the same float64 Jacobi step by step (chip_smoke.py holds
them bit for bit on the card).  Here the plain version stands for the
card's route:

- on seeded batches of n = 3, 4, 9 (symmetric, indefinite) and 3 x 3 (SVD),
  and on chip_smoke.py's edge cases (repeated eigenvalues, zero, rank 1 and
  2, an essential matrix, entries at 1e6), held to `torch.linalg` and to the
  reference's `jnp.linalg.eigh` / `svd` within chip_smoke.EIG_TOL (per
  matrix, against its Frobenius norm |M|: values within 1e-5 |M|, the
  residual or reconstruction within 1e-5 |M|, orthogonality within 1e-5,
  each vector within sin(angle) <= 1e-5 |M| / gap, up to sign);
- on the matrices the reference forms on tests/test_torch_twoview.py's
  160x200 scene from its own features, matches and RANSAC draws: its
  eight-point [512, 9, 9] minimal sets and refit [9, 9], its
  triangulation's [4, N, 4, 4] and the [512, 3, 3] essential matrices, the
  same budgets;
- the geometry on the kernel's arithmetic: tests/test_torch_geometry.py's
  eight_point, triangulate and recover_pose tests and
  tests/test_torch_twoview.py's `two_view_from_features` on the
  reference's features and draws, run with the plain version patched in
  for the CPU route, under their own budgets;
- and the CPU route itself is `torch.linalg`, bit for bit (the stated
  exception: the CPU tests hold the geometry to the reference through it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_geometry as tgeo
import test_torch_twoview as ttv
from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend.extract import extract_features_jit
from siftgpu_tpu.frontend.match import match_descriptors as jmatch
from siftgpu_tpu.geometry import epipolar as jepi
from siftgpu_tpu.geometry import pose as jpose
from siftgpu_tpu.oracle import fixtures as jfixtures
from siftgpu_tpu_torch.ops import small_eig as se
from torch_threads import one_thread  # noqa: F401 (autouse)

KINDS = [("eigh", 3), ("eigh", 4), ("eigh", 9), ("svd3", 3)]


_J_EIGH = jax.jit(jnp.linalg.eigh)
_J_SVD = jax.jit(jnp.linalg.svd)


def _held(x: torch.Tensor, kind: str, label: str):
    """The plain version on x, held to torch.linalg and to the reference's
    jnp.linalg within chip_smoke.EIG_TOL; returns its output."""
    got = (se.eigh_sym_plain if kind == "eigh" else se.svd3_plain)(x)
    cs.eig_against_linalg(x, got, kind, label)
    ref = (_J_EIGH if kind == "eigh" else _J_SVD)(jnp.asarray(x.numpy()))
    cs.eig_against_linalg(x, got, kind, f"{label}, against the reference",
                          [torch.from_numpy(np.array(r)) for r in ref])
    return got


def _seeded(kind: str, n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "svd3":
        return rng.normal(size=(256, 3, 3)).astype(np.float32)
    b = rng.normal(size=(256, n, n)).astype(np.float32)
    return (b + b.transpose(0, 2, 1)) / np.float32(2)


@pytest.mark.parametrize("cases", ["seeded", "edge"])
@pytest.mark.parametrize("kind,n", KINDS)
def test_plain_matches_linalg_and_reference(kind, n, cases):
    x = _seeded(kind, n) if cases == "seeded" else np.stack(
        list(cs.eig_edge_matrices(kind, n).values()))
    w_or_u, *rest = _held(torch.from_numpy(x), kind, f"{kind} {n} x {n} {cases}")
    if cases == "edge" and kind == "eigh":   # the zero matrix: exact zeros, V = I
        np.testing.assert_array_equal(w_or_u[2].numpy(), np.zeros(n, np.float32))
        np.testing.assert_array_equal(rest[0][2].numpy(), np.eye(n, dtype=np.float32))


def test_cpu_route_is_torch_linalg():
    """The CPU route keeps torch.linalg's bits, batched and unbatched."""
    x = torch.from_numpy(_seeded("eigh", 9)[:8])
    for a, b in zip(se.eigh_sym(x), torch.linalg.eigh(x)):
        assert torch.equal(a, b)
    a3 = torch.from_numpy(_seeded("svd3", 3)[:8])
    for one in (a3, a3[0]):
        for a, b in zip(se.svd3(one), torch.linalg.svd(one)):
            assert torch.equal(a, b)


# ---------------- the matrices the reference forms on the two-view scene ----------------

@jax.jit
def _ref_normal_matrix(x0, x1, w):
    """The 9 x 9 matrix the reference's eight_point hands to eigh
    (siftgpu_tpu/geometry/epipolar.py:47-57)."""
    x0n, _ = jepi._normalize_for_dlt(x0, w)
    x1n, _ = jepi._normalize_for_dlt(x1, w)
    u0, v0, u1, v1 = x0n[:, 0], x0n[:, 1], x1n[:, 0], x1n[:, 1]
    A = jnp.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, jnp.ones_like(u0)], axis=1)
    return (A * w[:, None]).T @ A


@jax.jit
def _ref_triangulation_matrices(Rs, ts, x0, x1):
    """The [4, N, 4, 4] matrices the reference's recover_pose hands to eigh
    (siftgpu_tpu/geometry/pose.py:171-182 for each candidate and point)."""
    P0 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)

    def candidate(R, t):
        P1 = jnp.concatenate([R, t[:, None]], axis=1)

        def point(p0, p1):
            A = jnp.stack([p0[0] * P0[2] - P0[0], p0[1] * P0[2] - P0[1],
                           p1[0] * P1[2] - P1[0], p1[1] * P1[2] - P1[1]])
            return A.T @ A

        return jax.vmap(point)(x0, x1)

    return jax.vmap(candidate)(Rs, ts)


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_twoview.py's 160x200 pair through the reference:
    features, matches, normalized coordinates, its RANSAC draws (key 7) and
    result."""
    img0, img1, _ = jfixtures.two_plane_stereo(ttv.H, ttv.W, ttv.INTR, ttv.RVEC, ttv.T_GT, seed=2)
    feats = extract_features_jit(jnp.stack([jnp.asarray(img0), jnp.asarray(img1)]),
                                 JConfig(height=ttv.H, width=ttv.W, max_keypoints=1024))
    res = jmatch(feats.desc[0], feats.desc[1], feats.mask[0], feats.mask[1],
                 JMatch(max_match=1024))
    p = np.asarray(res.pairs)
    valid = p[:, 0] >= 0
    i0, i1 = np.maximum(p[:, 0], 0), np.maximum(p[:, 1], 0)
    intr = np.asarray(ttv.INTR, np.float32)
    norm = lambda f, i: ((np.stack([np.asarray(f.x)[i], np.asarray(f.y)[i]], 1) - intr[2:])
                         / intr[:2]).astype(np.float32)
    x0, x1 = norm(feats, (0, i0)), norm(feats, (1, i1))
    key = jax.random.PRNGKey(7)
    vf = jnp.asarray(valid, jnp.float32)
    draws = np.array(jax.random.choice(key, len(valid), shape=(512, 8), p=vf / vf.sum()))
    f = np.float32((intr[0] + intr[1]) / 2)
    rr = jax.jit(lambda a, b, m, k, thr: jepi.ransac_essential(a, b, m, k, threshold=thr))(
        jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(valid), key, (np.float32(2.0) / f) ** 2)
    return dict(x0=x0, x1=x1, draws=draws, E=np.asarray(rr.E), inliers=np.asarray(rr.inliers))


SCENE = ["eight_point minimal sets", "eight_point refit", "triangulation", "essential svd"]


@pytest.mark.parametrize("which", SCENE)
def test_plain_on_the_reference_scene_matrices(which, scene):
    x0, x1, d = jnp.asarray(scene["x0"]), jnp.asarray(scene["x1"]), scene["draws"]
    ones = jnp.ones(8, jnp.float32)
    if which == "eight_point minimal sets":
        x, kind = jax.vmap(lambda i: _ref_normal_matrix(x0[i], x1[i], ones))(d), "eigh"
    elif which == "eight_point refit":
        x, kind = _ref_normal_matrix(x0, x1, jnp.asarray(scene["inliers"], jnp.float32)), "eigh"
    elif which == "triangulation":
        Rs, ts = jpose.decompose_essential(jnp.asarray(scene["E"]))
        x, kind = _ref_triangulation_matrices(Rs, ts, x0, x1), "eigh"
    else:
        x = jax.vmap(lambda i: jepi.eight_point(x0[i], x1[i], ones))(d)
        kind = "svd3"
    x = torch.from_numpy(np.array(x, np.float32))
    _held(x, kind, which)
    assert x.shape[-1] == (3 if kind == "svd3" else 9 if "eight" in which else 4)


# ---------------- the geometry on the kernel's arithmetic ----------------

GEOMETRY = ["test_eight_point_matches_reference", "test_eight_point_batched_minimal_sets",
            "test_triangulate_matches_reference", "test_recover_pose_matches_reference",
            "test_recover_pose_exact_scene"]


@pytest.mark.parametrize("name", GEOMETRY + ["two_view_from_reference_features"])
def test_geometry_on_the_kernel_arithmetic(name, monkeypatch):
    """The eager geometry with the plain version as the CPU route: the
    card's route, predicted here, under the CPU tests' own budgets."""
    monkeypatch.setattr(se, "eigh_sym", se.eigh_sym_plain)
    monkeypatch.setattr(se, "svd3", se.svd3_plain)
    if name in GEOMETRY:
        getattr(tgeo, name)()
    else:
        ttv.test_two_view_from_reference_features_matches_reference()
