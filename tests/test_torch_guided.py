"""Port guided matching vs the reference's dense guided path on the CPU.

Pairs and count identical for the "h", "f" and "hf" gates, on the sets of
tests/test_pallas_ops.py (n0 = 300, n1 = 900, hdist 24, fdist 8) and the
cases of tests/test_match.py; `dist` within the form of budget of
tests/test_torch_match.py: 1e-6 plus the winner similarity's difference
through arccos.  That difference is 4 ulp here, not 2: each of the
reference's reciprocal norms (`lax.rsqrt`) can be 1 ulp off the correctly
rounded value the port uses, and on these sets both are at some winners
(3 ulp measured; 4 ulp over the whole [300, 900] similarity).  The port's gate matrices equal the reference's dense ones
(`_homography_gate` / `_epipolar_gate`); XLA:CPU may contract the gate sums
into FMAs, so a pair lying within 1e-5 relative of a threshold could flip —
none does on these sets, so no pair is excluded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.frontend import match as jmatch
from siftgpu_tpu_torch.convert import matrix_to_torch
from siftgpu_tpu_torch.core.config import MatchConfig
from siftgpu_tpu_torch.frontend import match
from siftgpu_tpu_torch.ops import match_kernel

from test_torch_match import _check, _noisy_copy, _rand_desc

GATES = {"h": (True, False), "f": (False, True), "hf": (True, True)}


def _cross(tx, ty):
    """F = [t]x of the pure image translation t = (tx, ty, 0)."""
    return np.array([[0, 0, ty], [0, 0, -tx], [-ty, tx, 0]], np.float32)


def _kernel_sets():
    """tests/test_pallas_ops.py::test_match_kernel_guided_matches_xla_gates."""
    rng = np.random.default_rng(11)
    n0, n1 = 300, 900
    d0 = rng.integers(0, 256, (n0, 128), dtype=np.uint8)
    d1 = np.concatenate([
        np.clip(d0.astype(int) + rng.integers(-6, 7, (n0, 128)), 0, 255).astype(np.uint8),
        rng.integers(0, 256, (n1 - n0, 128), dtype=np.uint8),
    ])
    loc0 = rng.uniform(0, 640, (n0, 2)).astype(np.float32)
    t = np.array([12.0, -7.0], np.float32)
    loc1 = np.concatenate([loc0 + t, rng.uniform(0, 640, (n1 - n0, 2))]).astype(np.float32)
    H = np.array([[1, 0, t[0]], [0, 1, t[1]], [0, 0, 1]], np.float32)
    e = rng.uniform(-1, 1, 3)
    Ex = np.array([[0, -e[2], e[1]], [e[2], 0, -e[0]], [-e[1], e[0], 0]])
    F = (Ex @ rng.uniform(-1, 1, (3, 3))).astype(np.float32) * 1e-3
    m0 = rng.random(n0) > 0.05
    m1 = rng.random(n1) > 0.05
    return dict(d0=d0, d1=d1, loc0=loc0, loc1=loc1, H=H, F=F, m0=m0, m1=m1,
                hdist=24.0, fdist=8.0, max_match=512)


def _homography_case():
    """tests/test_match.py::test_guided_match_homography_gate."""
    n = 64
    d0 = _rand_desc(n, 7)
    d1 = _noisy_copy(d0, 8)
    loc0 = np.random.default_rng(9).random((n, 2)).astype(np.float32) * 200
    loc1 = loc0 + np.array([5.0, -3.0], np.float32)
    loc1[: n // 2] += 500.0
    H = np.array([[1, 0, 5.0], [0, 1, -3.0], [0, 0, 1]], np.float32)
    F = _cross(5.0, -3.0)
    return dict(d0=d0, d1=d1, loc0=loc0, loc1=loc1, H=H, F=F, m0=None, m1=None,
                hdist=8.0, fdist=2.0, max_match=256)


def _epipolar_case():
    """tests/test_match.py::test_guided_match_epipolar_gate."""
    n = 48
    d0 = _rand_desc(n, 10)
    d1 = _noisy_copy(d0, 11)
    loc0 = np.random.default_rng(12).random((n, 2)).astype(np.float32) * 100
    loc1 = loc0 + np.array([10.0, 0.0], np.float32)
    loc1[: n // 3, 1] += 50.0
    F = np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    H = np.array([[1, 0, 10.0], [0, 1, 0.0], [0, 0, 1]], np.float32)
    return dict(d0=d0, d1=d1, loc0=loc0, loc1=loc1, H=H, F=F, m0=None, m1=None,
                hdist=3.0, fdist=2.0, max_match=256)


CASES = {"kernel_sets": _kernel_sets, "test_match_h": _homography_case,
         "test_match_f": _epipolar_case}


def _run_both(c, gate, dtype=np.uint8):
    use_h, use_f = GATES[gate]
    opt = lambda a, conv: conv(a) if a is not None else None
    ref = jmatch.guided_match_descriptors(
        jnp.asarray(c["d0"].astype(dtype)), jnp.asarray(c["d1"].astype(dtype)),
        jnp.asarray(c["loc0"]), jnp.asarray(c["loc1"]),
        H=jnp.asarray(c["H"]) if use_h else None, F=jnp.asarray(c["F"]) if use_f else None,
        mask0=opt(c["m0"], jnp.asarray), mask1=opt(c["m1"], jnp.asarray),
        hdist_max=c["hdist"], fdist_max=c["fdist"],
        cfg=JMatch(max_match=c["max_match"], block_size=-1, use_pallas=False))
    got = match.guided_match_descriptors(
        torch.from_numpy(c["d0"].astype(dtype)), torch.from_numpy(c["d1"].astype(dtype)),
        torch.from_numpy(c["loc0"]), torch.from_numpy(c["loc1"]),
        H=matrix_to_torch(c["H"]) if use_h else None,
        F=matrix_to_torch(c["F"]) if use_f else None,
        mask0=opt(c["m0"], torch.from_numpy), mask1=opt(c["m1"], torch.from_numpy),
        hdist_max=c["hdist"], fdist_max=c["fdist"], cfg=MatchConfig(max_match=c["max_match"]))
    return ref, got


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_guided_matches_reference(case, gate):
    c = CASES[case]()
    ref, got = _run_both(c, gate)
    _check(got, ref, sim_ulps=4)
    assert int(got.count) > 0
    if case == "kernel_sets" and gate == "h":   # the H-inlier structure is found
        assert int(got.count) > 100
    if case == "test_match_h" and "h" in gate:  # moved locations are gated out
        assert (got.pairs[: int(got.count), 0].numpy() >= 32).all()
    if case == "test_match_f" and "f" in gate:
        assert (got.pairs[: int(got.count), 0].numpy() >= 16).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_matrices_match_reference(case):
    c = CASES[case]()
    l0, l1 = jnp.asarray(c["loc0"]), jnp.asarray(c["loc1"])
    t0, t1 = torch.from_numpy(c["loc0"]), torch.from_numpy(c["loc1"])
    H, F = torch.from_numpy(c["H"]), torch.from_numpy(c["F"])
    gh = np.asarray(jmatch._homography_gate(l0, l1, jnp.asarray(c["H"]), c["hdist"]))
    gf = np.asarray(jmatch._epipolar_gate(l0, l1, jnp.asarray(c["F"]), c["fdist"]))
    np.testing.assert_array_equal(match._homography_gate(t0, t1, H, c["hdist"]).numpy(), gh)
    np.testing.assert_array_equal(match._epipolar_gate(t0, t1, F, c["fdist"]).numpy(), gf)
    # the gated plain version's mask is the same gate, from the kernel's operands
    for gate, ref in (("h", gh), ("f", gf), ("hf", gh & gf)):
        g, rows, cols = match.gate_operands(t0, t1, H if "h" in gate else None,
                                            F if "f" in gate else None)
        assert g == gate
        got = match_kernel.gate_matrix(g, rows[None], cols[None],
                                       *match.gate_thresholds(c["hdist"], c["fdist"]))[0]
        np.testing.assert_array_equal(got.numpy(), ref)
    assert gh.any() and not gh.all() and gf.any() and not gf.all()


def test_gated_reduction_matches_reference_dense_selection():
    """The gated plain reduction against the reference's dense gated
    selection: argbest rows/columns identical, similarities within 4 ulp;
    rows with no pair inside the gate are -inf and produce no match."""
    c = _kernel_sets()
    d0, d1 = c["d0"], c["d1"]
    loc1 = c["loc1"].copy()
    loc1[:, 0] = np.where(loc1[:, 0] < 200, loc1[:, 0] + 1000, loc1[:, 0])  # empty gate rows
    l0, l1, H = jnp.asarray(c["loc0"]), jnp.asarray(loc1), jnp.asarray(c["H"])
    p0, p1 = jmatch._u8_parts(jnp.asarray(d0)), jmatch._u8_parts(jnp.asarray(d1))
    sim = jmatch._u8_sim(p0, p1)
    gate = jmatch._homography_gate(l0, l1, H, c["hdist"])
    sim = np.asarray(jnp.where(gate, sim, -jnp.inf))
    jb, js, jj = (np.asarray(a) for a in jmatch._best2_sim(jnp.asarray(sim)))

    t0, t1 = torch.from_numpy(d0)[None], torch.from_numpy(d1)[None]
    g, rows, cols = match.gate_operands(torch.from_numpy(c["loc0"]), torch.from_numpy(loc1),
                                        H=torch.from_numpy(c["H"]))
    ones0 = torch.ones(1, len(d0), dtype=torch.bool)
    ones1 = torch.ones(1, len(d1), dtype=torch.bool)
    bs, ss, bj, ci = match_kernel.match_best2_gated(
        t0, t1, match_kernel.recip_norms(t0), match_kernel.recip_norms(t1), ones0, ones1,
        g, rows[None], cols[None], *match.gate_thresholds(c["hdist"], c["fdist"]))
    gated_out = ~np.asarray(gate).any(axis=1)
    assert gated_out.sum() > 30
    assert np.isneginf(bs[0].numpy()[gated_out]).all()
    fin = ~gated_out
    np.testing.assert_array_equal(bj[0].numpy()[fin], jj[fin])
    np.testing.assert_array_equal(ci[0].numpy(), sim.argmax(axis=0))
    ulp = lambda a, b: np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
    assert ulp(bs[0].numpy()[fin], jb[fin]).max() <= 4

    res = match.guided_match_descriptors(
        torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(c["loc0"]),
        torch.from_numpy(loc1), H=torch.from_numpy(c["H"]), hdist_max=c["hdist"],
        cfg=MatchConfig(max_match=512))
    assert not np.isin(res.pairs[: int(res.count), 0].numpy(), np.where(gated_out)[0]).any()


@pytest.mark.parametrize("gate", sorted(GATES))
def test_float_descriptors_guided_match_reference(gate):
    """The float-descriptor guided path (dense f32 similarity): pairs
    identical; `dist` within 1e-6 plus 16 ulp of the similarity through
    arccos (rows are normalised with another summation order)."""
    ref, got = _run_both(_kernel_sets(), gate, np.float32)
    np.testing.assert_array_equal(got.pairs.numpy(), np.asarray(ref.pairs))
    assert int(got.count) == int(ref.count) > 0
    jd = np.asarray(ref.dist).astype(np.float64)
    ulp_sim = np.spacing(np.cos(jd).astype(np.float32)).astype(np.float64)
    budget = 1e-6 + 16 * ulp_sim / np.maximum(np.sin(jd), 1e-3)
    assert (np.abs(got.dist.numpy() - jd) <= budget).all()


def test_no_gate_is_plain_matching():
    c = _kernel_sets()
    d0, d1 = torch.from_numpy(c["d0"]), torch.from_numpy(c["d1"])
    cfg = MatchConfig(max_match=512)
    a = match.guided_match_descriptors(d0, d1, torch.from_numpy(c["loc0"]),
                                       torch.from_numpy(c["loc1"]), cfg=cfg)
    b = match.match_descriptors(d0, d1, cfg=cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
