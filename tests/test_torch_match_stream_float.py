"""The port's streaming matcher (`siftgpu_tpu_torch/frontend/match.py::
_match_streaming`) against the reference's (`siftgpu_tpu/frontend/match.py::
_match_streaming`) on float descriptors, and the route each set takes.

The sets are tests/test_torch_match_stream.py's, as float (`d / 512`):
repeated d1 columns (descriptor and location) on both sides of block
edges, repeated d0 rows, masks.  Routes: the default `MatchConfig`, which
streams 1024-column blocks above 4096 columns (N0 = 256, N1 = 4608), and
an explicit `block_size` of 128 on N0 = 700, N1 = 900; each ungated and
through the H, F and H+F gates, at the default ratio test and at
ratio_max 1.5, where a row whose best column is repeated passes it; and a
batch of two pairs.  The port's streamed route is also held to its own
dense route (`block_size=-1`).

Budget (tests/test_torch_match.py's for float sets): pairs and count
identical; `dist` within 1e-6 plus 16 ulp of the winner similarity
through arccos (the rows are normalised and the dots summed in another
order).

The dispatch tests hold `_effective_block` to the reference's at N1 on both
sides of `stream_threshold`, and check which selection each CPU set runs:
above the threshold, the plain best-2 runs on one block at a time, below
it on one block of all columns, and the kernel's wrappers are never
called on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.frontend import match as jmatch
from siftgpu_tpu_torch.core.config import MatchConfig
from siftgpu_tpu_torch.frontend import match

from test_torch_guided import GATES
from test_torch_match import _check
from test_torch_match_stream import SETS, _build
from torch_threads import one_thread  # noqa: F401 (autouse)

ROUTES = {"256x4608": 0, "700x900": 128}        # set -> block_size (0: the auto switch)
RATIOS = {"default": {}, "ties_pass": {"ratio_max": 1.5}}
HDIST, FDIST = 6.0, 3.0


def _as_float(c):
    return dict(c, d0=c["d0"].astype(np.float32) / 512, d1=c["d1"].astype(np.float32) / 512)


@pytest.fixture(scope="module")
def sets():
    """The float sets, built once for the module."""
    return {name: _as_float(_build(*SETS[name])) for name in ROUTES}


def _reference(c, gate, cfg):
    d0, d1 = jnp.asarray(c["d0"]), jnp.asarray(c["d1"])
    m0, m1 = jnp.asarray(c["m0"]), jnp.asarray(c["m1"])
    if gate == "none":
        return jmatch.match_descriptors(d0, d1, m0, m1, cfg)
    use_h, use_f = GATES[gate]
    return jmatch.guided_match_descriptors(
        d0, d1, jnp.asarray(c["loc0"]), jnp.asarray(c["loc1"]),
        H=jnp.asarray(c["H"]) if use_h else None, F=jnp.asarray(c["F"]) if use_f else None,
        mask0=m0, mask1=m1, hdist_max=HDIST, fdist_max=FDIST, cfg=cfg)


def _port(c, gate, cfg):
    t = lambda k: torch.from_numpy(c[k])
    if gate == "none":
        return match.match_descriptors(t("d0"), t("d1"), t("m0"), t("m1"), cfg)
    use_h, use_f = GATES[gate]
    return match.guided_match_descriptors(
        t("d0"), t("d1"), t("loc0"), t("loc1"), H=t("H") if use_h else None,
        F=t("F") if use_f else None, mask0=t("m0"), mask1=t("m1"), hdist_max=HDIST,
        fdist_max=FDIST, cfg=cfg)


def _jax_result(res):
    return type(res)(*(np.asarray(f) for f in res))


@pytest.fixture(scope="module")
def references(sets):
    """The reference's streamed results, one jitted call per (set, gate,
    ratio), computed once for the module."""
    out = {}
    for name, block_size in ROUTES.items():
        c = sets[name]
        for gate in ("none", *GATES):
            for ratio, kw in RATIOS.items():
                cfg = JMatch(block_size=block_size, **kw)
                assert jmatch._effective_block(cfg, c["d1"].shape[0]) > 0   # it streams
                out[name, gate, ratio] = _jax_result(_reference(c, gate, cfg))
    return out


@pytest.mark.parametrize("ratio", sorted(RATIOS))
@pytest.mark.parametrize("gate", ["none", "h", "f", "hf"])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_float_streaming_equals_reference(sets, references, name, gate, ratio):
    c, ref = sets[name], references[name, gate, ratio]
    got = _port(c, gate, MatchConfig(block_size=ROUTES[name], **RATIOS[ratio]))
    _check(got, ref, sim_ulps=16)
    pairs = {tuple(p) for p in got.pairs[: int(got.count)].tolist()}
    assert len(pairs) > 0.5 * c["d0"].shape[0]
    # every repeated column went to its lower index
    for (lo, hi), i in zip(SETS[name][3], c["tie_rows"]):
        assert (i, hi) not in pairs
        if ratio == "ties_pass" and c["m0"][i]:
            assert (i, lo) in pairs, (i, lo)
    # of two repeated rows, only the lower passes the mutual check
    for a, b in SETS[name][4]:
        assert not any(p[0] == b for p in pairs)
    # the port's dense route selects the same pairs
    dense = _port(c, gate, MatchConfig(block_size=-1, **RATIOS[ratio]))
    _check(got, _jax_result(dense), sim_ulps=16)


def test_float_streaming_batch_equals_reference(sets):
    """Two pairs in one call, the second with its columns reversed and a
    third of its rows masked out."""
    c = sets["700x900"]
    D0 = np.stack([c["d0"], c["d0"]])
    D1 = np.stack([c["d1"], c["d1"][::-1].copy()])
    M0 = np.stack([c["m0"], c["m0"] & (np.arange(len(c["m0"])) % 3 > 0)])
    M1 = np.stack([c["m1"], c["m1"][::-1].copy()])
    kw = dict(block_size=ROUTES["700x900"], max_match=512)
    ref = jmatch.match_descriptors_batch(*(jnp.asarray(a) for a in (D0, D1, M0, M1)), JMatch(**kw))
    got = match.match_descriptors_batch(*(torch.from_numpy(a) for a in (D0, D1, M0, M1)),
                                        MatchConfig(**kw))
    for p in range(2):
        _check(type(got)(*(f[p] for f in got)), type(ref)(*(f[p] for f in ref)), sim_ulps=16)
        assert int(got.count[p]) > 0.4 * len(c["d0"])


# ---------------- the route each set takes ----------------

@pytest.mark.parametrize("n1", [4095, 4096, 4097, 9000])
@pytest.mark.parametrize("block_size", [-1, 0, 128])
def test_effective_block_is_the_reference_policy(block_size, n1):
    cfg = MatchConfig(block_size=block_size)
    assert match._effective_block(cfg, n1) == jmatch._effective_block(
        JMatch(block_size=block_size), n1)
    assert match._effective_block(cfg, 100) == jmatch._effective_block(
        JMatch(block_size=block_size), 100)


@pytest.fixture()
def recorded(monkeypatch):
    """The widths of the similarity blocks `best2_dense` selects from, and
    the calls of the kernel's wrappers."""
    calls = {"best2_dense": [], "match_best2": 0, "match_best2_gated": 0}
    best2 = match.best2_dense

    def rec(sim, *args):
        calls["best2_dense"].append(sim.shape[-1])
        return best2(sim, *args)

    def wrapper(name, fn):
        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted

    monkeypatch.setattr(match, "best2_dense", rec)
    for name in ("match_best2", "match_best2_gated"):
        monkeypatch.setattr(match, name, wrapper(name, getattr(match, name)))
    return calls


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("gate", ["none", "hf"])
def test_cpu_route_streams_above_the_threshold(recorded, gate, dtype):
    """Above `stream_threshold` (N1 = 4608 > 4096) every CPU set streams in
    1024-column blocks (the last padded), uint8 included: the plain best-2
    runs per block, never on the whole [N0, N1]; with block_size=-1 the
    same set is one block of all 4608 columns.  The kernel's wrappers are
    not called on the CPU."""
    c = _build(*SETS["256x4608"])
    if dtype == "float32":
        c = _as_float(c)
    got = _port(c, gate, MatchConfig())
    assert recorded["best2_dense"] == [1024] * 5
    recorded["best2_dense"].clear()
    dense = _port(c, gate, MatchConfig(block_size=-1))
    _check(got, _jax_result(dense), sim_ulps=16 if dtype == "float32" else 0)
    assert recorded["best2_dense"] == [4608]
    assert recorded["match_best2"] == recorded["match_best2_gated"] == 0
