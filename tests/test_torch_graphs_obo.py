"""The -obo programs and the `-v 2` stages as captured entry points
(`core/graphs.py`) on the CPU.

`frontend/extract.py` splits `extract_features_obo` into the reference's
three programs, `_obo_prep`, `_obo_octave` (o static) and `_obo_assemble`,
captured as `_obo_prep_jit`, `_obo_octave_jit` and `_obo_assemble_jit` in
one `GraphFamily` (one pool, one lock, one replay event); on the card
chip_smoke.py phase 5c holds every replay bit for bit to the eager call and
the family's pool under the fused `extract_features_jit`'s.  Here:

- on CPU tensors each program and `extract_features_obo_jit` equal their
  eager functions bit for bit, capture nothing and leave the launch
  counters as they were;
- each against the reference's compiled program on the same NumPy inputs,
  at 80x96 (tests/test_torch_pyramid.py's -obo image) and 160x192
  (tests/test_obo.py's): `_obo_prep_jit` within the pyramid budget (2e-6
  absolute, tests/test_torch_pyramid.py); `_obo_octave_jit`, fed the
  reference's base of octave o, with the same number of valid candidates
  per image and octave, its base within 2e-6, and its candidates within the
  extract budgets of tests/test_torch_extract.py (>= 99% paired within 0.5
  px per octave, sigma within 1e-2, theta max < 0.05 and cosine min > 0.995
  per octave, the theta and cosine quantiles over all octaves' pairs);
  `_obo_assemble_jit`, fed the reference's parts, bit-identical; the chain
  against the reference's `extract_features_obo` within
  tests/test_torch_pyramid.py's -obo budgets (`check_features`);
- the signature walks dicts of tensors (keys and their order are in the
  key, a dict is rebuilt with its keys) and still refuses a dict holding
  anything else;
- family members share one lock, one pool per device and one replay
  event, and a family takes a new pool where no member holds a capture;
- `profile_extraction` on the CPU: its table's keys in order, each stage's
  output equal to its plain stage's on the same inputs, nothing left
  captured.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import extract as jextract
from siftgpu_tpu_torch import SiftConfig
from siftgpu_tpu_torch.core import graphs
from siftgpu_tpu_torch.frontend import extract
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import profile

from helpers import angdiff, desc_cosine
from test_torch_extract import _pair, check_features
from test_torch_graphs import check_cpu_route, same_bits
from torch_threads import one_thread  # noqa: F401 (autouse)

SIZES = {   # name -> (image, config keywords)
    "80x96": (lambda: fixtures.random_texture(80, 96, seed=3), dict(height=80, width=96)),
    "160x192": (lambda: fixtures.random_texture(160, 192, seed=9, smooth=3),
                dict(height=160, width=192, max_keypoints=512)),
}
PYRAMID_TOL = 2e-6      # tests/test_torch_pyramid.py


@pytest.fixture(scope="module", params=sorted(SIZES))
def ref(request):
    """The reference's compiled -obo programs on one image: its bases, its
    parts and its features, and the port's config."""
    make, kw = SIZES[request.param]
    img = make()[None]
    jcfg = JConfig(**kw)
    bases = [jextract._obo_prep_jit(jnp.asarray(img), jcfg)]
    parts = []
    for o in range(jcfg.octaves):
        part, base = jextract._obo_octave_jit(bases[-1], jcfg, o)
        parts.append(part)
        bases.append(base)
    feats = jextract._obo_assemble_jit(tuple(parts), jcfg)
    return dict(img=img, cfg=SiftConfig(**kw), bases=bases, parts=parts, feats=feats)


t = lambda a: torch.from_numpy(np.array(a))


# ---------------- on the CPU each program is its eager function ----------------

def test_cpu_route_is_the_eager_function(ref):
    x, cfg = t(ref["img"]), ref["cfg"]
    check_cpu_route(extract._obo_prep_jit, extract._obo_prep, (x, cfg), {})
    base, parts = extract._obo_prep(x, cfg), []
    for o in range(cfg.octaves):
        check_cpu_route(extract._obo_octave_jit, extract._obo_octave, (base, cfg, o), {})
        part, base = extract._obo_octave(base, cfg, o)
        parts.append(part)
    check_cpu_route(extract._obo_assemble_jit, extract._obo_assemble, (tuple(parts), cfg), {})


def test_obo_chain_is_the_eager_chain(ref):
    """`extract_features_obo_jit` on CPU tensors: `extract_features_obo`'s
    bits (the same as `extract_features`' in every valid slot), nothing
    captured in the family."""
    x, cfg = t(ref["img"]), ref["cfg"]
    got = extract.extract_features_obo_jit(x, cfg)
    assert same_bits(got, extract.extract_features_obo(x, cfg))
    fused = extract.extract_features(x, cfg)
    m = fused.mask
    assert torch.equal(m, got.mask)
    assert all(torch.equal(a[m], b[m]) for a, b in zip(fused, got))
    assert extract.OBO_FAMILY.pool_bytes() == 0
    assert not any(g.captures for g in extract.OBO_FAMILY.members)


# ---------------- each program against the reference's compiled program ----------------

def test_obo_prep_jit_matches_reference(ref):
    got = extract._obo_prep_jit(t(ref["img"]), ref["cfg"])
    want = np.asarray(ref["bases"][0])
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PYRAMID_TOL)


def test_obo_octave_jit_matches_reference(ref):
    """Each octave fed the reference's base: the next base within the
    pyramid budget, the candidates within the extract budgets."""
    cfg = ref["cfg"]
    tds, cos = [], []
    for o, (base, want) in enumerate(zip(ref["bases"], ref["parts"])):
        got, nxt = extract._obo_octave_jit(t(base), cfg, o)
        assert set(got) == set(want)
        np.testing.assert_allclose(nxt.numpy(), np.asarray(ref["bases"][o + 1]), rtol=0,
                                   atol=PYRAMID_TOL)
        assert torch.equal(got["octave"], t(want["octave"]))
        for i in range(want["mask"].shape[0]):
            r, g = (_valid(p, i) for p in (want, got))
            assert len(g["x"]) == len(r["x"]), (o, i)
            pairs = _pair(r, g)
            assert len(pairs) >= 0.99 * len(r["x"]), (o, i)
            td = np.array([angdiff(r["theta"][a], g["theta"][b]) for a, b in pairs])
            c = np.array([desc_cosine(r["desc"][a], g["desc"][b]) for a, b in pairs])
            sd = np.array([abs(r["sigma"][a] - g["sigma"][b]) for a, b in pairs])
            if len(pairs):
                assert td.max() < 0.05 and c.min() > 0.995 and sd.max() < 1e-2, (o, i)
            tds.append(td)
            cos.append(c)
    tds, cos = np.concatenate(tds), np.concatenate(cos)
    assert len(tds) > 20
    assert np.quantile(tds, 0.75) < 1e-3 and np.quantile(tds, 0.9) < 2e-2
    assert np.quantile(cos, 0.25) > 0.999


def _valid(part, i):
    m = np.asarray(part["mask"])[i]
    return {k: np.asarray(part[k])[i][m] for k in ("x", "y", "sigma", "theta", "desc")}


def test_obo_assemble_jit_matches_reference(ref):
    parts = tuple({k: t(v) for k, v in p.items()} for p in ref["parts"])
    got = extract._obo_assemble_jit(parts, ref["cfg"])
    want = ref["feats"]
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert same_bits(g, t(w)), name


def test_obo_chain_matches_reference(ref):
    check_features(ref["feats"], extract.extract_features_obo_jit(t(ref["img"]), ref["cfg"]))


# ---------------- dicts in the signature ----------------

def _ident(x):
    return x


def test_signature_walks_dicts_of_tensors():
    g = graphs.graphed(_ident, "ident_jit")
    key = lambda x: g.signature(x)[0]
    a, b = torch.zeros(2, 3), torch.ones(4, dtype=torch.int32)
    base = key({"a": a, "b": b})
    assert key({"a": torch.ones(2, 3), "b": b}) == base          # values are not in it
    variants = [
        key({"b": b, "a": a}),                                      # key order
        key({"a": a, "c": b}),                                      # key names
        key({"a": a}),                                              # key count
        key({"a": a, "b": b.long()}),                               # a value's dtype
        key({"a": a[:1], "b": b}),                                  # a value's shape
        key((a, b)),                                                # not a dict
    ]
    assert len({base, *variants}) == len(variants) + 1
    leaves = []
    tree = ({"y": a, "x": b}, a)
    graphs._flatten(tree, leaves, "ident_jit")
    assert len(leaves) == 3
    new = [torch.full_like(v, 7) for v in leaves]
    back = graphs._rebuild(tree, iter(new))
    assert list(back[0]) == ["y", "x"] and type(back[0]) is dict
    assert back[0]["y"] is new[0] and back[0]["x"] is new[1] and back[1] is new[2]


def test_dict_holding_anything_else_cannot_be_hashed():
    g = graphs.graphed(_ident, "ident_jit")
    with pytest.raises(TypeError, match="ident_jit.*cannot be hashed"):
        g({"a": torch.zeros(2), "n": 3})
    with pytest.raises(TypeError, match="cannot be hashed"):
        g({"a": [torch.zeros(2)]})
    assert not g.captures


# ---------------- families ----------------

class _FakeCapture:
    def __init__(self, device, pool_bytes):
        self.device, self.pool_bytes = device, pool_bytes


def test_family_members_share_lock_pool_and_event(monkeypatch):
    fam = extract.OBO_FAMILY
    members = (extract._obo_prep_jit, extract._obo_octave_jit, extract._obo_assemble_jit)
    assert fam.members == list(members)
    assert all(g.family is fam and g._lock is fam.lock for g in members)
    alone = (graphs.graphed(_ident, "a_jit"), graphs.graphed(_ident, "b_jit"))
    assert alone[0]._lock is not alone[1]._lock and alone[0].family is None

    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool", next(handles)))
    own = graphs.GraphFamily("test")
    p, q = graphs.graphed(_ident, "p_jit", own), graphs.graphed(_ident, "q_jit", own)
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    first = own.pool(d0)
    assert own.pool(d0) != first                  # no live capture: a new pool each time
    first = own.pool(d0)
    p.captures["k"] = _FakeCapture(d0, 5 << 20)
    assert own.pool(d0) == first                  # q's capture joins p's pool
    q.captures["k"] = _FakeCapture(d0, 3 << 20)
    assert own.pool(d0) == first and own.pool(d1) != first   # one pool per device
    assert own.pool_bytes() == 8 << 20
    own.release()
    assert not p.captures and not q.captures and own.pool_bytes() == 0
    assert own.pool(d0) != first                  # released: the next capture takes a new pool


# ---------------- the -v 2 stages ----------------

def test_profile_extraction_stages_are_the_plain_stages(monkeypatch):
    """On the CPU: the table's keys in order; each stage made for the call
    as a family member, its output equal to the plain stage's on the same
    inputs; no capture left."""
    made, calls = [], []
    real = graphs.graphed

    def recording(fn, name, family=None):
        g = real(fn, name, family)
        made.append(g)

        def call(*args):
            out = g(*args)
            calls.append((fn, args, out))
            return out

        return call

    monkeypatch.setattr(profile.graphs, "graphed", recording)
    img = np.stack([fixtures.random_texture(80, 96, seed=s) for s in (3, 4)])
    cfg = SiftConfig(height=80, width=96, max_keypoints=128)
    times = profile.profile_extraction(torch.from_numpy(img), cfg, iters=1)
    assert list(times) == ["pyramid", "detect", "gradients", "orient+desc", "assemble",
                           "match", "TOTAL"]
    assert all(v >= 0.0 for v in times.values())
    assert [g.fn for g in made] == list(profile.STAGES.values())
    fams = {id(g.family) for g in made}
    assert len(fams) == 1 and made[0].family is not None
    assert not any(g.captures for g in made)
    assert {fn for fn, _, _ in calls} == set(profile.STAGES.values())
    assert len(calls) == 2 * len(profile.STAGES)  # a warm-up and one timed call each
    for fn, args, out in calls:
        assert same_bits(out, fn(*args)), fn.__name__
