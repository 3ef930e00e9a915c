"""The captured entry points (`core/graphs.py`) on the CPU.

A `_jit` entry point captures a CUDA graph once per signature on CUDA
inputs (chip_smoke.py phase 5c holds every replay bit for bit to the eager
port on the card); on CPU inputs it calls its eager function and captures
nothing.  Here:

- the signature separates shape, dtype, device, None-ness, the config and
  static scalars, and nothing else; an argument that cannot be hashed and
  tensors on two devices raise;
- launches recorded under `_build.tally_launches` (a capture) are counted
  into the tally, in that thread only, and added by `add_launches`;
- on CPU tensors each entry point equals its eager function bit for bit,
  leaves its cache empty and the launch counters as they were;
- each entry point against the reference's compiled counterpart on the
  same NumPy inputs, within the budgets of the eager tests: extraction
  under tests/test_torch_extract.py's `check_features`; the matchers' pairs
  and counts bit-identical on the same uint8 descriptors; PnP as
  tests/test_torch_pnp.py (pose within 1e-5, inliers equal, RMS within
  1e-4 px); BA as tests/test_torch_ba.py (final cost within 1e-3 relative,
  camera 0 frozen exactly); the tracking step's features under
  `check_features` and its pairs, whose frame descriptors differ from the
  reference's by up to one step, with >= 95% of the reference's pairs found
  at the same keyframe keypoint within 0.5 px and counts within 5%.

The frames are tests/test_torch_extract.py's 120x160 shifted pair (K =
512), so the reference's extraction compiles once for both files (the
persistent compilation cache).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu import SiftConfig as JConfig
from siftgpu_tpu import extract_features_jit as j_extract_jit
from siftgpu_tpu.frontend import match as jmatch
from siftgpu_tpu.optim import ba as jba
from siftgpu_tpu.optim import pnp as jpnp
from siftgpu_tpu.pipeline import slam as jslam
from siftgpu_tpu.core.config import MatchConfig as JMatch
import siftgpu_tpu_torch
from siftgpu_tpu_torch import MatchConfig, SiftConfig
from siftgpu_tpu_torch.convert import tree_to_torch
from siftgpu_tpu_torch.core import graphs
from siftgpu_tpu_torch.frontend import extract, match
from siftgpu_tpu_torch.ops import _build
from siftgpu_tpu_torch.optim import ba, pnp
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import slam

from test_ba import _make_problem
from test_torch_extract import SHIFT, check_features
from test_torch_pnp import _outliers

H, W, K = 120, 160, 512


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: beside the suite's other workers, intra-op threads
    only contend (this file's 18 s alone took 179 s in a 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    img0 = fixtures.random_texture(H, W, seed=42)
    return np.stack([img0, fixtures.warp_affine(img0, np.eye(2), np.array(SHIFT))])


@pytest.fixture(scope="module")
def ref_feats(frames):
    """The reference's compiled extraction of both frames."""
    return j_extract_jit(jnp.asarray(frames), JConfig(height=H, width=W, max_keypoints=K))


def cfgs():
    return SiftConfig(height=H, width=W, max_keypoints=K), MatchConfig(max_match=K)


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same_bits, a, b))
    return a == b


# ---------------- the signature ----------------

def _fn(x, y=None, cfg=MatchConfig(), n=2, s=1.0):
    return x


def test_signature_separates_what_jit_separates():
    g = graphs.graphed(_fn, "fn_jit")
    key = lambda *a, **kw: g.signature(*a, **kw)[0]
    x = torch.zeros(2, 3)
    base = key(x)
    assert key(torch.ones(2, 3)) == base                      # values are not in it
    assert key(x, None, MatchConfig(), 2, 1.0) == base        # defaults applied
    assert key(x, cfg=MatchConfig()) == base                  # configs by value
    variants = [
        key(torch.zeros(3, 3)),                               # shape
        key(torch.zeros(2, 3, dtype=torch.float64)),          # dtype
        key(torch.zeros(2, 3, device="meta")),                # device
        key(x, torch.zeros(2)),                               # None-ness
        key(x, cfg=MatchConfig(max_match=7)),                 # config
        key(x, n=3),                                          # static int
        key(x, s=2.0),                                        # static float
        key(x, n=2.0),                                        # static type
    ]
    assert len({base, *variants}) == len(variants) + 1


def test_signature_walks_named_tuples():
    """A BAProblem's tensors are in the signature, and so is whether its
    optional `pt_fixed` is None."""
    prob, _, _ = _make_problem(seed=3)
    p = tree_to_torch(prob, ba.BAProblem)
    key = lambda q: ba.run_ba_jit.signature(q, iters=5, n_cg=20)[0]
    _, _, leaves = ba.run_ba_jit.signature(p)
    assert len(leaves) == sum(f is not None for f in p)
    fixed = p._replace(pt_fixed=torch.zeros(p.points.shape[0], dtype=torch.bool))
    assert key(p) != key(fixed)
    assert key(p) != key(p._replace(uv=p.uv[:-1], cam_idx=p.cam_idx[:-1],
                                    pt_idx=p.pt_idx[:-1], w=p.w[:-1]))
    assert key(p) == key(p._replace(cams=p.cams + 1.0))


def test_unhashable_argument_raises():
    g = graphs.graphed(_fn, "fn_jit")
    with pytest.raises(TypeError, match="fn_jit.*cannot be hashed"):
        g(torch.zeros(2), n=np.zeros(3))
    with pytest.raises(TypeError, match="cannot be hashed"):
        g(torch.zeros(2), s={"a": 1})
    assert not g.captures


def test_mixed_devices_raise():
    g = graphs.graphed(_fn, "fn_jit")
    with pytest.raises(ValueError, match="fn_jit: tensors on more than one device"):
        g(torch.zeros(2), torch.zeros(2, device="meta"))
    assert not g.captures


# ---------------- launch counts under capture ----------------

def test_launches_under_a_capture_go_to_its_tally(monkeypatch):
    """A fake kernel (no library, no card) through `Kernel.launch`."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0, raising=False)
    kern = object.__new__(_build.Kernel)          # not registered in KERNELS
    kern.name, kern.launches, kern._lib = "fake", 0, object()
    kern._fns = {"go": lambda *args: 0}
    dev = torch.device("cuda", 0)
    kern.launch("go", dev, 1)
    assert kern.launches == 1
    with _build.tally_launches() as tally:
        kern.launch("go", dev, 1)
        kern.launch("go", dev, 1)
        other = threading.Thread(target=kern.launch, args=("go", dev, 1))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    assert tally == {kern: 2} and kern.launches == 2   # the other thread's launch counted
    _build.add_launches(tally)
    _build.add_launches(tally)
    assert kern.launches == 6
    kern.launch("go", dev, 1)
    assert kern.launches == 7                          # the tally ended with its block


# ---------------- each entry point on the CPU equals its eager function ----------------

def _eager_cases(frames, ref_feats):
    cfg, mcfg = cfgs()
    imgs = torch.from_numpy(frames)
    d = torch.from_numpy(np.array(ref_feats.desc))
    m = torch.from_numpy(np.array(ref_feats.mask))
    prob, _, _ = _make_problem(seed=3)
    X, uv, w, intr, kw = _outliers()
    t = torch.from_numpy
    return {
        "extract": (extract.extract_features_jit, extract.extract_features, (imgs, cfg), {}),
        "match": (match.match_descriptors_jit, match.match_descriptors,
                  (d[0], d[1], m[0], m[1], mcfg), {}),
        "match_batch": (match.match_descriptors_batch_jit, match.match_descriptors_batch,
                        (d[:1], d[1:], m[:1], m[1:], mcfg), {}),
        "track_step": (slam._track_step_jit, slam._track_step, (imgs[1], d[:1], m[:1], cfg, mcfg),
                       {}),
        "match_kf": (slam._match_kf_jit, slam._match_kf, (d, m, d[1], m[1], mcfg), {}),
        "loop_match": (slam._loop_match_jit, slam._loop_match, (d, m, d[0], m[0], mcfg), {}),
        "pnp": (pnp.pnp_gn_jit, pnp.pnp_gn, (t(X), t(uv), t(w), t(intr), torch.zeros(6)), kw),
        "ba": (ba.run_ba_jit, ba.run_ba, (tree_to_torch(prob, ba.BAProblem),),
               dict(iters=5, n_cg=20)),
    }


@pytest.mark.parametrize("name", ["extract", "match", "match_batch", "track_step", "match_kf",
                                  "loop_match", "pnp", "ba"])
def test_cpu_route_is_the_eager_function(name, frames, ref_feats):
    jit, eager, args, kw = _eager_cases(frames, ref_feats)[name]
    before = {n: k.launches for n, k in _build.KERNELS.items()}
    got = jit(*args, **kw)
    assert same_bits(got, eager(*args, **kw))
    assert not jit.captures
    assert {n: k.launches for n, k in _build.KERNELS.items()} == before


def test_extract_features_jit_is_exported():
    assert siftgpu_tpu_torch.extract_features_jit is extract.extract_features_jit
    assert "extract_features_jit" in siftgpu_tpu_torch.__all__


# ---------------- each entry point against the reference's compiled counterpart ----------------

def test_extract_features_jit_matches_reference(frames, ref_feats):
    check_features(ref_feats, extract.extract_features_jit(torch.from_numpy(frames), cfgs()[0]))


def test_match_descriptors_jit_matches_reference(ref_feats):
    d, m = np.array(ref_feats.desc), np.array(ref_feats.mask)
    ref = jmatch.match_descriptors(jnp.asarray(d[0]), jnp.asarray(d[1]), jnp.asarray(m[0]),
                                   jnp.asarray(m[1]), JMatch(max_match=K))
    got = match.match_descriptors_jit(*map(torch.from_numpy, (d[0], d[1], m[0], m[1])),
                                      cfgs()[1])
    assert int(got.count) == int(ref.count) > 50
    np.testing.assert_array_equal(got.pairs.numpy(), np.asarray(ref.pairs))


def test_match_descriptors_batch_jit_matches_reference(ref_feats):
    d, m = np.array(ref_feats.desc), np.array(ref_feats.mask)
    ref = jmatch.match_descriptors_batch(jnp.asarray(d[:1]), jnp.asarray(d[1:]),
                                         jnp.asarray(m[:1]), jnp.asarray(m[1:]),
                                         JMatch(max_match=K))
    got = match.match_descriptors_batch_jit(*map(torch.from_numpy, (d[:1], d[1:], m[:1], m[1:])),
                                            cfgs()[1])
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(got.pairs.numpy(), np.asarray(ref.pairs))


@pytest.mark.parametrize("name", ["match_kf", "loop_match"])
def test_keyframe_matches_match_reference(name, ref_feats):
    """`_match_kf_jit` / `_loop_match_jit`: frame 1's descriptors against
    both frames' as keyframe (archive) rows."""
    d, m = np.array(ref_feats.desc), np.array(ref_feats.mask)
    jfn = jslam._match_kf_jit if name == "match_kf" else jslam._loop_match_jit
    tfn = slam._match_kf_jit if name == "match_kf" else slam._loop_match_jit
    rp, rc = jfn(jnp.asarray(d), jnp.asarray(m), jnp.asarray(d[1]), jnp.asarray(m[1]),
                 JMatch(max_match=K))
    gp, gc = tfn(*map(torch.from_numpy, (d, m, d[1], m[1])), cfgs()[1])
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))


def test_pnp_gn_jit_matches_reference():
    X, uv, w, intr, kw = _outliers()
    ref = jpnp.pnp_gn(*map(jnp.asarray, (X, uv, w, intr)), jnp.zeros(6), **kw)
    res = pnp.pnp_gn_jit(*map(torch.from_numpy, (X, uv, w, intr)), torch.zeros(6), **kw)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(ref.inliers))
    assert int(res.num_inliers) == int(ref.num_inliers)
    assert abs(float(res.rms) - float(ref.rms)) < 1e-4


def test_run_ba_jit_matches_reference():
    """tests/test_torch_ba.py's "frozen" case."""
    prob, _, _ = _make_problem(seed=3)
    ref = jba.run_ba(prob, iters=5, n_cg=20)
    p = tree_to_torch(prob, ba.BAProblem)
    got = ba.run_ba_jit(p, iters=5, n_cg=20)
    c0, cr, cg = float(ba._cost(p, p.cams, p.points)), float(ref.cost), float(got.cost)
    assert abs(cg - cr) <= max(1e-3 * cr, 1e-6 * c0), (cg, cr, c0)
    assert torch.equal(got.cams[0], p.cams[0])


def test_track_step_jit_matches_reference(frames, ref_feats):
    """Frame 1 tracked against frame 0's reference features as the one live
    keyframe, through both packages' compiled steps."""
    d, m = np.array(ref_feats.desc[:1]), np.array(ref_feats.mask[:1])
    cfg, mcfg = cfgs()
    rf, rp, rc = jslam._track_step_jit(jnp.asarray(frames[1]), jnp.asarray(d), jnp.asarray(m),
                                       JConfig(height=H, width=W, max_keypoints=K),
                                       JMatch(max_match=K))
    gf, gp, gc = slam._track_step_jit(torch.from_numpy(frames[1]), torch.from_numpy(d),
                                      torch.from_numpy(m), cfg, mcfg)
    check_features(rf, gf)
    n_ref, n_got = int(rc[0]), int(gc[0])
    assert n_ref > 50 and abs(n_got - n_ref) <= 0.05 * n_ref
    rp, gp = np.asarray(rp[0, :n_ref]), gp[0, :n_got].numpy()
    rx, ry = np.asarray(rf.x[0]), np.asarray(rf.y[0])
    gx, gy = gf.x[0].numpy(), gf.y[0].numpy()
    found = 0
    for kf_i, fr_i in rp:
        same_kf = gp[gp[:, 0] == kf_i, 1]
        found += bool(len(same_kf)) and bool(
            (np.hypot(gx[same_kf] - rx[fr_i], gy[same_kf] - ry[fr_i]) < 0.5).any())
    assert found >= 0.95 * n_ref, (found, n_ref)
