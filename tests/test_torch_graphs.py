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
- a torch.Generator is in the signature by its device only (a new object
  replays the same capture), and one on another device than the tensors
  is refused as mixed devices;
- each entry point against the reference's compiled counterpart on the
  same NumPy inputs, within the budgets of the eager tests: extraction
  under tests/test_torch_extract.py's `check_features`; the matchers' pairs
  and counts bit-identical on the same uint8 descriptors; PnP as
  tests/test_torch_pnp.py (pose within 1e-5, inliers equal, RMS within
  1e-4 px); BA as tests/test_torch_ba.py (final cost within 1e-3 relative,
  camera 0 frozen exactly); the tracking step's features under
  `check_features` and its pairs, whose frame descriptors differ from the
  reference's by up to one step, with >= 95% of the reference's pairs found
  at the same keyframe keypoint within 0.5 px and counts within 5%; guided
  matching as tests/test_torch_guided.py (pairs and count bit-identical,
  winner similarities within 4 ulp) on its [300, 900] sets under H, F and
  H+F; descriptor-only mode as tests/test_torch_sampler.py (mask and octave
  equal, descriptors within 1 step); two-view on tests/test_torch_twoview.py's
  160x200 scene, where the draws differ (a torch.Generator against a JAX
  key): tests/test_twoview.py's ground-truth bounds, match counts equal to
  the reference's, inliers within 1% and the rotation within 1e-3 rad of
  its.

The frames are tests/test_torch_extract.py's 120x160 shifted pair (K =
512), so the reference's extraction compiles once for both files (the
persistent compilation cache).
"""

import threading

import jax
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
from siftgpu_tpu.frontend.redetect import describe_at_keypoints as j_describe_at_keypoints
from siftgpu_tpu.oracle import fixtures as jfixtures
from siftgpu_tpu.pipeline import twoview as jtwoview
import siftgpu_tpu_torch
from siftgpu_tpu_torch import MatchConfig, SiftConfig
from siftgpu_tpu_torch.convert import keypoints_from_reference, matrix_to_torch, tree_to_torch
from siftgpu_tpu_torch.core import graphs
from siftgpu_tpu_torch.frontend import extract, match, redetect
from siftgpu_tpu_torch.geometry import epipolar
from siftgpu_tpu_torch.ops import _build
from siftgpu_tpu_torch.optim import ba, pnp
from siftgpu_tpu_torch.optim import pose_graph as pg
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import slam, twoview

import chip_smoke
import test_torch_twoview as ttv
from test_ba import _make_problem
from test_geometry import _synthetic_two_view
from test_torch_extract import SHIFT, check_features
from test_torch_guided import GATES, _kernel_sets
from test_torch_match import _check
from test_torch_pnp import _outliers
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W, K = 120, 160, 512


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
    if isinstance(a, dict):
        return type(a) is type(b) and list(a) == list(b) and all(map(same_bits, a.values(),
                                                                      b.values()))
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


def test_generator_is_state_not_signature():
    """A generator's place in the signature is its device: new objects in
    any state give one key (they replay one capture), and a generator on
    another device than the tensors is refused before anything runs."""
    cfg, mcfg = cfgs()
    jit = twoview.two_view_reconstruct_jit
    sig = lambda g, dev="cpu": jit.signature(torch.zeros(2, H, W, device=dev),
                                             torch.zeros(4, device=dev), cfg, mcfg, g)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    torch.rand(5, generator=g2)
    assert sig(g1)[0] == sig(g2)[0] == sig(torch.Generator())[0]
    assert sig(g1)[2][-1] is g1                   # a leaf: its state is copied at each replay
    assert sig(g1)[0] != sig(g1, "meta")[0]
    with pytest.raises(ValueError, match="two_view_reconstruct_jit: tensors on more than one "
                                         "device"):
        jit(*sig(g1, "meta")[1].args)
    assert not jit.captures


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
    x0, x1, *_ = _synthetic_two_view(120, seed=2, noise=1e-4, outliers=30)
    t = torch.from_numpy
    loc = torch.from_numpy(np.stack([np.array(ref_feats.x), np.array(ref_feats.y)], -1))
    kp = torch.from_numpy(np.stack([np.array(getattr(ref_feats, f)) for f in
                                    ("x", "y", "sigma", "theta")], -1))
    Hm = torch.tensor([[1.0, 0.0, SHIFT[0]], [0.0, 1.0, SHIFT[1]], [0.0, 0.0, 1.0]])
    Fm = torch.tensor([[0.0, 0.0, SHIFT[1]], [0.0, 0.0, -SHIFT[0]], [-SHIFT[1], SHIFT[0], 0.0]])
    guided = lambda h, f: (match.guided_match_descriptors_jit, match.guided_match_descriptors,
                           (d[0], d[1], loc[0], loc[1], h, f, m[0], m[1]),
                           dict(hdist_max=3.0, fdist_max=2.0, cfg=mcfg))
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
        "two_view": (twoview.two_view_reconstruct_jit, twoview.two_view_reconstruct,
                     (imgs, torch.tensor([180.0, 180.0, W / 2.0, H / 2.0]), cfg, mcfg,
                      torch.Generator().manual_seed(7)), {}),
        "guided_h": guided(Hm, None),
        "guided_f": guided(None, Fm),
        "guided_hf": guided(Hm, Fm),
        "describe": (redetect.describe_at_keypoints_jit, redetect.describe_at_keypoints,
                     (imgs[:1], kp[:1], cfg), {}),
        "refine_points": (ba.refine_points_jit, ba.refine_points,
                          (tree_to_torch(prob, ba.BAProblem),), dict(iters=3)),
        "pose_graph": (pg.optimize_pose_graph_jit, pg.optimize_pose_graph,
                       (pg.PoseGraph(*map(t, chip_smoke.circle_graphs(n=12)["se3"])),),
                       dict(iters=chip_smoke.PG_ITERS)),
        "ransac": (epipolar.ransac_essential_jit, epipolar.ransac_essential,
                   (t(np.array(x0)), t(np.array(x1)), torch.ones(x0.shape[0], dtype=torch.bool),
                    torch.Generator().manual_seed(0)),
                   dict(num_hypotheses=256, threshold=torch.full((), 1e-5))),
    }


@pytest.mark.parametrize("name", ["extract", "match", "match_batch", "track_step", "match_kf",
                                  "loop_match", "pnp", "ba", "two_view", "guided_h", "guided_f",
                                  "guided_hf", "describe", "refine_points", "pose_graph",
                                  "ransac"])
def test_cpu_route_is_the_eager_function(name, frames, ref_feats):
    check_cpu_route(*_eager_cases(frames, ref_feats)[name])


def check_cpu_route(jit, eager, args, kw):
    """jit on CPU inputs: the eager function's bits, its generators left
    where the eager call leaves them, nothing captured, no launch counted."""
    before = {n: k.launches for n, k in _build.KERNELS.items()}
    gens = [a for a in args if isinstance(a, torch.Generator)]
    states = [g.get_state() for g in gens]
    got = jit(*args, **kw)
    after = [g.get_state() for g in gens]
    for g, st in zip(gens, states):             # the eager call draws from the same state
        g.set_state(st)
    assert same_bits(got, eager(*args, **kw))
    assert all(torch.equal(a, g.get_state()) for a, g in zip(after, gens))
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


@pytest.mark.parametrize("gate", sorted(GATES))
def test_guided_match_descriptors_jit_matches_reference(gate):
    """tests/test_torch_guided.py's [300, 900] sets through both compiled
    guided matchers."""
    c = _kernel_sets()
    use_h, use_f = GATES[gate]
    ref = jmatch.guided_match_descriptors(
        *map(jnp.asarray, (c["d0"], c["d1"], c["loc0"], c["loc1"])),
        H=jnp.asarray(c["H"]) if use_h else None, F=jnp.asarray(c["F"]) if use_f else None,
        mask0=jnp.asarray(c["m0"]), mask1=jnp.asarray(c["m1"]), hdist_max=c["hdist"],
        fdist_max=c["fdist"], cfg=JMatch(max_match=c["max_match"], block_size=-1,
                                         use_pallas=False))
    got = match.guided_match_descriptors_jit(
        *map(torch.from_numpy, (c["d0"], c["d1"], c["loc0"], c["loc1"])),
        H=matrix_to_torch(c["H"]) if use_h else None,
        F=matrix_to_torch(c["F"]) if use_f else None,
        mask0=torch.from_numpy(c["m0"]), mask1=torch.from_numpy(c["m1"]), hdist_max=c["hdist"],
        fdist_max=c["fdist"], cfg=MatchConfig(max_match=c["max_match"]))
    _check(got, ref, sim_ulps=4)
    assert int(got.count) > 0


def test_describe_at_keypoints_jit_matches_reference(frames, ref_feats):
    """Frame 0's own keypoints described again by both compiled functions."""
    keys = keypoints_from_reference(ref_feats)[None]
    ref = j_describe_at_keypoints(jnp.asarray(frames[:1]), jnp.asarray(keys),
                                  JConfig(height=H, width=W, max_keypoints=K))
    got = redetect.describe_at_keypoints_jit(torch.from_numpy(frames[:1]),
                                             torch.from_numpy(keys), cfgs()[0])
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.octave.numpy(), np.asarray(ref.octave))
    assert np.abs(got.desc.numpy().astype(int) - np.asarray(ref.desc).astype(int)).max() <= 1
    assert int(got.mask.sum()) > 50


def test_two_view_reconstruct_jit_matches_reference():
    """tests/test_torch_twoview.py's 160x200 scene through both compiled
    two-view programs (their draws differ)."""
    img0, img1, meta = fixtures.two_plane_stereo(ttv.H, ttv.W, ttv.INTR, ttv.RVEC, ttv.T_GT, seed=2)
    j0, j1, _ = jfixtures.two_plane_stereo(ttv.H, ttv.W, ttv.INTR, ttv.RVEC, ttv.T_GT, seed=2)
    ref = jtwoview.two_view_reconstruct(
        jnp.stack([jnp.asarray(j0), jnp.asarray(j1)]), jnp.asarray(ttv.INTR, jnp.float32),
        JConfig(height=ttv.H, width=ttv.W, max_keypoints=1024), JMatch(max_match=1024),
        jax.random.PRNGKey(7))
    got = twoview.two_view_reconstruct_jit(
        torch.from_numpy(np.stack([img0, img1])), torch.tensor(ttv.INTR, dtype=torch.float32),
        SiftConfig(height=ttv.H, width=ttv.W, max_keypoints=1024), MatchConfig(max_match=1024),
        torch.Generator().manual_seed(7))
    ttv._check_ground_truth(got, meta["R"])
    assert int(got.num_matches) == int(ref.num_matches)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 0.01 * int(ref.num_inliers)
    assert ttv._rot_angle(got.R.numpy(), np.asarray(ref.R)) < 1e-3
