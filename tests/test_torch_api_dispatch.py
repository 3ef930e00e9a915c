"""Which entry points the facade (`pipeline/api.py`) and the CLI's
`twoview` call: where the reference calls a compiled program, the port
calls the captured counterpart (`core/graphs.py`), on the CPU at a
144x192 scene.  No JAX: the reference is not run here.

Each captured entry point is wrapped by a counting pass-through, and each
eager function by a counter of the calls made to it by name.  Then:

- `run_sift` goes through the facade's `extract_features_jit`, one
  signature a size; with -obo through -obo's three `_obo_*_jit` programs;
- `create_context` with `-p WxH` calls the same entry point at that size,
  with the signature that `run_sift` then calls at that size;
- `run_sift_with_keypoints` goes through `describe_at_keypoints_jit`;
- `get_sift_match` and `get_guided_sift_match` (H, F, H+F) go through
  `match_descriptors_jit` and `guided_match_descriptors_jit`, one
  signature each, H and F by whether they are None;
- the server's RUNSIFT, RUNSIFT_WITH_KEYPOINTS, GET_MATCH and
  GET_GUIDED_MATCH, and the CLI's `extract`, `match` and `twoview`
  (`--cpu`), reach the same entry points;
- no caller calls the eager functions by name, and every result equals
  bit for bit the facade's with the eager functions patched back in
  (`unittest.mock.patch.object`, as chip_smoke.py phases 4b and 4e do on
  the card);
- descriptor-only mode pads the keypoint list to `api.describe_rows(N)`
  rows and keeps N: bit for bit the eager describe of the N keypoints;
- a family with a `limit` holds at most that many captures a device, the
  least recently used dropped first (faked captures: none exists on the
  CPU); the facade's and -obo's families are so bounded.

On CPU tensors a captured entry point calls its eager function, so these
tests pin the dispatch, not the captures.
"""

import contextlib
import io
import queue
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from siftgpu_tpu_torch import SiftConfig
from siftgpu_tpu_torch.core import graphs
from siftgpu_tpu_torch.core import image as imio
from siftgpu_tpu_torch.frontend import extract, match, redetect
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import api, cli, server, twoview
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W = 144, 192
PRE = (96, 128)                  # the -p size (height, width)
ARGV = ["-tc", "512"]
MAX_SIFT = 512
SHIFT = (6.0, -3.0)
HM = np.array([[1, 0, SHIFT[0]], [0, 1, SHIFT[1]], [0, 0, 1]], np.float32)
FM = np.array([[0, 0, SHIFT[1]], [0, 0, -SHIFT[0]], [-SHIFT[1], SHIFT[0], 0]], np.float32)
GUIDED = {"H": dict(H=HM, hdistmax=3.0), "F": dict(F=FM, fdistmax=2.0),
          "H+F": dict(H=HM, F=FM, hdistmax=3.0, fdistmax=2.0)}

# module, captured entry point, the eager function it captures
CAPTURED = (
    (api, "extract_features_jit", extract.extract_features),
    (api, "extract_features_obo_jit", extract.extract_features_obo),
    (api, "describe_at_keypoints_jit", redetect.describe_at_keypoints),
    (api, "match_descriptors_jit", match.match_descriptors),
    (api, "guided_match_descriptors_jit", match.guided_match_descriptors),
    (twoview, "two_view_reconstruct_jit", twoview.two_view_reconstruct),
)
# -obo's programs, called by `extract_features_obo_jit` by these names
OBO = ("_obo_prep_jit", "_obo_octave_jit", "_obo_assemble_jit")
# the eager functions by the names a caller would call them by
EAGER = ((api, "extract_features"), (api, "describe_at_keypoints"), (api, "match_descriptors"),
         (api, "guided_match_descriptors"), (extract, "extract_features_obo"),
         (twoview, "two_view_reconstruct"))


class Counted:
    """A pass-through that records each call's arguments, signature key and
    result."""

    def __init__(self, fn):
        self.fn, self.calls, self.keys, self.outs = fn, [], [], []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        if hasattr(self.fn, "signature"):
            self.keys.append(self.fn.signature(*args, **kwargs)[0])
        out = self.fn(*args, **kwargs)
        self.outs.append(out)
        return out


@contextlib.contextmanager
def counting():
    """Every captured entry point, -obo program and eager function wrapped
    by a `Counted`; yields {name: Counted}."""
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in [(m, n) for m, n, _ in CAPTURED] + [(extract, n) for n in OBO] + list(EAGER):
            counts[name] = Counted(getattr(mod, name))
            mp.setattr(mod, name, counts[name])
        yield counts


@contextlib.contextmanager
def eager():
    """The eager functions patched in for the captured entry points."""
    with contextlib.ExitStack() as stack:
        for mod, name, fn in CAPTURED:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def _frames():
    a = fixtures.random_texture(H, W, seed=42)
    return a, fixtures.warp_affine(a, np.eye(2), np.array(SHIFT))


def _facade_calls(frames):
    """The facade's calls: two frames, -obo, -p then a frame at that size,
    descriptor-only on frame 0's keypoints, plain and guided matching.
    Returns {call: its outputs as NumPy arrays}."""
    api.release_captures()
    out = {}
    s = api.SiftTPU(ARGV, device="cpu")
    feats = []
    for i, img in enumerate(frames):
        s.run_sift(img)
        feats.append(s.get_feature_vector())
        out[f"run_sift {i}"] = feats[-1]
    obo = api.SiftTPU(ARGV + ["-obo"], device="cpu")
    obo.run_sift(frames[0])
    out["-obo"] = obo.get_feature_vector()
    pre = api.SiftTPU(ARGV + ["-p", f"{PRE[1]}x{PRE[0]}"], device="cpu")
    assert pre.create_context() == api.SIFTGPU_FULL_SUPPORTED
    pre.run_sift(frames[0][: PRE[0], : PRE[1]])
    out["-p"] = pre.get_feature_vector()
    s.set_keypoint_list(feats[0][0])
    s.run_sift_with_keypoints(frames[0])
    out["describe"] = tuple(t.numpy() for t in s._feats)
    m = api.SiftMatchTPU(max_sift=MAX_SIFT, device="cpu")
    for i, (k, d) in enumerate(feats):
        m.set_descriptors(i, d)
        m.set_feature_location(i, k)
    out["match"] = (m.get_sift_match(),)
    for label, kw in GUIDED.items():
        out[f"guided {label}"] = (m.get_guided_sift_match(**kw),)
    return out


def _server_calls(frames, keys0):
    """RUNSIFT on both frames, RUNSIFT_WITH_KEYPOINTS, GET_MATCH and
    GET_GUIDED_MATCH (H) on the port's server in a thread."""
    q = queue.Queue()
    t = threading.Thread(target=server.serve, args=(0,), daemon=True,
                         kwargs=dict(argv=ARGV, max_sift=MAX_SIFT, device="cpu", _ready_cb=q.put))
    t.start()
    combo = server.RemoteComboSiftTPU("127.0.0.1", q.get(timeout=60), timeout=120)
    try:
        out = {}
        feats = []
        for i, img in enumerate(frames):
            combo.sift.run_sift(img)
            feats.append(combo.sift.get_feature_vector())
            out[f"RUNSIFT {i}"] = feats[-1]
        for i, (k, d) in enumerate(feats):
            combo.matcher.set_descriptors(i, d)
            combo.matcher.set_feature_location(i, k)
        out["GET_MATCH"] = (combo.matcher.get_sift_match(),)
        out["GET_GUIDED_MATCH"] = (combo.matcher.get_guided_sift_match(**GUIDED["H"]),)
        combo.sift.set_keypoint_list(keys0)
        combo.sift.run_sift_with_keypoints(frames[0])
        out["RUNSIFT_WITH_KEYPOINTS"] = combo.sift.get_feature_vector()
    finally:
        combo.shutdown()
        t.join(timeout=60)
    assert not t.is_alive()
    return out


def _cli_calls(tmp):
    """The CLI's `extract`, `match` and `twoview` with --cpu: {subcommand:
    (printed lines, written bytes)}."""
    a, b = _frames()
    imio.save_pgm(str(tmp / "a.pgm"), a)
    imio.save_pgm(str(tmp / "b.pgm"), b)
    intr = (170.0, 170.0, W / 2.0, H / 2.0)
    p0, p1, _ = fixtures.two_plane_stereo(H, W, intr, [0.01, -0.03, 0.005], [-0.4, 0.05, 0.02],
                                          d_near=5.0, d_far=10.0, seed=2)
    np.save(tmp / "p0.npy", p0)
    np.save(tmp / "p1.npy", p1)
    runs = {"extract": ["extract", str(tmp / "a.pgm"), "--out", str(tmp / "a.sift")],
            "match": ["match", str(tmp / "a.pgm"), str(tmp / "b.pgm")],
            "twoview": ["twoview", str(tmp / "p0.npy"), str(tmp / "p1.npy"), "--focal", "170",
                        "--seed", "7"]}
    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv + ARGV + ["--cpu"]) == 0
        printed = buf.getvalue()
        # extract: its count (the line goes on with a host time) and its file
        out[name] = ((printed.split()[0], (tmp / "a.sift").read_bytes()) if name == "extract"
                     else printed)
    return out


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def facade(frames):
    """The facade's calls: counted, and eager-patched."""
    with counting() as c:
        got = _facade_calls(frames)
    with eager():
        ref = _facade_calls(frames)
    return got, c, ref


@pytest.fixture(scope="module")
def served(frames, facade):
    """The server's calls: counted, and eager-patched."""
    keys0 = facade[0]["run_sift 0"][0]
    with counting() as c:
        got = _server_calls(frames, keys0)
    with eager():
        ref = _server_calls(frames, keys0)
    return got, c, ref


@pytest.fixture(scope="module")
def commands(tmp_path_factory):
    """The CLI's subcommands: counted, and eager-patched."""
    with counting() as c:
        got = _cli_calls(tmp_path_factory.mktemp("counted"))
    with eager():
        ref = _cli_calls(tmp_path_factory.mktemp("eager"))
    return got, c, ref


def _size(key):
    cfg = dict(key)["cfg"][1]
    return cfg.height, cfg.width


def _no_eager_call(c):
    called = {name: len(c[name].calls) for _, name in EAGER if c[name].calls}
    assert not called, f"called the eager functions by name: {called}"


def test_run_sift_replays_the_facade_extract(facade, frames):
    _, c, _ = facade
    ex = c["extract_features_jit"]
    shapes = [tuple(a[0].shape) for a, _ in ex.calls]
    # two frames, then -p's create_context and its frame at 96x128
    assert shapes == [(1, H, W), (1, H, W), (1, *PRE), (1, *PRE)]
    assert [_size(k) for k in ex.keys] == [(H, W), (H, W), PRE, PRE]
    assert len(set(ex.keys)) == 2, "one signature a size"
    _no_eager_call(c)


def test_obo_replays_the_obo_programs(facade):
    _, c, _ = facade
    assert len(c["extract_features_obo_jit"].calls) == 1
    octaves = api.SiftTPU(ARGV, device="cpu").config_for(H, W).octaves
    assert [len(c[n].calls) for n in OBO] == [1, octaves, 1]
    assert [k[2] for k in c["_obo_octave_jit"].keys] == [("o", (int, o)) for o in range(octaves)]
    assert all(_size(k) == (H, W) for n in OBO for k in c[n].keys)


def test_prealloc_captures_the_signature_run_sift_replays(facade):
    _, c, _ = facade
    ex = c["extract_features_jit"]
    assert ex.keys[2] == ex.keys[3], "-p's call and the first run_sift at its size differ"
    assert not ex.calls[2][0][0].any(), "-p runs the extraction on a blank image"


def test_descriptor_only_replays_the_captured_describe(facade):
    got, c, _ = facade
    d = c["describe_at_keypoints_jit"]
    assert len(d.calls) == 1
    (images, keys, cfg), _ = d.calls[0]
    n = len(got["run_sift 0"][0])
    assert tuple(images.shape) == (1, H, W) and tuple(keys.shape) == (1, api.describe_rows(n), 4)
    assert not keys[0, n:].any(), "the padded rows are zeros (sigma 0: no octave)"
    assert (cfg.height, cfg.width) == (H, W) and got["describe"][0].shape == (1, n)


@pytest.mark.parametrize("label", ["plain", "H", "F", "H+F"])
def test_matchers_replay_their_captured_entry_points(facade, label):
    _, c, _ = facade
    if label == "plain":
        m = c["match_descriptors_jit"]
        assert len(m.calls) == 1 and tuple(m.calls[0][0][0].shape) == (MAX_SIFT, 128)
        return
    g = c["guided_match_descriptors_jit"]
    assert len(g.calls) == len(GUIDED) and len(set(g.keys)) == len(GUIDED)
    i = list(GUIDED).index(label)
    kw, key = g.calls[i][1], dict(g.keys[i])
    assert [kw[n] is None for n in ("H", "F")] == [n not in label for n in ("H", "F")]
    for n in ("H", "F"):   # None-ness is part of the signature
        assert (key[n] == (type(None), None)) == (n not in label)
    assert key["hdist_max"] == (float, GUIDED[label].get("hdistmax", 32.0))
    assert key["fdist_max"] == (float, GUIDED[label].get("fdistmax", 16.0))
    assert key["cfg"][1].max_sift == MAX_SIFT


def test_server_goes_through_the_captured_entry_points(served):
    _, c, _ = served
    assert len(c["extract_features_jit"].calls) == 2
    assert len(c["describe_at_keypoints_jit"].calls) == 1
    assert len(c["match_descriptors_jit"].calls) == 1
    assert len(c["guided_match_descriptors_jit"].calls) == 1
    _no_eager_call(c)


@pytest.mark.parametrize("sub", ["extract", "match", "twoview"])
def test_cli_goes_through_the_captured_entry_points(commands, sub):
    _, c, _ = commands
    assert len(c["extract_features_jit"].calls) == 3   # extract: 1 frame, match: 2
    if sub == "match":
        assert len(c["match_descriptors_jit"].calls) == 1
    if sub == "twoview":
        tv = c["two_view_reconstruct_jit"]
        assert len(tv.calls) == 1 and tuple(tv.calls[0][0][0].shape) == (2, H, W)
        assert isinstance(tv.calls[0][0][4], torch.Generator)
    _no_eager_call(c)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


@pytest.mark.parametrize("call", ["run_sift 0", "run_sift 1", "-obo", "-p", "describe", "match",
                                  "guided H", "guided F", "guided H+F"])
def test_facade_equals_the_eager_patched_facade(facade, call):
    got, _, ref = facade
    assert _same(got[call], ref[call])


@pytest.mark.parametrize("call", ["RUNSIFT 0", "RUNSIFT 1", "GET_MATCH", "GET_GUIDED_MATCH",
                                  "RUNSIFT_WITH_KEYPOINTS"])
def test_server_equals_the_eager_patched_server(served, facade, call):
    got, _, ref = served
    assert _same(got[call], ref[call])
    local = {"RUNSIFT 0": "run_sift 0", "RUNSIFT 1": "run_sift 1", "GET_MATCH": "match",
             "GET_GUIDED_MATCH": "guided H"}.get(call)
    if local:
        assert _same(got[call], tuple(facade[0][local]))


@pytest.mark.parametrize("sub", ["extract", "match", "twoview"])
def test_cli_equals_the_eager_patched_cli(commands, sub):
    got, c, ref = commands
    assert got[sub] == ref[sub]
    if sub == "twoview":
        res = c["two_view_reconstruct_jit"].outs[0]
        assert got[sub].startswith(f"matches={int(res.num_matches)} "
                                      f"inliers={int(res.num_inliers)}")


# ---------------- descriptor-only mode's padded rows ----------------

@pytest.mark.parametrize("n, rows", [(0, 128), (1, 128), (128, 128), (129, 256), (1000, 1024),
                                     (1024, 1024), (1025, 2048)])
def test_describe_rows_are_a_power_of_two(n, rows):
    assert api.describe_rows(n) == rows


@pytest.mark.parametrize("n", [1, 37, 128, 129, 190])
def test_describe_keeps_the_bits_of_the_unpadded_list(facade, frames, n):
    """The facade's descriptor-only call on the first n of frame 0's
    keypoints (and a row off every octave) against the eager describe of
    those n rows alone."""
    keys = facade[0]["run_sift 0"][0][:n].copy()
    assert len(keys) == n
    keys[-1, 2] = 1e4                          # a sigma above every octave: an invalid row
    s = api.SiftTPU(ARGV, device="cpu")
    s.set_keypoint_list(keys)
    with counting() as c:
        s.run_sift_with_keypoints(frames[0])
    assert tuple(c["describe_at_keypoints_jit"].calls[0][0][1].shape) == (1, api.describe_rows(n), 4)
    ref = redetect.describe_at_keypoints(torch.from_numpy(frames[0][None]), torch.from_numpy(keys[None]),
                                         s.config_for(H, W))
    assert _same(tuple(t.numpy() for t in s._feats), tuple(t.numpy() for t in ref))
    assert not bool(s._feats.mask[0, -1])


# ---------------- the bound on the captures held ----------------

class _FakeCapture:
    def __init__(self, device, pool_bytes=1 << 20):
        self.device, self.pool_bytes, self.used = device, pool_bytes, 0


def _use(g, key, dev):
    """A call of member g with signature `key` on `dev`: `Graphed.lookup`
    with a faked capture in place of a CUDA graph."""
    return g.lookup(key, dev, lambda: _FakeCapture(dev))


D0, D1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("uses, held, dropped", [
    ("ABCD", "ABCD", ""),
    ("ABCDE", "BCDE", "A"),            # past the limit: the least recently used goes
    ("ABCDAE", "CDAE", "B"),           # a call refreshes a capture
    ("ABCDEA", "CDEA", "AB"),          # chip_smoke.py's six-size sequence, limit 4
    ("AABAB", "AB", ""),
], ids=["at the limit", "past the limit", "a call refreshes", "six sizes", "repeats"])
def test_family_keeps_the_most_recently_used_captures(uses, held, dropped):
    """A family of limit 4 and two members: keys of the even uses go to one,
    of the odd to the other (a key names one member's signature); each
    new capture drops at most one, and cuda:1's capture is never dropped."""
    fam = graphs.GraphFamily("test", limit=4)
    g = (graphs.graphed(_ident, "p_jit", fam), graphs.graphed(_ident, "q_jit", fam))
    member = {}
    _use(g[0], "other", D1)
    out = []
    for k in uses:
        m = member.setdefault(k, g[len(member) % 2])
        before = {(id(x), key) for x, key in fam.held(D0)}
        _use(m, k, D0)
        gone = before - {(id(x), key) for x, key in fam.held(D0)}
        assert len(gone) <= 1, "a new capture drops at most one"
        out += [key for _, key in gone]
        assert len(fam.held(D0)) <= fam.limit
    assert [key for _, key in fam.held(D0)] == list(held) and "".join(out) == dropped
    assert fam.held(D1) == [(g[0], "other")]
    assert fam.pool_bytes() == (len(held) + 1) << 20, "pool_bytes() counts live captures"


def _ident(x):
    return x


def test_facade_and_obo_families_are_bounded():
    """Faked captures on cuda:0 of every facade entry point and -obo
    program, past each family's limit: each holds its limit, the most
    recently used, and nothing is dropped across families or devices."""
    fams = {api.FACADE: api.FACADE.members, extract.OBO_FAMILY: extract.OBO_FAMILY.members}
    assert api.FACADE.limit == api.MAX_CAPTURES and extract.OBO_FAMILY.limit == extract.OBO_CAPTURES
    assert api.FACADE.members == [api.extract_features_jit, api.describe_at_keypoints_jit,
                                  api.match_descriptors_jit, api.guided_match_descriptors_jit]
    api.release_captures()
    try:
        for fam, members in fams.items():
            _use(members[0], "on cuda:1", D1)
            keys = [(members[i % len(members)], i) for i in range(fam.limit + 3)]
            for g, i in keys:
                _use(g, i, D0)
            assert fam.held(D0) == [(g, i) for g, i in keys[3:]], fam.name
            assert fam.held(D1) == [(members[0], "on cuda:1")], fam.name
        assert len(api.FACADE.held(D0)) == api.MAX_CAPTURES
    finally:
        api.release_captures()
    assert api.FACADE.pool_bytes() == 0 and extract.OBO_FAMILY.pool_bytes() == 0
