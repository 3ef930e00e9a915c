"""The port's TCP feature server and its clients, with `device="cpu"`:

  - the wire format is the reference's byte for byte (`_pack` of the same
    tree, tensors included, gives the reference's bytes);
  - the port's server in a thread against the port's client: ping, remote
    features bit-identical to a local `SiftTPU`, the match flow equal to a
    local `SiftMatchTPU`, an error that leaves the session alive;
  - across packages: the reference's client against the port's server, and
    the port's client against the reference's server, each getting the
    features of that server's own package;
  - the spawn path (`create_remote_sift_tpu(spawn=True, cpu=True)`);
  - without a card, `serve` on the card raises before it listens.
"""

import queue
import socket
import threading

import numpy as np
import pytest
import torch

from siftgpu_tpu.pipeline import server as jserver
from siftgpu_tpu.pipeline.api import SiftTPU as JSift
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import server
from siftgpu_tpu_torch.pipeline.api import SiftMatchTPU, SiftTPU
from torch_threads import one_thread  # noqa: F401 (autouse)

ARGV = ["-t", "0.02"]


def _serve_in_thread(serve, **kw):
    q = queue.Queue()
    t = threading.Thread(target=serve, args=(0,),
                         kwargs=dict(argv=ARGV, max_sift=512, _ready_cb=q.put, **kw), daemon=True)
    t.start()
    return t, q.get(timeout=60)


@pytest.fixture(scope="module")
def port_server():
    t, port = _serve_in_thread(server.serve, device="cpu")
    yield port
    server.RemoteComboSiftTPU("127.0.0.1", port).shutdown()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture
def served(port_server):
    """A session with the port's server (it serves one client at a time)."""
    combo = server.RemoteComboSiftTPU("127.0.0.1", port_server, timeout=60)
    yield combo
    combo.close()


@pytest.fixture(scope="module")
def frames():
    a = fixtures.random_texture(64, 80, seed=5)
    b = fixtures.warp_affine(a, np.eye(2), np.array([2.0, -1.0]))
    return a, b


@pytest.fixture(scope="module")
def local(frames):
    """The port's local features of both frames."""
    s = SiftTPU(ARGV, device="cpu")
    out = []
    for img in frames:
        s.run_sift(img)
        out.append(s.get_feature_vector())
    return out


def test_wire_format_is_the_reference_bytes():
    rng = np.random.default_rng(0)
    a = rng.random((3, 4)).astype(np.float32)
    tree = ("RUNSIFT", {"image": a, "keys": rng.integers(0, 9, (2, 2)), "n": np.int64(3),
                        "s": "x", "t": (1, 2.5, None, True), "b": b"\x00\x01", "l": [a[0]]})
    got = server._pack(tree)
    assert got == jserver._pack(tree)
    # a tensor goes as its host copy
    assert server._pack(("X", {"image": torch.from_numpy(a)})) == jserver._pack(("X", {"image": a}))
    back = jserver._unpack(got)
    np.testing.assert_array_equal(back[1]["image"], a)
    assert back[1]["t"] == (1, 2.5, None, True) and back[1]["b"] == b"\x00\x01"


def test_ping(served):
    assert served.ping()


def test_remote_features_equal_local(served, frames, local):
    assert served.sift.run_sift(frames[0])
    rk, rd = served.sift.get_feature_vector()
    assert served.sift.get_feature_num() == len(rk) > 5
    lk, ld = local[0]
    np.testing.assert_array_equal(rk, lk)
    np.testing.assert_array_equal(rd, ld)


def test_remote_match_flow_equals_local(served, frames, local):
    (k0, d0), (k1, d1) = local
    for i, (k, d) in enumerate(local):
        served.matcher.set_descriptors(i, d)
        served.matcher.SetFeautreLocation(i, k)
    pairs = served.matcher.get_sift_match()
    assert len(pairs) >= 5
    m = SiftMatchTPU(max_sift=512, device="cpu")
    for i, (k, d) in enumerate(local):
        m.set_descriptors(i, d)
        m.set_feature_location(i, k)
    np.testing.assert_array_equal(pairs, m.get_sift_match())
    H = np.array([[1, 0, 2.0], [0, 1, -1.0], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(served.matcher.get_guided_sift_match(H=H, hdistmax=3.0),
                                  m.get_guided_sift_match(H=H, hdistmax=3.0))


def test_server_error_does_not_kill_session(served):
    with pytest.raises(RuntimeError, match="server error on GET_GUIDED_MATCH: TypeError"):
        served.matcher.get_guided_sift_match(gate=3.0)      # no such argument
    with pytest.raises(RuntimeError, match="server error on SET_DESCRIPTORS: IndexError"):
        served.matcher.set_descriptors(2, np.zeros((1, 128), np.uint8))
    assert served.ping()  # the command loop survived


def test_reference_client_drives_the_port_server(port_server, frames, local):
    combo = jserver.RemoteComboSiftTPU("127.0.0.1", port_server, timeout=60)
    try:
        assert combo.ping()
        assert combo.sift.run_sift(frames[1])
        k, d = combo.sift.get_feature_vector()
    finally:
        combo.close()
    np.testing.assert_array_equal(k, local[1][0])
    np.testing.assert_array_equal(d, local[1][1])


def test_port_client_drives_the_reference_server(frames):
    t, port = _serve_in_thread(jserver.serve)
    combo = server.RemoteComboSiftTPU("127.0.0.1", port, timeout=60)
    try:
        assert combo.ping()
        assert combo.sift.run_sift(frames[0])
        k, d = combo.sift.get_feature_vector()
    finally:
        combo.shutdown()
    t.join(timeout=10)
    assert not t.is_alive()
    ref = JSift(ARGV)
    ref.run_sift(frames[0])
    rk, rd = ref.get_feature_vector()
    np.testing.assert_array_equal(k, rk)
    np.testing.assert_array_equal(d, rd)


def test_spawned_server_roundtrip(frames, local):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    combo = server.create_remote_sift_tpu(port, spawn=True, cpu=True, argv=ARGV)
    proc = combo._proc
    try:
        assert combo.ping()
        assert combo.sift.run_sift(frames[0])
        k, d = combo.sift.get_feature_vector()
    finally:
        combo.shutdown()
    assert proc.returncode == 0
    np.testing.assert_array_equal(k, local[0][0])
    np.testing.assert_array_equal(d, local[0][1])


def test_serve_on_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cuda is not available"):
        server.serve(0, device="cuda")
