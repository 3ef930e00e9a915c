"""TCP feature server: the `ServerSiftGPU` analog, on the port.

Port of `siftgpu_tpu/pipeline/server.py`.  SiftGPU's
`CreateRemoteSiftGPU(port, host)` returns a `ComboSiftGPU` proxy whose every
call goes as a command word and a payload over a socket to a server process
that owns one GPU.  Here a command loop wraps one `SiftTPU` + `SiftMatchTPU`
pair on one device (`serve(..., device="cuda")`), and client proxies carry
the same method surface.  Command words: RUNSIFT, RUNSIFT_WITH_KEYPOINTS,
SET_KEYPOINT_LIST, GET_FEATURE_NUM, GET_FEATURE_VECTOR, SAVE_SIFT,
PARSE_PARAM, SET_MAX_SIFT, SET_DESCRIPTORS, SET_FEATURE_LOCATION, GET_MATCH,
GET_GUIDED_MATCH, PING, SHUTDOWN.

The wire format is the reference's byte for byte, so a client of either
package drives a server of the other: each frame is the 4-byte magic
`SFT2` and a u64 length (`<4sQ`), then a data-only payload (a JSON tree with
`.npy` array sections; no pickle, nothing executable on decode).  Tensors
are moved to the host before they are packed.  An exception inside a
command goes back to the client as an error reply, and the session goes on.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .api import ComboSiftTPU, _require

__all__ = [
    "serve", "RemoteSiftTPU", "RemoteSiftMatchTPU", "RemoteComboSiftTPU",
    "create_remote_sift_tpu",
]

_MAGIC = b"SFT2"
_HDR = struct.Struct("<4sQ")


def _pack(obj) -> bytes:
    """Encode nested tuples/lists/dicts of scalars, strings, bytes and
    arrays as a JSON tree with `.npy`-serialized array attachments."""
    arrays = []

    def enc(o):
        if o is None or isinstance(o, (bool, int, float, str)):
            return o
        if isinstance(o, bytes):
            arrays.append(np.frombuffer(o, np.uint8))
            return {"__bytes__": len(arrays) - 1}
        if isinstance(o, np.generic):          # numpy scalar
            return enc(o.item())
        if torch.is_tensor(o):                 # any device: an explicit host copy
            o = o.detach().cpu().numpy()
        elif not isinstance(o, np.ndarray) and hasattr(o, "__array__") \
                and getattr(o, "ndim", None) is not None:
            o = np.asarray(o)                  # other array types
        if isinstance(o, np.ndarray):
            arrays.append(np.ascontiguousarray(o))
            return {"__nd__": len(arrays) - 1}
        if isinstance(o, dict):
            return {"__d__": {str(k): enc(v) for k, v in o.items()}}
        if isinstance(o, tuple):
            return {"__t__": [enc(v) for v in o]}
        if isinstance(o, list):
            return [enc(v) for v in o]
        raise TypeError(f"unserializable type {type(o).__name__}")

    tree = json.dumps(enc(obj)).encode()
    parts = [struct.pack("<II", len(tree), len(arrays)), tree]
    for a in arrays:
        bio = io.BytesIO()
        np.save(bio, a, allow_pickle=False)
        raw = bio.getvalue()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _unpack(data: bytes):
    off = 8
    tree_len, n_arrays = struct.unpack_from("<II", data, 0)
    tree = json.loads(data[off : off + tree_len].decode())
    off += tree_len
    arrays = []
    for _ in range(n_arrays):
        (ln,) = struct.unpack_from("<Q", data, off)
        off += 8
        arrays.append(np.load(io.BytesIO(data[off : off + ln]),
                              allow_pickle=False))
        off += ln

    def dec(o):
        if isinstance(o, dict):
            if "__nd__" in o:
                return arrays[o["__nd__"]]
            if "__bytes__" in o:
                return arrays[o["__bytes__"]].tobytes()
            if "__d__" in o:
                return {k: dec(v) for k, v in o["__d__"].items()}
            if "__t__" in o:
                return tuple(dec(v) for v in o["__t__"])
        if isinstance(o, list):
            return [dec(v) for v in o]
        return o

    return dec(tree)


def _send(sock: socket.socket, obj) -> None:
    data = _pack(obj)
    sock.sendall(_HDR.pack(_MAGIC, len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv(sock: socket.socket):
    magic, n = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != _MAGIC:
        raise ConnectionError(f"bad frame magic {magic!r}")
    return _unpack(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def serve(
    port: int, host: str = "127.0.0.1", argv: Optional[Sequence[str]] = None,
    max_sift: int = 4096, one_shot: bool = False, device="cuda",
    _ready_cb=None,
) -> None:
    """Command loop owning one SiftTPU + SiftMatchTPU on `device` (SiftGPU's
    server `main`).  `one_shot`: return after the first client disconnects
    (the spawned-per-client mode).  Raises before it listens when the device
    is not available."""
    dev = torch.device(device)
    _require(dev)
    combo = ComboSiftTPU(argv=list(argv) if argv else None, max_sift=max_sift, device=dev)
    sift, matcher = combo.sift, combo.matcher

    handlers = {
        # SiftGPU surface
        "PARSE_PARAM": lambda a: sift.parse_param(a["argv"]),
        "RUNSIFT": lambda a: sift.run_sift(a["image"]),
        "RUNSIFT_WITH_KEYPOINTS": lambda a: sift.run_sift_with_keypoints(a["image"]),
        "SET_KEYPOINT_LIST": lambda a: sift.set_keypoint_list(a["keys"]),
        "GET_FEATURE_NUM": lambda a: sift.get_feature_num(),
        "GET_FEATURE_VECTOR": lambda a: sift.get_feature_vector(),
        "SAVE_SIFT": lambda a: sift.save_sift(a["path"], a.get("binary")),
        # SiftMatchGPU surface
        "SET_MAX_SIFT": lambda a: matcher.set_max_sift(a["n"]),
        "SET_DESCRIPTORS": lambda a: matcher.set_descriptors(
            a["index"], a["descriptors"], a.get("num")
        ),
        "SET_FEATURE_LOCATION": lambda a: matcher.set_feature_location(
            a["index"], a["keys"]
        ),
        "GET_MATCH": lambda a: matcher.get_sift_match(**a),
        "GET_GUIDED_MATCH": lambda a: matcher.get_guided_sift_match(**a),
        # control
        "PING": lambda a: "pong",
    }

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(4)
    bound_port = srv.getsockname()[1]
    print(f"siftgpu_tpu_torch server listening on {host}:{bound_port} ({dev})", flush=True)
    if _ready_cb is not None:
        _ready_cb(bound_port)

    try:
        while True:
            conn, _addr = srv.accept()
            try:
                while True:
                    try:
                        cmd, args = _recv(conn)
                    except ConnectionError:
                        break
                    if cmd == "SHUTDOWN":
                        _send(conn, (True, None))
                        return
                    fn = handlers.get(cmd)
                    if fn is None:
                        _send(conn, (False, f"unknown command {cmd!r}"))
                        continue
                    try:
                        _send(conn, (True, fn(args or {})))
                    except Exception as e:  # the client gets the error; the session goes on
                        _send(conn, (False, f"{type(e).__name__}: {e}"))
            finally:
                conn.close()
            if one_shot:
                return
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# client proxies
# ---------------------------------------------------------------------------

class _Channel:
    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def call(self, cmd: str, **args):
        _send(self.sock, (cmd, args))
        ok, result = _recv(self.sock)
        if not ok:
            raise RuntimeError(f"server error on {cmd}: {result}")
        return result

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteSiftTPU:
    """`SiftGPU` method surface proxied over the channel."""

    def __init__(self, channel: _Channel):
        self._ch = channel

    def parse_param(self, argv):
        self._ch.call("PARSE_PARAM", argv=list(argv))

    def run_sift(self, image, *_ignored) -> bool:
        return bool(self._ch.call("RUNSIFT", image=image))

    def run_sift_with_keypoints(self, image) -> bool:
        return bool(self._ch.call("RUNSIFT_WITH_KEYPOINTS", image=image))

    def set_keypoint_list(self, keys) -> None:
        self._ch.call("SET_KEYPOINT_LIST", keys=keys)

    def get_feature_num(self) -> int:
        return int(self._ch.call("GET_FEATURE_NUM"))

    def get_feature_vector(self):
        return self._ch.call("GET_FEATURE_VECTOR")

    def save_sift(self, path: str, binary=None) -> None:
        """Writes on the SERVER's filesystem, as SiftGPU's remote proxy does."""
        self._ch.call("SAVE_SIFT", path=path, binary=binary)


class RemoteSiftMatchTPU:
    """`SiftMatchGPU` method surface proxied over the channel."""

    def __init__(self, channel: _Channel):
        self._ch = channel

    def set_max_sift(self, n: int) -> None:
        self._ch.call("SET_MAX_SIFT", n=n)

    def set_descriptors(self, index: int, descriptors, num=None):
        self._ch.call("SET_DESCRIPTORS", index=index, descriptors=descriptors, num=num)

    def set_feature_location(self, index: int, keys) -> None:
        self._ch.call("SET_FEATURE_LOCATION", index=index, keys=keys)

    # SiftMatchGPU's misspelt name, kept so scripts run unchanged
    SetFeautreLocation = set_feature_location

    def get_sift_match(self, max_match: int = 4096, distmax: float = 0.7,
                       ratiomax: float = 0.8, mutual_best: bool = True):
        return self._ch.call(
            "GET_MATCH", max_match=max_match, distmax=distmax,
            ratiomax=ratiomax, mutual_best=mutual_best,
        )

    def get_guided_sift_match(self, **kw):
        return self._ch.call("GET_GUIDED_MATCH", **kw)


class RemoteComboSiftTPU:
    """`ComboSiftGPU`-over-TCP proxy: what `CreateRemoteSiftGPU` returns."""

    def __init__(self, host: str, port: int, timeout: float = 300.0,
                 _proc: Optional[subprocess.Popen] = None):
        self._ch = _Channel(host, port, timeout)
        self._proc = _proc
        self.sift = RemoteSiftTPU(self._ch)
        self.matcher = RemoteSiftMatchTPU(self._ch)

    def ping(self) -> bool:
        return self._ch.call("PING") == "pong"

    def shutdown(self) -> None:
        try:
            self._ch.call("SHUTDOWN")
        except (RuntimeError, ConnectionError, OSError):
            pass
        self.close()

    def close(self) -> None:
        """Close the channel; wait for a spawned server (10 s, then stop it)."""
        self._ch.close()
        if self._proc is not None:
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.terminate()
                self._proc.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def create_remote_sift_tpu(
    port: int, hostname: str = "127.0.0.1", argv: Optional[Sequence[str]] = None,
    spawn: Optional[bool] = None, cpu: bool = False, connect_timeout: float = 120.0,
) -> RemoteComboSiftTPU:
    """`CreateRemoteSiftGPU(port, hostname)` analog: connect to a feature
    server, spawning one locally first when none is listening (spawn=None
    decides; SiftGPU spawns its server executable the same way).  The
    spawned server is `python -m siftgpu_tpu_torch serve --port P` on the
    card, or on the CPU with `cpu=True`; `argv` goes to its SiftTPU."""
    local = hostname in ("127.0.0.1", "localhost", "::1")
    proc = None
    if spawn is None:
        try:
            return RemoteComboSiftTPU(hostname, port)
        except OSError:
            spawn = local
        if not spawn:
            raise ConnectionError(f"no server at {hostname}:{port} and spawn disabled")
    if spawn:
        if not local:
            raise ValueError("can only spawn a server on localhost")
        cmd = [sys.executable, "-m", "siftgpu_tpu_torch", "serve", "--port", str(port)]
        if cpu:
            cmd.append("--cpu")
        if argv:
            cmd += ["--"] + list(argv)
        # the child imports this package from the same tree as its parent
        root = str(Path(__file__).resolve().parents[2])
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=root if not path else root + os.pathsep + path)
        proc = subprocess.Popen(cmd, env=env)
    deadline = time.monotonic() + connect_timeout
    last_err: Exception = ConnectionError("timeout")
    while time.monotonic() < deadline:
        try:
            return RemoteComboSiftTPU(hostname, port, _proc=proc)
        except OSError as e:
            last_err = e
            if proc is not None and proc.poll() is not None:
                raise ConnectionError(
                    f"spawned server exited with {proc.returncode}"
                ) from e
            time.sleep(0.25)
    if proc is not None:
        proc.terminate()
        proc.wait(timeout=10)
    raise ConnectionError(f"could not reach {hostname}:{port}: {last_err}")
