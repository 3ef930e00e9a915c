"""ctypes binding of the native image loader (`native/loader.cpp`).

Port of `siftgpu_tpu/core/native.py`: `load_image` (PGM/PPM/BMP decode to
grayscale f32, with the `-maxd` pre-downsample), `load_batch` (a threaded
decode of many files into one [n, H, W] batch) and `write_binary_sift`.

The source is the repository's `native/loader.cpp`, read only.  `g++`
compiles it at first use into `siftgpu_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the source, the compiler and its flags:
an unchanged source loads, and processes that build at once each write a
temporary file and rename it into place.

The route is chosen by the machine, as a kernel's route is chosen by the
device: `available()` is True where `g++` is on PATH (and the source is in
the checkout), and then `core.image.load_image` decodes through this
library.  A compiler that fails to build raises; nothing here returns None
to make a caller fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["available", "find_compiler", "library_path", "load_image", "load_batch",
           "write_binary_sift"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_MAX_PIXELS = 64 * 1024 * 1024       # load_image's output buffer, in floats

_LOCK = threading.Lock()
_LIBS: dict = {}                     # compiler path -> loaded library


def find_compiler() -> Optional[str]:
    """Path of `g++` on PATH, or None."""
    return shutil.which("g++")


def available() -> bool:
    """True where the native route is taken: a compiler and the source."""
    return find_compiler() is not None and SOURCE.is_file()


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([cxx, *_FLAGS]).encode())
    return BUILD_DIR / f"libsiftloader-{h.hexdigest()[:16]}.so"


def _build(cxx: str) -> Path:
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *_FLAGS, str(SOURCE), "-o", tmp, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SOURCE.name} (rc {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    lib.sift_load_image.restype = ctypes.c_int
    lib.sift_load_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.sift_load_batch.restype = ctypes.c_int
    lib.sift_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.sift_write_binary.restype = ctypes.c_int
    lib.sift_write_binary.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte),
    ]
    return lib


def _lib() -> ctypes.CDLL:
    """Build (if needed) and load the library; raise without a compiler."""
    cxx = find_compiler()
    if cxx is None or not SOURCE.is_file():
        raise RuntimeError(f"the native loader needs g++ on PATH and {SOURCE}")
    with _LOCK:
        if cxx not in _LIBS:
            _LIBS[cxx] = _bind(_build(cxx))
        return _LIBS[cxx]


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_image(path: str, maxd: int = 0) -> np.ndarray:
    """Decode one PGM/PPM/BMP file to grayscale float32 [H, W] in [0, 1],
    halved (2x2 box) until max(H, W) <= maxd when maxd > 0."""
    lib = _lib()
    buf = np.empty(_MAX_PIXELS, np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.sift_load_image(os.fsencode(path), int(maxd), _f32p(buf), _MAX_PIXELS,
                             ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        why = "larger than the decode buffer" if rc == 2 else "missing or not a PNM/BMP image"
        raise OSError(f"{path}: native decode failed ({why})")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


def load_batch(paths: List[str], height: int, width: int, maxd: int = 0,
               threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded decode of n files into a [n, height, width] float32 batch
    (each frame top-left anchored, zero padded / cropped to the slot).
    Returns (batch, status [n] int32: 0 decoded, nonzero failed)."""
    lib = _lib()
    n = len(paths)
    out = np.zeros((n, height, width), np.float32)
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.sift_load_batch(names, n, int(maxd), int(height), int(width), _f32p(out),
                        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), int(threads))
    return out, status


def write_binary_sift(path: str, keys: np.ndarray, desc: np.ndarray) -> None:
    """keys [N, 4] (x, y, sigma, theta), desc [N, 128] uint8 -> the binary
    `.sift` layout of `pipeline/siftio.py`."""
    keys = np.ascontiguousarray(keys, np.float32)
    desc = np.ascontiguousarray(desc, np.uint8)
    if keys.ndim != 2 or keys.shape[1] != 4 or desc.shape != (len(keys), 128):
        raise ValueError(f"expected keys [N, 4] and desc [N, 128], got {keys.shape} "
                         f"and {desc.shape}")
    rc = _lib().sift_write_binary(os.fsencode(path), len(keys), _f32p(keys),
                                  desc.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        raise OSError(f"{path}: cannot write")
