"""Build and bind the hand-written Hopper kernels of `csrc/`.

Each kernel source is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface and loaded with `ctypes` — no PyTorch headers, so a
build takes seconds.  Libraries go to `siftgpu_tpu_torch/_build/` (listed in
`.gitignore`), named by the source and a hash of the sources and flags: a
changed source rebuilds, an unchanged one loads, and kernels that share a
source file (the ungated and gated `match_best2`) share its library.  The
build happens at a kernel's first launch, never at import; `build_all`
compiles every library at once, one nvcc per library, in parallel.
The octave kernel's grid-wide barrier (`cooperative_groups::this_grid()
.sync()`, launched with `cudaLaunchCooperativeKernel`) needs no `-rdc`; the
files with `-fmad=false` keep it, and where a kernel wants a fused
multiply-add it writes `__fmaf_rn` out.

There is no fallback: without `nvcc`, or when the build fails, `Kernel.lib`
raises.  The plain PyTorch versions run only for CPU tensors, chosen by the
wrapper in each `ops/` module before it ever gets here.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["Kernel", "KERNELS", "BUILD_DIR", "CSRC", "find_nvcc", "check_tensor", "build_all",
           "tally_launches", "add_launches"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

# every kernel of the package, by name (filled as the ops modules import)
KERNELS: dict[str, "Kernel"] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(_DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank `ndim`."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


class Kernel:
    """One CUDA source file, its C entry point(s) and a launch counter.

    `launches` counts calls that launched the kernel on the card, and a
    captured graph's launches at each replay (`tally_launches`); callers
    reset it to 0 themselves (`chip_smoke.py` does so around the main path).
    """

    def __init__(self, name: str, source: str, entry: dict, flags=()):
        self.name = name
        self.source = CSRC / source
        self.entry = dict(entry)          # C function name -> ctypes argtypes
        self.flags = list(flags)
        self.launches = 0
        self.build_log = None             # nvcc's output (ptxas register use)
        self._lib = None
        self._fns = {}                    # C entry name -> bound ctypes function
        KERNELS[name] = self

    def _sources(self):
        return [self.source] + sorted(CSRC.glob("*.cuh"))

    def lib_path(self, nvcc: str) -> Path:
        """The library file: source stem + hash of sources, nvcc and flags."""
        h = hashlib.sha256()
        for p in self._sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join([nvcc] + _ARCH + _FLAGS + self.flags).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source if no library of its current hash exists."""
        nvcc = find_nvcc()
        out = self.lib_path(nvcc)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_ARCH, *_FLAGS, *self.flags, "-I", str(CSRC),
               "-o", tmp, str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{self.build_log}"
            )
        os.replace(tmp, out)
        return out

    def lib(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; bind each C entry once."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            fns = {}
            for fn, argtypes in self.entry.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                fns[fn] = f
            lib.sift_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sift_cuda_error_string.restype = ctypes.c_char_p
            self._fns = fns
            self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Call C entry `fn` on `device`'s current stream (appended as the
        last argument); raise on a non-zero cudaGetLastError().  Pointers
        and the stream go as Python ints (the bound argtypes convert them);
        the device is made current only when it is not already."""
        if self._lib is None:
            self.lib()
        idx = device.index
        cur = torch.cuda.current_device()
        if idx is None or idx == cur:
            rc = self._fns[fn](*args, torch._C._cuda_getCurrentRawStream(cur))
        else:
            with torch.cuda.device(idx):
                rc = self._fns[fn](*args, torch._C._cuda_getCurrentRawStream(idx))
        if rc != 0:
            msg = self._lib.sift_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc} ({msg})")
        tally = getattr(_TALLY, "launches", None)
        if tally is None:
            self.launches += 1
        else:
            tally[self] = tally.get(self, 0) + 1


# the launches that this thread's CUDA-graph capture records (None outside one)
_TALLY = threading.local()


@contextlib.contextmanager
def tally_launches():
    """Inside the block, this thread's launches are counted into the dict
    it yields (Kernel -> launches), not into `Kernel.launches`: a launch
    under stream capture is recorded into a graph and runs only when the
    graph is replayed, and each replay adds the tally (`add_launches`)."""
    tally: dict = {}
    prev = getattr(_TALLY, "launches", None)
    _TALLY.launches = tally
    try:
        yield tally
    finally:
        _TALLY.launches = prev


def add_launches(tally: dict) -> None:
    """Add a graph's tally of launches to the kernels' counters."""
    for kern, n in tally.items():
        kern.launches += n


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def build_all() -> dict:
    """Compile the libraries of every registered kernel at once — one nvcc
    per distinct library, all started together — then load each kernel.
    Returns {library file name: (seconds, nvcc output)}; raises if a build
    fails."""
    nvcc = find_nvcc()
    first: dict = {}
    for kern in KERNELS.values():
        first.setdefault(kern.lib_path(nvcc), kern)

    def one(kern):
        t0 = time.perf_counter()
        kern.build()
        return time.perf_counter() - t0, kern.build_log or ""

    with ThreadPoolExecutor(max_workers=len(first)) as ex:
        futs = {path.name: ex.submit(one, kern) for path, kern in first.items()}
        out = {name: f.result() for name, f in futs.items()}
    for kern in KERNELS.values():
        kern.lib()
    return out
