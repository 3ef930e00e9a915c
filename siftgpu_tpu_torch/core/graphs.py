"""Programs captured once per static shape: the counterpart of `jax.jit`'s
cache of executables.

`graphed(fn, name)` returns a callable with fn's signature.  The route
follows the inputs' device, as a kernel's route does: CPU tensors call fn
as it is and capture nothing; CUDA tensors replay a CUDA graph captured for
the call's signature; tensors on two devices raise.  Nothing else turns
capture on or off.

The signature is each tensor argument's shape, dtype and device (tuples,
lists and NamedTuples such as `BAProblem` are walked, and so is a dict
whose values are all tensors: its keys, in order, are part of the
signature, and it is rebuilt with the same keys), whether each optional
argument is None, and every other argument by value: configs
(`SiftConfig`, `MatchConfig`) and Python ints and floats (`iters`,
`huber_px`) are static, as jit's `static_argnums` makes them.  An argument
that cannot be hashed raises, and so does a dict that holds anything but
tensors.  A `Graphed`'s cache is unbounded, as jit's is, unless its
family has a `limit` (below): the facade's (`pipeline/api.py`) and -obo's
(`frontend/extract.py`) do.

A `torch.Generator` argument (the counterpart of jit's PRNG key) is state,
not part of the signature beyond its device: a new generator object
replays the same capture.  The capture draws from a generator of its own,
registered with the graph (`CUDAGraph.register_generator_state`); each
call copies the caller's generator state into it, replays, and copies the
advanced state back, so a replay from state s draws what an eager call
from s draws and leaves the caller's generator where the eager call
leaves it.  The warm-up calls draw from the capture's generator, never
from the caller's.

The first call of a signature runs fn twice on a side stream, one per
device for every capture (PyTorch's CUDA-graph recipe: these calls build
the kernels at first use, let cuDNN pick its algorithms, make cuBLAS's
workspaces and the per-device constants of `device_constant`), captures a third call under `torch.cuda.graph` into
a private memory pool (or its family's, below), and replays it once.
Every call copies the caller's tensors into the graph's static inputs on
the current stream, replays, and returns fresh clones of the outputs, as
jit returns new arrays: no output aliases a buffer that the next replay
overwrites.  There is no fallback: a capture that fails (a host sync
inside fn, a copy from pageable memory, a launch that cannot be captured)
raises, naming the entry point, its family if it has one, and the
signature.

During capture the hand kernels' launches are tallied against the graph
(`_build.tally_launches`); each replay adds the tally to `Kernel.launches`,
so the counters read after a replay what they read after an eager call.
One lock per entry point serialises capture and replay; a replay waits
for the previous one's output clones on whatever stream that ran.

A `GraphFamily` groups entry points that share one memory pool per device
(`torch.cuda.graph(pool=)`), so that programs run one after another, as
-obo's octave programs are, hold together about the largest one's working
set and not the sum.  Its members share one lock, held over capture and
replay, and one "last replay done" event, which every replay waits on
before it copies its inputs.  Sharing is safe by this rule: replays in a
family never run at the same time, and each replay's outputs are cloned
before the next one runs.  A capture may then be handed memory that an
earlier member used for temporaries or outputs, since no replay reads
memory it did not write first but its static inputs, which lie outside
the pool.  A member's `Capture.pool_bytes` is the growth of reserved
memory that its own capture caused; `GraphFamily.pool_bytes()` sums its
members' live captures.  A family takes a new pool on a device when none
of its members holds a capture there (after `release()`, or after its
members' `captures` were cleared).

A family made with `limit` holds at most that many captures a device, of
all its members and signatures together: before a capture on a device
that holds `limit`, the least recently used one there (by its last call)
is dropped, under the family's lock.  Its memory stays in the family's
pool, for the next captures there to reuse, until the device's last
capture goes; `pool_bytes()` counts live captures only, so the pool's
size is read from the allocator's segments (`torch.cuda.memory_snapshot`).

A `torch.distributed` process group among the arguments is static and
keyed by identity: one capture per group object.  Only NCCL's collectives
can be captured, so on CUDA inputs a group of any other backend raises
`ValueError` (`check_backends`) before the warm-up calls: no collective
has run, and no peer is left waiting in one.  CPU inputs call fn as ever,
on any backend.  The warm-up calls run fn's collectives on the warm-up
stream, which creates the group's NCCL communicator before the capture,
as NCCL needs.  Every rank of the group must capture the same signatures
in the same order, since each capture runs the collectives of its
warm-ups: a caller keys its programs by sizes that every rank computes
alike from global counts (`parallel/resident_ba.py`).  The collectives
that reach `torch.distributed` through `optim.ba.all_reduce_sum` and
`parallel.comm.all_gather_rows` are counted (`count_collective`) as
launches are: into `COLLECTIVES`, or during a capture into its
`Capture.collectives`, which each replay adds to `COLLECTIVES`.  That
tally is the evidence that a graph holds its collectives, since NCCL may
launch no kernel for a sum over one rank.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..ops import _build

__all__ = ["graphed", "Graphed", "GraphFamily", "Capture", "device_constant", "check_backends",
           "count_collective", "COLLECTIVES"]

WARMUPS = 2

_CONSTANTS: dict = {}
_WARMUP_STREAMS: dict = {}
_USES = itertools.count()   # stamps of captures' calls: the order of last use

# calls of each collective that reached torch.distributed (`count_collective`)
COLLECTIVES: dict = {"all_reduce": 0, "all_gather": 0}
_TALLY = threading.local()


def count_collective(name: str) -> None:
    """Count one call of the collective `name` that reaches
    torch.distributed: into the tally of the capture under way on this
    thread, else into `COLLECTIVES`."""
    tally = getattr(_TALLY, "collectives", None)
    counts = COLLECTIVES if tally is None else tally
    counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def _tally_collectives():
    """Inside the block, this thread's collectives are counted into the
    dict it yields, not into `COLLECTIVES` (as `_build.tally_launches`)."""
    tally: dict = {}
    prev = getattr(_TALLY, "collectives", None)
    _TALLY.collectives = tally
    try:
        yield tally
    finally:
        _TALLY.collectives = prev


def _groups(x):
    """The process groups in an argument, walked as `_flatten` walks it."""
    if isinstance(x, getattr(dist, "ProcessGroup", ())):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _groups(v)


def check_backends(name: str, arguments, device) -> None:
    """Raise ValueError, naming the entry point `name` and the backend, if
    `device` is a CUDA device and a process group among `arguments` (a
    call's argument values) is not NCCL's: only NCCL's collectives can be
    captured.  Called before a capture's warm-up calls."""
    if torch.device(device).type != "cuda":
        return
    for x in arguments:
        for g in _groups(x):
            backend = dist.get_backend(g)
            if backend != "nccl":
                raise ValueError(f"{name}: cannot capture the collectives of a {backend!r} "
                                 f"process group on {device}: only NCCL's can be captured")


def device_constant(key, device, make: Callable[[], np.ndarray]) -> torch.Tensor:
    """The NumPy array `make()` as a tensor on `device`, made and uploaded
    once per (key, device) and kept for the process.  The upload is a copy
    from pageable memory, which synchronises the stream and cannot be
    captured: a graph's warm-up calls make the constants, its capture finds
    them here."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:   # "cuda" and "cuda:0": one key
        device = torch.device("cuda", torch.cuda.current_device())
    k = (key, str(device))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS.setdefault(k, torch.from_numpy(np.ascontiguousarray(make())).to(device))
    return t


def _warmup_stream(device: torch.device):
    """The side stream of every capture's warm-up calls on `device`.  One
    stream, as `torch.cuda.graph` captures on one: what a library keeps per
    stream (cuBLAS's workspace) is then made once, not once for each stream
    of PyTorch's pool that a capture happens to draw, where it could take a
    cached block of any segment and pin that segment."""
    s = _WARMUP_STREAMS.get(device)
    if s is None:
        s = _WARMUP_STREAMS.setdefault(device, torch.cuda.Stream(device))
    return s


def _device(x) -> torch.device:
    """A tensor's or generator's device, with a CUDA index always stated."""
    d = x.device
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _flatten(x, leaves: list, where: str):
    """x's structure as a hashable key, its tensors and generators appended
    to `leaves`."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (torch.Tensor, tuple(x.shape), x.dtype, x.device)
    if isinstance(x, torch.Generator):
        leaves.append(x)
        return (torch.Generator, _device(x))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves, where) for v in x))
    if isinstance(x, dict) and all(isinstance(v, torch.Tensor) for v in x.values()):
        return (type(x), tuple((k, _flatten(v, leaves, where)) for k, v in x.items()))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"{where}: an argument of type {type(x).__name__} cannot be hashed, "
                        "and every argument that is not a tensor is static") from None
    return (type(x), x)


def _rebuild(x, tensors):
    """x with its tensors and generators replaced, in order, by those of
    the iterator."""
    if isinstance(x, (torch.Tensor, torch.Generator)):
        return next(tensors)
    if isinstance(x, (tuple, list)):
        vals = [_rebuild(v, tensors) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    if isinstance(x, dict):
        return type(x)((k, _rebuild(v, tensors)) for k, v in x.items())
    return x


class _LastReplay:
    """The event recorded after the last replay's output clones, of one
    capture or of a whole family."""

    def __init__(self):
        self.done = None


class Capture:
    """One captured signature: the graph, its static input and output
    tensors, the launches it holds, and what capturing it cost."""

    def __init__(self, graph, device, inputs, out_tree, outputs, tally, collectives, seconds,
                 pool_bytes, last):
        self.graph = graph
        self.device = device
        self.inputs = inputs          # static input buffers and generators, in argument order
        self.out_tree = out_tree      # fn's output, its tensors those of `outputs`
        self.outputs = outputs
        self.tally = tally            # Kernel -> launches in one replay
        self.collectives = collectives  # collective name -> calls in one replay
        self.seconds = seconds        # the warm-up calls and the capture
        self.pool_bytes = pool_bytes  # device memory the capture reserved
        self.last = last              # the capture's own _LastReplay, or its family's
        self.used = 0                 # the stamp of its last call (`_USES`)

    def run(self, leaves):
        stream = torch.cuda.current_stream(self.device)
        if self.last.done is not None:
            stream.wait_event(self.last.done)
        gens = []
        for dst, src in zip(self.inputs, leaves):
            if isinstance(dst, torch.Generator):
                dst.set_state(src.get_state())
                gens.append((dst, src))
            else:
                dst.copy_(src)
        self.graph.replay()
        for own, caller in gens:   # the caller's generator advances as after an eager call
            caller.set_state(own.get_state())
        outs = [t.clone() for t in self.outputs]
        self.last.done = torch.cuda.Event()
        self.last.done.record(stream)
        _build.add_launches(self.tally)
        for name, n in self.collectives.items():
            COLLECTIVES[name] = COLLECTIVES.get(name, 0) + n
        return _rebuild(self.out_tree, iter(outs))


class GraphFamily:
    """Entry points that share one graph memory pool per device, one lock
    and one "last replay done" event, and that hold at most `limit`
    captures a device if it is given (see the module's docstring)."""

    def __init__(self, name: str, limit: int | None = None):
        self.name = name
        self.limit = limit
        self.members: list = []
        self.lock = threading.Lock()
        self.last = _LastReplay()
        self._pools: dict = {}

    def pool(self, device: torch.device):
        """The pool of the next capture on `device`: the family's, or a new
        one where no member holds a capture."""
        if not any(c.device == device for g in self.members for c in g.captures.values()):
            self._pools[device] = torch.cuda.graph_pool_handle()
        return self._pools[device]

    def pool_bytes(self) -> int:
        """The growth of reserved memory that the members' live captures
        caused: the family's pools, summed over devices."""
        return sum(c.pool_bytes for g in self.members for c in g.captures.values())

    def held(self, device: torch.device) -> list:
        """(member, key) of the captures on `device`, least recently used
        first."""
        caps = [(c.used, g, k) for g in self.members for k, c in g.captures.items()
                if c.device == device]
        return [(g, k) for _, g, k in sorted(caps, key=lambda t: t[0])]

    def make_room(self, device: torch.device) -> None:
        """Before a capture on `device`, under the family's lock: drop the
        least recently used captures there until fewer than `limit` are
        left."""
        if self.limit is not None:
            held = self.held(device)
            for g, k in held[: max(len(held) - self.limit + 1, 0)]:
                del g.captures[k]

    def release(self) -> None:
        """Drop every member's captures; the pools' memory goes back to the
        cache (`torch.cuda.empty_cache()` returns it to the device)."""
        with self.lock:
            for g in self.members:
                g.captures.clear()
            self._pools.clear()


class Graphed:
    """fn, captured once per signature on CUDA inputs (see the module's
    docstring).  `captures` maps each signature to its `Capture`."""

    def __init__(self, fn: Callable, name: str, family: GraphFamily | None = None):
        functools.update_wrapper(self, fn)
        self.__name__ = self.__qualname__ = name
        self.fn = fn
        self.family = family
        self.captures: dict = {}
        self._sig = inspect.signature(fn)
        self._lock = family.lock if family else threading.Lock()
        if family:
            family.members.append(self)

    def signature(self, *args, **kwargs):
        """(key, bound arguments, tensors and generators in argument order)
        of a call."""
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        leaves: list = []
        key = tuple((k, _flatten(v, leaves, self.__name__)) for k, v in bound.arguments.items())
        return key, bound, leaves

    def __call__(self, *args, **kwargs):
        key, bound, leaves = self.signature(*args, **kwargs)
        devices = {_device(t) for t in leaves}
        if len(devices) > 1:   # a generator counts with the tensors
            raise ValueError(f"{self.__name__}: tensors on more than one device "
                             f"({', '.join(sorted(map(str, devices)))})")
        if not devices or next(iter(devices)).type != "cuda":
            return self.fn(*args, **kwargs)
        dev = next(iter(devices))
        with self._lock, torch.cuda.device(dev):
            return self.lookup(key, dev, lambda: self._capture(key, bound, leaves)).run(leaves)

    def lookup(self, key, device: torch.device, make: Callable):
        """The capture of `key`, made by `make()` if there is none (its
        family's least recently used captures on `device` dropped first, to
        keep its `limit`), marked as used now.  Called under the lock."""
        cap = self.captures.get(key)
        if cap is None:
            if self.family is not None:
                self.family.make_room(device)
            cap = self.captures[key] = make()
        cap.used = next(_USES)
        return cap

    def _capture(self, key, bound, leaves) -> Capture:
        dev = _device(leaves[0])
        check_backends(self.__name__, bound.arguments.values(), dev)
        t0 = time.perf_counter()
        inputs = []
        for t in leaves:
            if isinstance(t, torch.Generator):
                own = torch.Generator(device=dev)
                own.set_state(t.get_state())
                inputs.append(own)
            else:
                inputs.append(torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t))
        it = iter(inputs)
        args = inspect.BoundArguments(
            self._sig, {k: _rebuild(v, it) for k, v in bound.arguments.items()})
        call = lambda: self.fn(*args.args, **args.kwargs)
        cur = torch.cuda.current_stream(dev)
        side = _warmup_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUPS):
                call()
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        for g in inputs:
            if isinstance(g, torch.Generator):
                graph.register_generator_state(g)
        fam = self.family
        pool = fam.pool(dev) if fam else None
        try:
            with _build.tally_launches() as tally, _tally_collectives() as collectives, \
                    torch.cuda.graph(graph, pool=pool):
                out = call()
        except RuntimeError as e:
            within = f" in the family {fam.name!r}" if fam else ""
            raise RuntimeError(f"{self.__name__}: capture failed for the signature {key}"
                               f"{within}: {e}") from e
        outputs: list = []
        _flatten(out, outputs, self.__name__)
        pool = torch.cuda.memory_reserved(dev) - reserved
        return Capture(graph, dev, inputs, out, outputs, tally, collectives,
                       time.perf_counter() - t0, pool, fam.last if fam else _LastReplay())


def graphed(fn: Callable, name: str, family: GraphFamily | None = None) -> Graphed:
    """fn as an entry point captured once per static shape on CUDA inputs
    and called as it is on CPU inputs; `name` names it in errors.  Members
    of one `family` share its pool, lock and replay event."""
    return Graphed(fn, name, family)
