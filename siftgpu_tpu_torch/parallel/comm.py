"""Process-group plumbing of the port's distributed paths (`torch.distributed`).

The reference runs one SPMD program over a `jax.sharding.Mesh`; the port
runs one process per rank in one process group, and that group plays the
mesh's role for all three legs (extraction, BA, pose graph).  A `psum`
becomes a sum-all-reduce over the group, a `P(axis)` input the rank's own
block; replicated inputs stay replicated.

  - `rank` / `world_size` / `resolve` of a group (None: the default group
    once one is initialised, else a single process and no collective);
  - `device_of(rank, device)`: the rank's device, `cuda:(rank %
    device_count)`, or the CPU when asked for;
  - `all_reduce_sum` and `all_gather_rows` (a row-block all-gather; bool
    tensors travel as uint8, the one route for every backend);
  - `gather_slabs` and `exchange_halo`: an image split into row slabs
    gathered whole, or ringed with its neighbours' halo rows by one
    all-gather of every rank's boundary rows (config 3, `spatial`);
  - `spawn(fn, n, backend, device, *args)`: n processes started with the
    `spawn` method, met through a file store, each group with a timeout;
    returns each rank's picklable result, raises if a rank fails, with
    each rank's exit, the traceback of each rank whose function raised,
    and, for each rank that died of a signal (a C++ abort in a
    collective's thread, say), the Python stacks of all its threads, which
    each rank's `faulthandler` writes to a file of its own.

The backend is the caller's choice: "nccl" raises when two ranks would
share a device, and nothing falls back to another backend.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import signal
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from ..core.graphs import count_collective
from ..optim.ba import all_reduce_sum

__all__ = ["rank", "world_size", "resolve", "device_of", "all_reduce_sum", "all_gather_rows",
           "gather_slabs", "exchange_halo", "spawn"]


def resolve(group=None):
    """The group a distributed call runs over: `group`, else the default
    group when one is initialised, else None (one process, no collective)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank(group=None) -> int:
    group = resolve(group)
    return 0 if group is None else dist.get_rank(group)


def world_size(group=None) -> int:
    group = resolve(group)
    return 1 if group is None else dist.get_world_size(group)


def device_of(rank_: int, device="cuda") -> torch.device:
    """The device of a rank: `cuda:(rank % device_count)` for "cuda", or the
    given device (the CPU) as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", rank_ % max(torch.cuda.device_count(), 1))


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's block [b, ...] (the same shape on every rank)
    concatenated in rank order along dim 0 -> [n * b, ...], on every rank.
    A bool block travels as uint8.  Each call over a group is counted
    (`core.graphs.count_collective`)."""
    group = resolve(group)
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    count_collective("all_gather")
    dist.all_gather(list(out.chunk(n)), src, group=group)
    return out.bool() if x.dtype == torch.bool else out


class _Clock:
    """Host ms of one collective call, the device synchronised before and
    after, into `stats` (a list; None: nothing synchronised or kept)."""

    def __init__(self, stats: Optional[list], x: torch.Tensor):
        self.stats = stats
        self.sync = torch.cuda.synchronize if x.device.type == "cuda" else (lambda: None)
        if stats is not None:
            self.sync()
        self.t0 = time.perf_counter()

    def done(self, **info) -> None:
        if self.stats is not None:
            self.sync()
            self.stats.append(dict(info, ms=(time.perf_counter() - self.t0) * 1e3))


def gather_slabs(x: torch.Tensor, group=None, stats: Optional[list] = None) -> torch.Tensor:
    """Row slabs x: [B, r, W] of every rank, in rank order -> the image
    [B, n r, W] on every rank (one all-gather); `stats` as `exchange_halo`'s."""
    group = resolve(group)
    n = world_size(group)
    clock = _Clock(stats, x)
    out = all_gather_rows(x.transpose(0, 1).contiguous(), group).transpose(0, 1)
    sent = x.numel() * x.element_size() if n > 1 else 0
    clock.done(rows=x.shape[1], halo=0, calls=int(n > 1), bytes_sent=sent,
               bytes_gathered=n * sent)
    return out


def exchange_halo(x: torch.Tensor, h: int, group=None, stats: Optional[list] = None):
    """Halo exchange of an image split into row slabs: rank i holds x =
    rows [i r, (i + 1) r) of every frame, x: [B, r, W].  Returns [B, r + 2h,
    W], the rows [i r - h, (i + 1) r + h), where a row outside the image
    [0, n r) is the image's edge row (replicate padding): the result of the
    reference's ring of `ppermute` hops (`siftgpu_tpu/parallel/spatial.py::
    _exchange_halo`).

    One all-gather: each rank sends its top and bottom h rows, or its whole
    slab when h >= r (the slab holds no more rows; the coarse octaves), and
    takes what it needs from its neighbours' blocks.  One rank sends
    nothing.  `stats`, if given, gets a dict of the call's slab rows, halo,
    calls, bytes sent and gathered, and host ms (the device synchronised
    before and after)."""
    group = resolve(group)
    n, idx = world_size(group), rank(group)
    B, r, W = x.shape
    clock = _Clock(stats, x)
    if n == 1 or h >= r:                      # this slab, or every whole slab
        full = x if n == 1 else gather_slabs(x, group)
        off, sent = 0, (0 if n == 1 else x.numel())
    else:                                     # the top and bottom h rows of each slab
        edge = torch.cat([x[:, :h], x[:, r - h:]], dim=1)
        blocks = all_gather_rows(edge[None], group)                        # [n, B, 2h, W]
        parts = ([blocks[idx - 1, :, h:]] if idx > 0 else []) + [x] + (
            [blocks[idx + 1, :, :h]] if idx < n - 1 else [])
        full, off, sent = torch.cat(parts, dim=1), idx * r - (h if idx > 0 else 0), edge.numel()
    rows = torch.arange(idx * r - h, (idx + 1) * r + h, device=x.device)
    out = full.index_select(1, rows.clamp(0, n * r - 1) - off)
    clock.done(rows=r, halo=h, calls=int(n > 1), bytes_sent=sent * x.element_size(),
               bytes_gathered=n * sent * x.element_size() if n > 1 else 0)
    return out


def _run_rank(rank_: int, fn: Callable, n: int, backend: str, device: str, store: str,
              timeout: float, out_dir: str, threads: Optional[int], args: tuple) -> None:
    """One spawned rank: join the group, run fn(*args, group=, device=),
    write its result, leave the group.  Into `out_dir`: `<rank>.error`,
    fn's traceback if it raised, written before the rank leaves the group
    (which fails its peers' collectives); `<rank>.fault`, every thread's
    stack if a fatal signal ends the process, from its start to its exit
    (faulthandler keeps the file open)."""
    faulthandler.enable(file=open(_rank_file(out_dir, rank_, "fault"), "w"), all_threads=True)
    if threads is not None:
        torch.set_num_threads(threads)
    dev = device_of(rank_, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, n), rank=rank_, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))
    returned = False
    try:
        result = fn(*args, group=dist.group.WORLD, device=dev)
        returned = True
        with open(_rank_file(out_dir, rank_, "pkl"), "wb") as f:
            pickle.dump(result, f)
    except Exception:
        with open(_rank_file(out_dir, rank_, "error"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if returned:   # no rank tears down its pairs while a peer may still use them
            dist.barrier(device_ids=[dev.index] if backend == "nccl" else None)
        dist.destroy_process_group()


def _rank_file(out_dir: str, rank_: int, kind: str) -> str:
    return os.path.join(out_dir, f"{rank_}.{kind}")


def _failure(procs, out_dir: str, tail: int = 6000) -> RuntimeError:
    """What `spawn` raises for a failed run of the processes `procs`, all
    joined: every rank's exit (0, an exit code, or a signal), then the
    faulthandler stacks of each rank that a fatal signal ended and the
    traceback of each rank whose fn raised.  A rank that died of a signal
    comes first: when one rank dies its peers fail next, in the collective
    it left, so their tracebacks follow from its death; then the ranks that
    raised, earliest error file first."""
    def read(r, kind):
        try:
            with open(_rank_file(out_dir, r, kind)) as f:
                return f.read()[-tail:]
        except FileNotFoundError:
            return ""

    def exit_of(p):
        if p.exitcode is not None and p.exitcode < 0:
            names = {s.value: s.name for s in signal.Signals}
            return f"died of signal {names.get(-p.exitcode, -p.exitcode)}"
        return "returned" if p.exitcode == 0 else f"exit code {p.exitcode}"

    n = len(procs)
    dead = [r for r in range(n) if read(r, "fault")]
    raised = sorted((r for r in range(n) if os.path.exists(_rank_file(out_dir, r, "error"))),
                    key=lambda r: os.path.getmtime(_rank_file(out_dir, r, "error")))
    exits = [f"rank {r} {exit_of(p)}" for r, p in enumerate(procs)]
    root = (dead + raised + [r for r, p in enumerate(procs) if p.exitcode])[:1]
    lines = [exits[root[0]] if root else "a rank failed", "; ".join(exits)]
    lines += [f"--- rank {r}: faulthandler stacks ---\n{read(r, 'fault')}" for r in dead]
    lines += [f"--- rank {r}: traceback ---\n{read(r, 'error')}" for r in raised]
    return RuntimeError("\n".join(lines))


def spawn(fn: Callable, n: int, backend: str, device, *args, timeout: float = 300.0,
          threads: Optional[int] = None) -> list:
    """Run `fn(*args, group=..., device=...)` in n new processes (the
    `spawn` start method: a parent that has initialised CUDA may start
    them), one rank each, in one process group of `backend` met through a
    file store; every collective times out after `timeout` seconds.
    `device` is "cuda" (rank r on cuda:(r % device_count)) or "cpu";
    `threads` sets each rank's torch threads.  `fn` must be importable by
    the children (a module-level function), and its result picklable.
    Returns the results in rank order; raises if any rank raised or died,
    after the others have been stopped: a `RuntimeError` that names each
    rank's exit and holds the faulthandler stacks of every rank that died
    of a signal and the traceback of every rank whose fn raised, a dead
    rank first (`_failure`)."""
    import torch.multiprocessing as mp

    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"nccl: {n} ranks on {torch.cuda.device_count()} device(s) would share "
                         "a device, which NCCL refuses; use as many ranks as devices")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = mp.start_processes(_run_rank, args=(fn, n, backend, str(device), store, timeout,
                                                    tmp, threads, args),
                                   nprocs=n, join=False, start_method="spawn")
        try:
            while not procs.join():
                pass
        except ProcessException as e:
            raise _failure(procs.processes, tmp) from e
        out = []
        for r in range(n):
            with open(_rank_file(tmp, r, "pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
