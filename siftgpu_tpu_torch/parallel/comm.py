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
  - `spawn(fn, n, backend, device, *args)`: n processes started with the
    `spawn` method, met through a file store, each group with a timeout;
    returns each rank's picklable result, raises if a rank fails.

The backend is the caller's choice: "nccl" raises when two ranks would
share a device, and nothing falls back to another backend.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..optim.ba import all_reduce_sum

__all__ = ["rank", "world_size", "resolve", "device_of", "all_reduce_sum", "all_gather_rows",
           "spawn"]


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
    A bool block travels as uint8."""
    group = resolve(group)
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.chunk(n)), src, group=group)
    return out.bool() if x.dtype == torch.bool else out


def _run_rank(rank_: int, fn: Callable, n: int, backend: str, device: str, store: str,
              timeout: float, out_dir: str, threads: Optional[int], args: tuple) -> None:
    """One spawned rank: join the group, run fn(*args, group=, device=),
    write its result, leave the group."""
    if threads is not None:
        torch.set_num_threads(threads)
    dev = device_of(rank_, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, n), rank=rank_, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args, group=dist.group.WORLD, device=dev)
        with open(os.path.join(out_dir, f"{rank_}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


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
    after the others have been stopped."""
    import torch.multiprocessing as mp

    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"nccl: {n} ranks on {torch.cuda.device_count()} device(s) would share "
                         "a device, which NCCL refuses; use as many ranks as devices")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_run_rank, args=(fn, n, backend, str(device), store, timeout, tmp,
                                            threads, args),
                           nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
