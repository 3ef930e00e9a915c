"""Per-host structured metrics stream (SURVEY §5.5).

Port of `siftgpu_tpu/pipeline/metrics.py`.  `MetricsLogger` writes JSON-lines
events stamped with (wall time, host/process index, pid); each process of a
`torch.distributed` job writes its own file (path gets a `.h<idx>` suffix),
so streams never interleave and a collector can merge by timestamp.

Usage:
    m = metrics.MetricsLogger(path)          # or path=None -> disabled
    m.event("extract_chunk", frames=8, ms=41.2)
    ...
    m.close()

`run_slam` accepts `metrics=` and emits per-frame tracking, keyframe,
BA-window and checkpoint events.  Disabled loggers cost one `if` per call.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

import numpy as np
import torch

__all__ = ["MetricsLogger", "host_index", "or_null"]


def host_index() -> int:
    """This process's rank in a `torch.distributed` job (0 when no process
    group is initialised)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class MetricsLogger:
    """JSONL event stream; one file per host.  `path=None` disables."""

    def __init__(self, path: Optional[str], host: Optional[int] = None):
        self.host = host_index() if host is None else host
        self._f: Optional[IO[str]] = None
        if path:
            if self.host:
                path = f"{path}.h{self.host}"
            self.path = path
            self._f = open(path, "a", buffering=1)  # line-buffered
        else:
            self.path = None

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def event(self, kind: str, **fields) -> None:
        if self._f is None:
            return
        rec = {"t": time.time(), "host": self.host, "pid": os.getpid(),
               "event": kind}
        for k, v in fields.items():
            if torch.is_tensor(v):
                v = v.detach().cpu().numpy()
            if hasattr(v, "item"):       # numpy values
                v = v.item() if np.ndim(v) == 0 else np.asarray(v).tolist()
            rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_NULL = MetricsLogger(None)


def or_null(m: Optional[MetricsLogger]) -> MetricsLogger:
    return m if m is not None else _NULL
