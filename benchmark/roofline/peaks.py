"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates): 3.35 TB/s of HBM, 67 TFLOP/s in f32 outside the
tensor cores, 1,979 TOP/s in int8.  A `Work` is a call's bytes (each input
byte read once, each output byte written once) and its operations by type."""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12, "int8": 1979e12}

F32, BF16, I32, U8 = 4, 2, 4, 1


class Work(NamedTuple):
    bytes: int
    ops: Dict[str, int]


def least_seconds(works: Iterable[Work]) -> float:
    """The least time the card could take for these calls together: the
    larger of their bytes over the memory rate and their operations over
    the peak rate of each type (summed over types)."""
    works = list(works)
    t_bytes = sum(w.bytes for w in works) / PEAK_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[k] for w in works for k, n in w.ops.items())
    return max(t_bytes, t_ops)
