"""`_idle.read` in the cell that reports pairs_per_s."""

from benchmark.metrics._idle import read  # noqa: F401
