"""`_idle.read` in the cells that report frames_per_s."""

from benchmark.metrics._idle import read  # noqa: F401
