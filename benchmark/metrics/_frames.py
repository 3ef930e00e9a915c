"""Shapes of a frame cell's extraction, from the configuration file alone."""

from benchmark.reference.sift import SiftParams


def params(run) -> SiftParams:
    return SiftParams(**run.loop.config["sift"])


def octaves(run):
    """[(o, H, W)] of the configuration's octaves."""
    p = params(run)
    return [(o, *p.octave_shape(o)) for o in range(p.octaves)]


def share(run, kernel: str, works) -> float:
    """100 x the least time of `works` over the device time of `kernel`'s
    records in the profiled calls; None where a record was lost or none ran."""
    from benchmark.roofline.peaks import least_seconds

    t = run.trace
    if t is None or not t.records_sound(kernel):
        return None
    us = t.kernel_us(kernel)
    return 100.0 * least_seconds(works) / (us * 1e-6) if us > 0 else None
