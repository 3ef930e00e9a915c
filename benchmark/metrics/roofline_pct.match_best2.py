"""The best-2 match reduction's share of its roofline over the profiled
calls: the frozen `match_best2_work(P, N0, N1)` of each batched call over
the device time of `match_best2_kernel` and its split merge,
`merge_rows_kernel`."""

from benchmark.roofline.match_best2_work import match_best2_work
from benchmark.roofline.peaks import least_seconds


def read(run):
    t = run.trace
    if t is None or not t.pairs:
        return None
    if not t.records_sound("match_best2_kernel", "merge_rows_kernel"):
        return None
    K = run.loop.config["sift"]["max_keypoints"]
    P = run.loop.pairs_per_call
    us = t.kernel_us("match_best2_kernel") + t.kernel_us("merge_rows_kernel")
    works = [match_best2_work(P, K, K)] * (t.pairs // P)
    return 100.0 * least_seconds(works) / (us * 1e-6) if us > 0 else None
