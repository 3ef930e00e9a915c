"""Device microseconds a pair of every record but the match reduction's
(`match_best2_kernel`, `merge_rows_kernel`): the finalize, compaction,
copies and sets, over the profiled calls."""


def read(run):
    t = run.trace
    if t is None or not t.pairs or not t.device:
        return None
    return t.other_us({"match_best2_kernel", "merge_rows_kernel"}) / t.pairs
