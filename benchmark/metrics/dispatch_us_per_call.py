"""Host microseconds from a call's entry to its return, before the
synchronise, averaged over the window's calls before the profiled ones:
the captured entry points' input copies, replays and output clones as
the host issues them."""


def read(run):
    d = [c.dispatch_s for c in run.calls]
    return 1e6 * sum(d) / len(d) if d else None
