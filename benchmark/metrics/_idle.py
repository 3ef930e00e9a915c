"""The device's idle share of the profiled window: 100 x (1 - the union of
the device records' intervals over the window).  One definition for
`device_idle_pct.frames` and `device_idle_pct.pairs`, which differ only in
the end-to-end metric they move."""


def read(run):
    t = run.trace
    if t is None or t.window_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
