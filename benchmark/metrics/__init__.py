"""One reader a metric, found by the metric's name in BENCHMARK.json
(`<name>.py`).  `read(run)` returns the metric's value, or None where the
run holds nothing for it to read (the harness then leaves it out).  `run`
is `lib.runner.Run`: the window's calls, its totals, the set-up time and,
in a `--trace 1` run, the profiled calls' `lib.trace.Trace`."""
