"""Process start to the first timed call: imports, the kernels' build (the
first run in a checkout), inputs made on the device, warm-up calls and
captures."""


def read(run):
    return run.setup_s
