"""Device milliseconds a frame of every record that is not a hand kernel
(cuDNN, sorts, gathers, matmuls, elementwise ops, copies and sets) over the
profiled calls."""


def read(run):
    t = run.trace
    if t is None or not t.frames or not t.device:
        return None
    return t.other_us(set(t.hand)) * 1e-3 / t.frames
