"""Frames fully processed in the window (extracted, and matched where the
cell matches) over the window's seconds: all the work over all the time."""


def read(run):
    return run.frames / run.window_s if run.frames else None
