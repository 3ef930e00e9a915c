"""Descriptor-set pairs matched in the window over the window's seconds."""


def read(run):
    return run.pairs / run.window_s if run.pairs else None
