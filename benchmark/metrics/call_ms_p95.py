"""The 95th percentile of every call of the window, each timed on the host
clock from its issue to its outputs being ready (one synchronise a call:
one waiting client)."""

import numpy as np


def read(run):
    lat = [c.latency_s for c in run.calls]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
