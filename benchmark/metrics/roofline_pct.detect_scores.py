"""`detect_scores_kernel`'s share of its roofline over the profiled calls:
the frozen `detect_scores_work` of every octave of every extraction call."""

from benchmark.metrics import _frames
from benchmark.roofline.detect_scores_work import detect_scores_work


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    S = _frames.params(run).dog_levels
    B = run.loop.batch
    works = [detect_scores_work(B, S, H, W) for _, H, W in _frames.octaves(run)]
    return _frames.share(run, "detect_scores_kernel", works * (t.frames // B))
