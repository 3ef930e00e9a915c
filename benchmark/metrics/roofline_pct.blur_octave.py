"""`blur_octave_kernel`'s share of its roofline over the profiled calls:
the frozen `blur_octave_work` of every octave of every extraction call."""

from benchmark.metrics import _frames
from benchmark.roofline.blur_octave_work import blur_octave_work


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    p = _frames.params(run)
    radii = [(len(p.gaussian_taps(float(s))) - 1) // 2 for s in p.incremental_sigmas()]
    B = run.loop.batch
    works = [blur_octave_work(B, H, W, radii) for _, H, W in _frames.octaves(run)]
    return _frames.share(run, "blur_octave_kernel", works * (t.frames // B))
