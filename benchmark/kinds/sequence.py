"""A recorded sequence: a ring of `ring` frames of one texture (`smooth`)
seen by a camera that moves `shift_px` (dx, dy) a frame, extracted and
matched as `_frames.FrameLoop` says."""

from benchmark.kinds._frames import ENTRIES, FrameLoop, control  # noqa: F401
from benchmark.lib import inputs


class Loop(FrameLoop):
    def make_frames(self, g, H, W):
        t = self.traffic
        return inputs.sequence(t["ring"], H, W, t["shift_px"], t["smooth"], g, self.device)
