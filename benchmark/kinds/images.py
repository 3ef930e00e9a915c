"""Independent images: a ring of `ring` smoothed random textures
(`smooth`), extracted and matched as `_frames.FrameLoop` says."""

from benchmark.kinds._frames import ENTRIES, FrameLoop, control  # noqa: F401
from benchmark.lib import inputs


class Loop(FrameLoop):
    def make_frames(self, g, H, W):
        return inputs.textures(self.traffic["ring"], H, W, self.traffic["smooth"], g, self.device)
