"""BASELINE config 5 on `torch.distributed` (port of the config-5 half of
`siftgpu_tpu/parallel/`): data-parallel extraction (`dp`), distributed and
rank-resident windowed BA (`dist_ba`, `resident_ba`), an edge-sharded pose
graph (`dist_pose_graph`) and `sequence.run_slam_distributed`, over one
process group (`comm`)."""

from . import comm, dist_ba, dist_pose_graph, dp, resident_ba, sequence

__all__ = ["comm", "dist_ba", "dist_pose_graph", "dp", "resident_ba", "sequence"]
