"""`siftgpu_tpu/parallel/` on `torch.distributed`, over one process group
(`comm`): BASELINE config 5 — data-parallel extraction (`dp`), distributed
and rank-resident windowed BA (`dist_ba`, `resident_ba`), an edge-sharded
pose graph (`dist_pose_graph`) and `sequence.run_slam_distributed` — config
3's row slabs with their halo exchange (`spatial`), and the multi-rank dry
run over every leg (`dryrun`)."""

from . import comm, dist_ba, dist_pose_graph, dp, dryrun, resident_ba, sequence, spatial

__all__ = ["comm", "dist_ba", "dist_pose_graph", "dp", "dryrun", "resident_ba", "sequence",
           "spatial"]
