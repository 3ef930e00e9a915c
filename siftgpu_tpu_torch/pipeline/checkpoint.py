"""Checkpoint / resume for the SLAM map and trajectory (SURVEY.md §5.4).

Port of `siftgpu_tpu/pipeline/checkpoint.py`: map + keyframe + trajectory
state snapshots to NPZ with the reference's keys and dtypes, so a file that
either package writes loads in the other.  The snapshot carries the FULL
windowed-BA context — the last `kf_window` keyframes' host keypoints and
pt_ids, descriptors for the two live keyframes, the loop-closure archive and
the constant-velocity tracker state — so a resumed run replays the
uninterrupted one.  Descriptors that live on a device are copied to the host
here.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from . import slam as slam_mod

__all__ = ["save_slam_state", "load_slam_state", "SlamCheckpoint"]


class SlamCheckpoint:
    def __init__(self, data: dict):
        self.data = data

    @property
    def next_frame(self) -> int:
        return int(self.data["next_frame"])


def _np(a) -> np.ndarray:
    """A host copy of a NumPy array or a tensor on any device."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_slam_state(path: str, res: slam_mod.SlamResult, next_frame: int,
                    keyframes: Optional[List] = None,
                    vel: Optional[np.ndarray] = None,
                    kf_window: int = 4) -> None:
    """Snapshot trajectory-so-far + map + the windowed-BA keyframe context.

    `keyframes` defaults to `res.keyframes`; `vel` defaults to `res.vel`
    (the tracker's constant-velocity state — required for exact resume).
    Published atomically: a tmp file, fsync, then `os.replace`."""
    if keyframes is None:
        keyframes = res.keyframes
    if vel is None:
        vel = getattr(res, "vel", None)
    payload = dict(
        trajectory=res.trajectory,
        keyframe_indices=np.asarray(res.keyframe_indices, np.int64),
        map_points=res.map_points,
        map_mask=res.map_mask,
        num_tracked=np.asarray(res.num_tracked, np.int64),
        next_frame=np.asarray(next_frame, np.int64),
        vel=np.zeros(6, np.float32) if vel is None else np.asarray(vel, np.float32),
    )
    anchor = getattr(res, "map_anchor", None)
    if anchor is not None:
        payload["map_anchor"] = np.asarray(anchor, np.int32)
    map_n = getattr(res, "map_n", None)
    if map_n is not None:
        # slot-allocation high-water mark: fusion frees slots below it
        payload["map_n"] = np.asarray(map_n, np.int64)
    edges = getattr(res, "loop_edges", None) or []
    # ragged per-edge fuse-pair lists stored flat + offsets; legacy 4-tuple
    # edges contribute empty slices
    fps = [
        (np.asarray(e[4], np.int64).reshape(-1, 2)
         if len(e) > 4 and e[4] is not None else np.zeros((0, 2), np.int64))
        for e in edges
    ]
    payload.update(
        loop_i=np.asarray([e[0] for e in edges], np.int64),
        loop_j=np.asarray([e[1] for e in edges], np.int64),
        loop_rel=(np.stack([e[2] for e in edges])
                  if edges else np.zeros((0, 7), np.float32)),
        loop_w=np.asarray([e[3] for e in edges], np.float32),
        loop_fuse_pairs=(np.concatenate(fps) if fps else np.zeros((0, 2), np.int64)),
        loop_fuse_off=np.cumsum([0] + [len(f) for f in fps]).astype(np.int64),
    )
    # stored odometry measurements (the final pose graph's honest edges)
    odo = getattr(res, "odo_edges", None) or []
    payload.update(
        odo_i=np.asarray([e[0] for e in odo], np.int64),
        odo_j=np.asarray([e[1] for e in odo], np.int64),
        odo_rel=(np.stack([e[2] for e in odo]) if odo else np.zeros((0, 7), np.float32)),
    )
    if keyframes:
        # window keyframes: everything the windowed BA reads; the two LIVE
        # keyframes additionally keep descriptors
        nw = max(kf_window, 2)
        win = keyframes[-nw:]
        payload.update(
            kfw_frame_idx=np.asarray([k.frame_idx for k in win], np.int64),
            kfw_pose=np.stack([np.asarray(k.pose, np.float32) for k in win]),
            kfw_x=np.stack([np.asarray(k.kp["x"]) for k in win]),
            kfw_y=np.stack([np.asarray(k.kp["y"]) for k in win]),
            kfw_mask=np.stack([np.asarray(k.kp["mask"]) for k in win]),
            kfw_pt_ids=np.stack([np.asarray(k.pt_ids, np.int64) for k in win]),
            kfw_desc=np.stack([_np(k.kp["desc"]) for k in win[-2:]]),
            kfw_n_desc=np.asarray(min(2, len(win)), np.int64),
        )
        # loop-closure archive: retired keyframes' host descriptors and the
        # fields detect_loop's dual PnP reads
        arch = [
            (i, k) for i, k in enumerate(keyframes)
            if isinstance(getattr(k, "kp", None), dict)
            and k.kp.get("desc_host") is not None
        ]
        if arch:
            payload.update(
                arch_pos=np.asarray([i for i, _ in arch], np.int64),
                arch_desc=np.stack([k.kp["desc_host"] for _, k in arch]),
                arch_mask=np.stack([np.asarray(k.kp["mask"]) for _, k in arch]),
                arch_x=np.stack([np.asarray(k.kp["x"]) for _, k in arch]),
                arch_y=np.stack([np.asarray(k.kp["y"]) for _, k in arch]),
                arch_pt_ids=np.stack([np.asarray(k.pt_ids, np.int64) for _, k in arch]),
            )
        # legacy single-keyframe fields for older readers
        last = keyframes[-1]
        payload.update(
            kf_pose=last.pose,
            kf_frame_idx=np.asarray(last.frame_idx, np.int64),
            kf_x=last.kp["x"], kf_y=last.kp["y"],
            kf_desc=_np(last.kp["desc"]),
            kf_mask=last.kp["mask"],
            kf_pt_ids=last.pt_ids,
        )
    # atomic publish: a crash mid-write must never leave a truncated
    # checkpoint — write to a sibling tmp file, fsync, then rename
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_slam_state(path: str) -> SlamCheckpoint:
    with np.load(path) as z:
        return SlamCheckpoint({k: z[k] for k in z.files})
