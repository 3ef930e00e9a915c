"""Incremental monocular SLAM loop (the north-star back end, BASELINE.json:5).

Port of `siftgpu_tpu/pipeline/slam.py`.  A host-orchestrated sequential loop
over fixed-shape device work: the card does extraction, matching, PnP,
triangulation, windowed BA, the pose graph and every `exp_se3`; the host
does keyframe/map bookkeeping (slot allocation) between steps, in NumPy as
the reference does.

Pipeline per frame:
  extract -> match against the live keyframes -> 2D-3D PnP (robust GN) ->
  keyframe decision -> [new KF: triangulate unmapped matches, insert map
  points, windowed Schur-complement BA over the last W keyframes, loop
  detection against the archived keyframes]

World frame = camera 0; monocular scale is fixed by the bootstrap baseline
(|t| = 1).  Trajectory accuracy is evaluated with Sim(3)-aligned ATE
(`geometry/align.py`).

Differences from the reference:
  - where the reference calls a compiled program of a fixed signature, the
    loop calls its captured counterpart (`core/graphs.py`: a CUDA graph
    per signature on the card, the eager function on CPU tensors): the
    tracking step `_track_step_jit` (or `_match_kf_jit` on pre-extracted
    features), the bootstrap's `extract_features_jit` and
    `match_descriptors_jit`, the loop search `_loop_match_jit` (C is a
    pow2 bucket) and the refit's `ba.refine_points_jit` (pow2 buckets of
    observations and cameras, weight-0 rows).  A replay computes what the
    eager call computes, so the run is bit for bit the eager run's.  PnP,
    the windowed BA, the bootstrap RANSAC, triangulation and the pose
    graph stay eager: each call has a new N, and a capture per N costs
    more than it saves, while padding to buckets changes the reductions'
    order and so the rounding (ROADMAP section 1 item 6);
  - each tracked frame's pairs, counts, x, y and mask come back in ONE copy
    (`_Pull`): packed on the card, copied without blocking into pinned host
    memory, an event recorded, and only then frame t+1 is enqueued
    speculatively; the host waits on the event, not on the stream, so t+1's
    kernels are not waited for.  Host -> card uploads on the frame path go
    from pinned memory without blocking (`_upload`) for the same reason.
    The outputs are those of the sequential loop;
  - the bootstrap's RANSAC draws its 256 minimal sets with
    `epipolar.sample_minimal_sets` from `generator` (default: a generator
    on the device seeded with 0) where the reference uses
    `jax.random.PRNGKey(0)`: the two draw different sets;
  - PnP, triangulation, BA, the pose graph and the Sim(3) algebra run with
    TF32 off (`full_f32`, inside those modules): the loop's gates are pixel
    thresholds;
  - `features=` takes any object with `frame_feats(t)` (desc [1, K, 128]
    and mask [1, K] on the device) and host `x`, `y`, `mask` [T, K], as
    `parallel.sequence.SequenceFeatures` is;
  - `timings=` (a dict) collects host milliseconds per stage; each stage
    ends in a pull of its results, so the host clock spans its device work.
"""

from __future__ import annotations

import dataclasses
import time
import types
from contextlib import contextmanager
from typing import List, Optional

import numpy as np
import torch

from ..core.graphs import graphed
from ..frontend.extract import extract_features, extract_features_jit
from ..frontend.match import match_descriptors_batch, match_descriptors_jit
from ..geometry import epipolar
from ..geometry import pose as P
from ..optim import ba, pnp
from ..optim import pose_graph as pg
from . import metrics as metrics_mod
from .api import _require

__all__ = [
    "SlamConfig", "Keyframe", "SlamResult", "run_slam",
    "apply_pose_graph_sim3", "refit_map_points",
]


# ---------------- one copy per pull, uploads without a sync ----------------

def _as_i32(t: torch.Tensor) -> torch.Tensor:
    """A tensor's values as int32 words: f32 by its bits, ints and bools by
    value (the loop's indices are far below 2^31)."""
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32).reshape(-1)
    return t.to(torch.int32).reshape(-1)


class _Pull:
    """Several tensors of one device packed into one int32 buffer and copied
    to the host in one transfer.  On a CUDA device the copy goes into pinned
    memory without blocking and an event marks its end: `wait()` waits on
    that event only, so work enqueued after `start` keeps running."""

    def __init__(self, tensors):
        self.meta = [(t.dtype, tuple(t.shape)) for t in tensors]
        packed = torch.cat([_as_i32(t) for t in tensors])
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def wait(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        buf = self.host.numpy()
        out, o = [], 0
        for dt, shape in self.meta:
            n = int(np.prod(shape, dtype=np.int64))
            w = buf[o:o + n]
            o += n
            if dt == torch.float32:
                a = w.view(np.float32)
            elif dt == torch.bool:
                a = w != 0
            else:
                a = w.astype(np.int64) if dt == torch.int64 else w.copy()
            out.append(a.reshape(shape))
        return out


def _pull(*tensors) -> list:
    """Blocking one-copy pull of several tensors -> NumPy arrays."""
    return _Pull(tensors).wait()


_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64,
             torch.uint8: np.uint8, torch.bool: np.bool_}


def _upload(dev: torch.device, *arrays, dtype=torch.float32) -> list:
    """NumPy arrays -> tensors of `dtype` on `dev` in one copy; on a CUDA
    device from pinned memory without blocking (a pageable copy would wait
    for the stream, and with it for the speculative next frame)."""
    arrs = [np.ascontiguousarray(a, dtype=_NP_DTYPE[dtype]) for a in arrays]
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrs]))
    if dev.type == "cuda":
        flat = flat.pin_memory().to(dev, non_blocking=True)
    out, o = [], 0
    for a in arrs:
        out.append(flat[o:o + a.size].view(a.shape))
        o += a.size
    return out


# ---------------- the device steps (the reference's jitted functions) ----------

def _match_kf(kf_desc, kf_mask, f_desc, f_mask, mcfg):
    """The frame's descriptors [K, 128] against P keyframes' [P, K, 128] (or
    the C archive rows) in one batched match.  Returns (pairs [P, M, 2],
    counts [P])."""
    n = kf_desc.shape[0]
    res = match_descriptors_batch(kf_desc, f_desc.expand(n, -1, -1), kf_mask,
                                  f_mask.expand(n, -1), mcfg)
    return res.pairs, res.count


_loop_match = _match_kf


def _track_step(frame, kf_desc, kf_mask, cfg, mcfg):
    """Extraction of one frame [H, W] fused with its match against the live
    keyframes.  Returns (feats, pairs [P, M, 2], counts [P])."""
    feats = extract_features(frame[None], cfg)
    pairs, counts = _match_kf(kf_desc, kf_mask, feats.desc[0], feats.mask[0], mcfg)
    return feats, pairs, counts


# the reference's jitted steps: captured once per signature on CUDA inputs
# (`core/graphs.py`); `run_slam` calls these, never the eager functions above
_track_step_jit = graphed(_track_step, "_track_step_jit")
_match_kf_jit = graphed(_match_kf, "_match_kf_jit")
_loop_match_jit = graphed(_loop_match, "_loop_match_jit")


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    max_map_points: int = 4096
    kf_window: int = 4             # windowed BA span (keyframes)
    kf_min_inliers: int = 80       # new KF when tracking inliers drop below
    kf_flow_px: float = 12.0       # ... or median flow vs last KF exceeds
    pnp_iters: int = 10
    huber_px: float = 3.0
    inlier_px: float = 3.0
    ba_iters: int = 6
    ba_cg: int = 20
    min_depth: float = 0.05
    max_depth: float = 1e3
    tri_reproj_px: float = 2.0
    # bootstrap parallax requirement: below ~10 px the essential matrix is
    # rotation-dominated and the initial map is unusable
    init_flow_px: float = 10.0
    # --- tracking-loss state + relocalization --- below `lost_min_inliers`
    # PnP inliers tracking has FAILED (occlusion, blur, blackout): the
    # tracker freezes pose and velocity, inserts NO keyframes and
    # triangulates nothing; it recovers through live-KF matching or
    # `relocalize` against the archived keyframes.  `track_lost=False`
    # restores the legacy trigger that conflated failure with motion.
    track_lost: bool = True
    lost_min_inliers: int = 10
    relocalize: bool = True
    reloc_min_matches: int = 20    # descriptor matches to try a candidate
    reloc_min_inliers: int = 10    # PnP inliers to accept re-registration
    # --- loop closure --- each new keyframe is matched against the
    # archived descriptors of RETIRED keyframes (one batched match),
    # verified by a dual PnP against the old map region, and recorded as a
    # measured relative Sim(3) edge for the pose graph
    loop_closure: bool = True
    loop_min_matches: int = 30     # descriptor matches to consider a revisit
    loop_kf_gap: int = 4           # min keyframe-index separation of a pair
    # min FRAME separation: nearby-in-time keyframes overlap views without
    # being revisits, and their edges carry the local map scale
    loop_min_frame_gap: int = 12
    loop_min_inliers: int = 12     # PnP inliers to accept the loop edge
    # measure relative SCALE on loop edges from the revisit pair's
    # duplicated map points (a median pairwise-distance ratio, gated on
    # its spread)
    loop_sim3_scale: bool = True
    # apply strong loop corrections ONLINE (Sim(3) pose graph over the
    # keyframe chain, trajectory prefix and map, landmark fusion)
    loop_online: bool = True
    loop_online_min_inliers: int = 25
    # ... only when the loop discrepancy exceeds this many median keyframe
    # steps
    loop_online_min_drift: float = 1.0
    # ... snapping only the last `loop_online_free_kfs` keyframes (the
    # established chain and its map stay frozen)
    loop_online_free_kfs: int = 6
    # fuse duplicated landmarks identified by the loop match (new slot ->
    # old slot in every keyframe's pt_ids)
    loop_fuse: bool = True


@dataclasses.dataclass
class Keyframe:
    frame_idx: int
    pose: np.ndarray        # [6] world->cam twist
    feats: object           # device Features (batch 1), or None once retired
    kp: dict                # host x, y, mask; device desc (None once retired)
    pt_ids: np.ndarray      # [K] map slot per keypoint (-1 = none)


@dataclasses.dataclass
class SlamResult:
    trajectory: np.ndarray  # [T, 6] per-frame world->cam twists
    keyframe_indices: List[int]
    map_points: np.ndarray  # [M, 3]
    map_mask: np.ndarray    # [M]
    num_tracked: List[int]  # PnP inliers per frame
    keyframes: Optional[List["Keyframe"]] = None
    # constant-velocity tracker state at the end of the run (checkpointed
    # so a resumed run replays the uninterrupted one exactly)
    vel: Optional[np.ndarray] = None
    # measured loop-closure constraints: (kf_i, kf_j, rel_sim3 [7], weight,
    # fuse_pairs [F, 2]) in the [omega, t, log_scale] chart of
    # `optim/pose_graph.srt_to_sim7`; 4 long in legacy checkpoints
    loop_edges: Optional[List[tuple]] = None
    # anchor keyframe (index into `keyframes`) of each map slot
    map_anchor: Optional[np.ndarray] = None
    # slot-allocation high-water mark (fusion frees slots below it)
    map_n: Optional[int] = None
    # stored odometry MEASUREMENTS [(kf_a, kf_b, rel_sim7), ...]
    odo_edges: Optional[List[tuple]] = None


def apply_pose_graph_sim3(
    keyframes, trajectory, map_X, map_mask, map_anchor, loop_edges,
    optimizer=None, iters: int = 10, loop_weight: float = 8.0,
    upto_frame: Optional[int] = None, fuse: bool = True,
    odo_edges=None, n_fix: int = 1, device="cuda",
) -> bool:
    """Sim(3) pose-graph correction over the keyframe chain, applied to the
    WHOLE SLAM state in place: keyframe poses, the trajectory (keyframe rows
    exactly, non-keyframe rows re-anchored to their preceding keyframe), the
    MAP (each point rides its anchor keyframe's Sim(3) correction), and the
    duplicated landmarks the loop matches identified are fused (new slot ->
    old slot).

    Graph: odometry edges (stored measurements `odo_edges`, missing
    consecutive pairs filled from the current poses; or, without them,
    consecutive + skip-1 relatives at the current optimum) + the measured
    loop edges, inlier-weighted.  Without loop edges this is a no-op
    (returns False).  `optimizer`: callable (Sim3PoseGraph, iters, n_fix) ->
    (graph, costs); defaults to the dense solver up to 64 keyframes and the
    matrix-free PCG solver beyond.  `n_fix` freezes the first n keyframes
    (the online policy); `upto_frame` bounds the trajectory rows touched.
    The graph and the transforms run on `device`.  Mutates
    `map_X`/`map_mask`/`trajectory` and the keyframes; returns True iff a
    correction was applied.

    Map-point transform: for anchor keyframe with pre-correction pose
    (R_o, t_o) and optimized Sim(3) node (s, R, t), a point moves as
    X' = (1/s) R^T ((R_o X + t_o) - t)."""
    dev = torch.device(device)
    _require(dev)
    kfs = keyframes
    if kfs is None or len(kfs) < 3 or not loop_edges:
        return False
    loops = [e for e in loop_edges if e[1] < len(kfs)]
    if not loops:
        return False
    Mk = len(kfs)
    (poses6,) = _upload(dev, np.stack([k.pose for k in kfs]))
    R0, t0 = P.exp_se3(poses6)
    poses = pg.srt_to_sim7(torch.ones(Mk, device=dev), R0, t0)
    if odo_edges is not None:
        odo = [e for e in odo_edges if e[0] < Mk and e[1] < Mk]
        # legacy resumes may lack early measurements: fill missing
        # consecutive pairs from the current poses (zero-residual edges)
        have = {(int(e[0]), int(e[1])) for e in odo}
        miss = [i for i in range(Mk - 1) if (i, i + 1) not in have]
        if miss:
            (mi,) = _upload(dev, np.asarray(miss), dtype=torch.long)
            Rr_m, tr_m = P.relative(R0[mi], t0[mi], R0[mi + 1], t0[mi + 1])
            (rel_m,) = _pull(pg.srt_to_sim7(torch.ones(len(miss), device=dev), Rr_m, tr_m))
            odo = odo + [(i, i + 1, rel_m[n]) for n, i in enumerate(miss)]
        ei = np.asarray([e[0] for e in odo], np.int64)
        ej = np.asarray([e[1] for e in odo], np.int64)
        (t_meas,) = _upload(dev, np.stack([e[2] for e in odo]))
    else:
        ei, ej = [], []
        for i in range(Mk - 1):
            ei.append(i)
            ej.append(i + 1)
            if i + 2 < Mk:
                ei.append(i)
                ej.append(i + 2)
        ei, ej = np.asarray(ei, np.int64), np.asarray(ej, np.int64)
        eit, ejt = _upload(dev, ei, ej, dtype=torch.long)
        Rr, tr = P.relative(R0[eit], t0[eit], R0[ejt], t0[ejt])
        t_meas = pg.srt_to_sim7(torch.ones(len(ei), device=dev), Rr, tr)
    ei_all = np.concatenate([ei, np.asarray([e[0] for e in loops], np.int64)])
    ej_all = np.concatenate([ej, np.asarray([e[1] for e in loops], np.int64)])
    # information-proportional edge weights: a loop verified by more PnP
    # inliers is a better-conditioned measurement
    weight = np.concatenate([np.ones(len(ei), np.float32),
                             np.asarray([loop_weight * e[3] / 80.0 for e in loops], np.float32)])
    loop_meas, weight_t = _upload(dev, np.stack([e[2] for e in loops]), weight)
    eit, ejt = _upload(dev, ei_all, ej_all, dtype=torch.long)
    graph = pg.Sim3PoseGraph(poses=poses, edge_i=eit, edge_j=ejt,
                             t_meas=torch.cat([t_meas, loop_meas]), weight=weight_t)
    n_fix = max(1, min(n_fix, Mk - 1))
    # eager: the graph's size changes every correction (ROADMAP section 1 item 6)
    if optimizer is not None:
        out, _ = optimizer(graph, iters, n_fix)
    elif Mk <= 64:
        out, _ = pg.optimize_pose_graph_sim3(graph, iters=iters, n_fix=n_fix)
    else:  # dense is O(M^3)/iter: matrix-free PCG beyond tiny graphs
        out, _ = pg.optimize_pose_graph_sim3_cg(graph, iters=iters, n_fix=n_fix)
    s_f, R_f, t_f = pg.sim7_to_srt(out.poses)
    # fold scale into SE(3): x_cam = s R x + t  <=>  x_cam/s = R x + t/s
    new_poses_t = P.log_se3(R_f, t_f / s_f[..., None])

    # ---- trajectory: keyframe rows exact, others re-anchored ----
    old_poses = np.stack([k.pose for k in kfs])
    kf_rows = np.asarray([k.frame_idx for k in kfs])
    T_total = len(trajectory)
    if upto_frame is not None:
        T_total = min(T_total, upto_frame + 1)
    rows = np.arange(T_total)
    anchor = np.maximum(np.searchsorted(kf_rows, rows, "right") - 1, 0)
    traj_t, old_t = _upload(dev, trajectory[:T_total], old_poses[anchor])
    (anc_t,) = _upload(dev, anchor, dtype=torch.long)
    Rt, tt = P.exp_se3(traj_t)
    Ro, to = P.exp_se3(old_t)
    Rn, tn = P.exp_se3(new_poses_t[anc_t])
    Rrel, trel = P.compose(Rt, tt, *P.inverse(Ro, to))
    Rtn, ttn = P.compose(Rrel, trel, Rn, tn)
    new_poses, s_fn, R_fn, t_fn, R_on, t_on, traj_new = _pull(
        new_poses_t, s_f, R_f, t_f, R0, t0, P.log_se3(Rtn, ttn))

    # ---- map repair: each point rides its anchor keyframe's correction ----
    if map_anchor is not None:
        sel = np.nonzero(map_mask & (map_anchor >= 0) & (map_anchor < Mk))[0]
        if len(sel):
            a = map_anchor[sel]
            xc = np.einsum("mij,mj->mi", R_on[a], map_X[sel]) + t_on[a]
            map_X[sel] = (
                np.einsum("mji,mj->mi", R_fn[a], xc - t_fn[a]) / s_fn[a][:, None]
            )
    traj_new = np.array(traj_new, np.float32)
    kf_in = kf_rows[kf_rows < T_total]
    traj_new[kf_in] = new_poses[: len(kf_in)]
    trajectory[:T_total] = traj_new
    for i, k in enumerate(kfs):
        k.pose = new_poses[i]

    # ---- fuse duplicated landmarks (new slot -> old slot) ----
    if fuse:
        remap = {}
        for e in loops:
            fp = e[4] if len(e) > 4 else None
            if fp is None:
                continue
            for o_s, n_s in np.asarray(fp).reshape(-1, 2):
                o_s, n_s = int(o_s), int(n_s)
                while o_s in remap:   # follow prior fusions of the old slot
                    o_s = remap[o_s]
                if o_s == n_s or not map_mask[n_s] or not map_mask[o_s]:
                    continue
                remap[n_s] = o_s
                map_mask[n_s] = False
        if remap:
            lut = np.arange(len(map_mask))
            for n_s, o_s in remap.items():
                lut[n_s] = o_s
            for _ in range(8):        # path-compress fusion chains
                lut2 = lut[lut]
                if (lut2 == lut).all():
                    break
                lut = lut2
            for k in kfs:
                ids = getattr(k, "pt_ids", None)
                if ids is not None and ids.size:
                    pos = ids >= 0
                    ids[pos] = lut[ids[pos]]
    return True


def refit_map_points(keyframes, map_X, map_mask, intr, iters: int = 3, device="cuda"):
    """Points-only Huber refit against the (pinned) current keyframe poses —
    `optim.ba.refine_points` over every observation the keyframes carry, on
    `device`.  Run after a Sim(3) pose-graph correction: the anchor
    transport is exact per anchor but slightly non-rigid across anchors.
    Shapes are bucketed (pow2 observations / cameras, weight-0 padding) as
    in the reference.  Mutates map_X in place."""
    dev = torch.device(device)
    _require(dev)
    kfs = [
        k for k in keyframes
        if isinstance(getattr(k, "kp", None), dict)
        and k.kp.get("x") is not None and k.pt_ids.size
    ]
    if len(kfs) < 2:
        return
    obs_c, obs_p, obs_uv = [], [], []
    for ci, k in enumerate(kfs):
        sel = np.nonzero(k.pt_ids >= 0)[0]
        obs_c += [ci] * len(sel)
        obs_p += list(k.pt_ids[sel])
        obs_uv += list(np.stack([np.asarray(k.kp["x"])[sel], np.asarray(k.kp["y"])[sel]], 1))
    n = len(obs_c)
    if n < 10:
        return
    nb = 1
    while nb < n:
        nb *= 2
    mb = 1
    while mb < len(kfs):
        mb *= 2
    cams = np.zeros((mb, 6), np.float32)
    cams[: len(kfs)] = np.stack([k.pose for k in kfs])
    ci_a = np.zeros(nb, np.int32)
    pi_a = np.zeros(nb, np.int32)
    uv_a = np.zeros((nb, 2), np.float32)
    w_a = np.zeros(nb, np.float32)
    ci_a[:n] = obs_c
    pi_a[:n] = obs_p
    uv_a[:n] = np.stack(obs_uv)
    w_a[:n] = 1.0
    cams_t, pts_t, intr_t, uv_t, w_t = _upload(dev, cams, map_X, np.asarray(intr, np.float32),
                                               uv_a, w_a)
    ci_t, pi_t = _upload(dev, ci_a, pi_a, dtype=torch.int32)
    prob = ba.BAProblem(cams=cams_t, points=pts_t, intrinsics=intr_t,
                        cam_idx=ci_t, pt_idx=pi_t, uv=uv_t, w=w_t)
    (map_X[:],) = _pull(ba.refine_points_jit(prob, iters))


@contextmanager
def _stage(timings: Optional[dict], name: str):
    """Host ms of a stage appended to timings[name] (when timings is given)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)


def run_slam(frames, intr, cfg, mcfg, scfg: SlamConfig,
             gt_for_debug: Optional[np.ndarray] = None,
             resume=None, features=None, ba_fn=None,
             metrics=None, checkpoint_path=None, pg_fn=None,
             device="cuda", generator: Optional[torch.Generator] = None,
             timings: Optional[dict] = None) -> SlamResult:
    """frames: [T, H, W] float NumPy array or tensor; intr: (fx, fy, cx, cy).
    Everything the loop sends to a device goes to `device` (default the
    card; raises without one — pass device="cpu" for the plain versions).

    `resume`: a `checkpoint.SlamCheckpoint` — restores the map, trajectory
    prefix and windowed-BA keyframe context and continues at its
    `next_frame` (frames must be the SAME full sequence).
    `features`: pre-extracted features (`frame_feats(t)` -> device Features
    of batch 1; host `x`, `y`, `mask` [T, K]) — the loop then only matches.
    `ba_fn`: optional (BAProblem, iters, n_cg) -> BAState override of the
    windowed BA (e.g. `parallel.sequence.make_distributed_ba`), or a solver
    of the resident protocol (`ba_fn.resident` true, e.g.
    `parallel.resident_ba.ResidentBA`) that keeps the map's points on its
    devices: the loop binds the intrinsics once (`set_intrinsics`), then
    per window calls `solve(poses [W, 6], obs_c, obs_p, obs_uv, fixed [M],
    map_X, ba_iters, ba_cg)` -> (poses, cost), which writes the refined
    free points into the host `map_X` in place; the full map is not
    uploaded.
    `metrics`: a `pipeline.metrics.MetricsLogger` (JSONL events).
    `checkpoint_path`: after every keyframe's windowed BA the state is
    written atomically to this path (process 0 only).
    `pg_fn`: optional pose-graph optimizer for ONLINE loop corrections,
    (Sim3PoseGraph, iters, n_fix) -> (graph, costs).
    `generator`: a `torch.Generator` on `device` for the bootstrap RANSAC
    (default: one seeded with 0).
    `timings`: a dict that collects host ms per stage (track, pnp, ba,
    loop, correction, checkpoint)."""
    dev = torch.device(device)
    _require(dev)
    metrics = metrics_mod.or_null(metrics)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    (intr_t,) = _upload(dev, np.asarray(intr, np.float32))
    fxy = np.asarray(intr[:2])
    cxy = np.asarray(intr[2:])
    T = len(frames)
    M = scfg.max_map_points

    map_X = np.zeros((M, 3), np.float32)
    map_mask = np.zeros(M, bool)
    map_anchor = np.full(M, -1, np.int32)  # anchor KF index per map slot
    map_n = 0

    keyframes: List[Keyframe] = []
    # device-resident loop-closure archive cache (see _archive_match)
    arch_cache = {"cand": (), "C": 0, "d": None, "m": None}
    # odometry measurement store: (kf_a, kf_b) -> rel_sim7
    odo_store: dict = {}
    traj = np.zeros((T, 6), np.float32)
    tracked: List[int] = []
    vel = np.zeros(6, np.float32)  # constant-velocity tracker state
    loop_edges: List[tuple] = []

    def frame_on_device(t):
        f = frames[t]
        if torch.is_tensor(f):
            if f.device == dev:
                return f.to(torch.float32)
            f = f.cpu().numpy()
        (ft,) = _upload(dev, f)
        return ft

    def extract(t):
        if features is not None:
            return features.frame_feats(t)
        return extract_features_jit(frame_on_device(t)[None], cfg)

    def host_kp(t, ft):
        """Host copies of frame t's keypoints (one pull), or the
        pre-extracted host arrays."""
        if features is not None:
            return dict(x=features.x[t], y=features.y[t], desc=ft.desc[0], mask=features.mask[t])
        x, y, mask = _pull(ft.x[0], ft.y[0], ft.mask[0])
        return dict(x=x, y=y, desc=ft.desc[0], mask=mask)

    def match(fa, fb):
        res = match_descriptors_jit(fa.desc[0], fb.desc[0], fa.mask[0], fb.mask[0], mcfg)
        pairs, count = _pull(res.pairs, res.count)
        return pairs[: int(count)].astype(np.int64)

    def normalized(kp, idx):
        uv = np.stack([kp["x"][idx], kp["y"][idx]], 1)
        return (uv - cxy) / fxy, uv

    def rt(tw):
        (tw_t,) = _upload(dev, tw)
        return _pull(*P.exp_se3(tw_t))

    def solve_pnp(X, uv, pose0, iters):
        """PnP on the device -> (pose [6], inliers, inlier mask), one pull."""
        X_t, uv_t, p0 = _upload(dev, X, uv, pose0)
        w1 = torch.ones(len(X), dtype=torch.float32, device=dev)
        # eager: N changes every call (ROADMAP section 1 item 6)
        res = pnp.pnp_gn(X_t, uv_t, w1, intr_t, p0, iters=iters,
                         huber_px=scfg.huber_px, inlier_px=scfg.inlier_px)
        pose, n_inl, inl = _pull(res.pose, res.num_inliers, res.inliers)
        return pose, int(n_inl), inl

    def triangulate_pairs(kf: Keyframe, cur_kp, cur_pose, pairs):
        """Triangulate KF<->current matches; returns world points + accept mask."""
        Rk, tk = rt(kf.pose)
        Rc, tc = rt(cur_pose)
        x0n, _ = normalized(kf.kp, pairs[:, 0])
        x1n, _ = normalized(cur_kp, pairs[:, 1])
        # eager: N changes every keyframe (ROADMAP section 1 item 6)
        (X,) = _pull(P.triangulate(*_upload(dev, Rk, tk, Rc, tc, x0n, x1n)))
        zk = X @ Rk.T + tk
        zc = X @ Rc.T + tc
        ok = (zk[:, 2] > scfg.min_depth) & (zc[:, 2] > scfg.min_depth)
        ok &= (zk[:, 2] < scfg.max_depth) & (zc[:, 2] < scfg.max_depth)
        for (R_, t_, kp_, col) in ((Rk, tk, kf.kp, 0), (Rc, tc, cur_kp, 1)):
            pr = X @ R_.T + t_
            pr = fxy * pr[:, :2] / np.maximum(pr[:, 2:], 1e-9) + cxy
            uv = np.stack([kp_["x"][pairs[:, col]], kp_["y"][pairs[:, col]]], 1)
            ok &= np.linalg.norm(pr - uv, axis=1) < scfg.tri_reproj_px
        return X, ok

    def _record_odo():
        """Record/refresh odometry MEASUREMENTS (consecutive + skip-1 pairs)
        among the keyframes the BA window (+ bridging retired neighbour)
        can still move.  One batched device pass."""
        hi = len(keyframes)
        lo = max(0, hi - scfg.kf_window - 1)
        pairs = []
        for a in range(lo, hi - 1):
            for b in (a + 1, a + 2):
                if b < hi:
                    pairs.append((a, b))
        if not pairs:
            return
        pa, pb = _upload(dev, np.stack([keyframes[a].pose for a, _ in pairs]),
                         np.stack([keyframes[b].pose for _, b in pairs]))
        Ra, ta = P.exp_se3(pa)
        Rb, tb = P.exp_se3(pb)
        Rr, tr_ = P.relative(Ra, ta, Rb, tb)
        (rel,) = _pull(pg.srt_to_sim7(torch.ones(len(pairs), device=dev), Rr, tr_))
        for n_, ab in enumerate(pairs):
            odo_store[ab] = rel[n_]

    def windowed_ba():
        nonlocal map_X
        win = keyframes[-scfg.kf_window:]
        obs_c, obs_p, obs_uv = [], [], []
        for ci, k in enumerate(win):
            sel = np.nonzero(k.pt_ids >= 0)[0]
            obs_c += [ci] * len(sel)
            obs_p += list(k.pt_ids[sel])
            obs_uv += list(np.stack([k.kp["x"][sel], k.kp["y"][sel]], 1))
        if len(obs_c) < 10:
            return
        # landmarks whose anchor keyframe retired are FIXED: the window's
        # observations of them constrain the cameras but cannot drag
        # established geometry toward the recent window
        base = len(keyframes) - len(win)
        poses = np.stack([k.pose for k in win])
        if ba_fn is not None and getattr(ba_fn, "resident", False):
            # the solver owns the map's points on its devices: only the
            # observation lists and the host-changed slots travel, and the
            # window's free points come back into map_X in place
            if not getattr(ba_fn, "_intr_bound", False):
                ba_fn.set_intrinsics(np.asarray(intr, np.float32))
                ba_fn._intr_bound = True
            new_cams, cost = ba_fn.solve(poses, obs_c, obs_p, np.stack(obs_uv), map_anchor < base,
                                         map_X, scfg.ba_iters, scfg.ba_cg)
        else:
            cams, pts, uv = _upload(dev, poses, map_X, np.stack(obs_uv))
            ci_t, pi_t = _upload(dev, np.asarray(obs_c), np.asarray(obs_p), dtype=torch.int32)
            (fixed,) = _upload(dev, map_anchor < base, dtype=torch.bool)
            prob = ba.BAProblem(
                cams=cams, points=pts, intrinsics=intr_t, cam_idx=ci_t, pt_idx=pi_t, uv=uv,
                w=torch.ones(len(obs_c), dtype=torch.float32, device=dev), pt_fixed=fixed,
            )
            if ba_fn is not None:  # e.g. a distributed Schur solve
                state = ba_fn(prob, scfg.ba_iters, scfg.ba_cg)
            else:   # eager: N changes every keyframe (ROADMAP section 1 item 6)
                state = ba.run_ba(prob, iters=scfg.ba_iters, n_cg=scfg.ba_cg)
            new_cams, map_X, cost = _pull(state.cams, state.points, state.cost)
        for ci, k in enumerate(win):
            k.pose = new_cams[ci]
            traj[k.frame_idx] = new_cams[ci]
        _record_odo()
        metrics.event("ba_window", n_kf=len(win), n_obs=len(obs_c), cost=float(cost))

    def add_keyframe(t, feats, kp, pose_tw, mapped_pairs=None, prev_kf=None,
                     tri_pairs=None):
        nonlocal map_n, map_X, map_mask
        K = len(kp["x"])
        pt_ids = np.full(K, -1, np.int64)
        if mapped_pairs is not None:
            for mp, ki in mapped_pairs:
                pt_ids[ki] = mp
        kf = Keyframe(frame_idx=t, pose=np.asarray(pose_tw, np.float32),
                      feats=feats, kp=kp, pt_ids=pt_ids)
        # triangulate unmapped matches against the previous keyframe
        if prev_kf is not None and tri_pairs is not None and len(tri_pairs):
            X, ok = triangulate_pairs(prev_kf, kp, kf.pose, tri_pairs)
            for j in np.nonzero(ok)[0]:
                if map_n >= M:
                    break
                s = map_n
                map_X[s] = X[j]
                map_mask[s] = True
                # anchor = the inserting keyframe (index it takes on append)
                map_anchor[s] = len(keyframes)
                map_n += 1
                prev_kf.pt_ids[tri_pairs[j, 0]] = s
                kf.pt_ids[tri_pairs[j, 1]] = s
        keyframes.append(kf)
        # the new keyframe's odometry edges must exist BEFORE detect_loop
        # runs; refreshed post-BA by windowed_ba
        _record_odo()
        # retire device buffers of keyframes no longer matched against (only
        # the last two are): device memory stays flat over long runs;
        # retiring descriptors drop to the host-side loop-closure archive
        for old in keyframes[:-2]:
            if old.feats is not None:
                if scfg.loop_closure and old.kp.get("desc") is not None:
                    old.kp["desc_host"] = old.kp["desc"].cpu().numpy()
                old.feats = None
                old.kp["desc"] = None
        if scfg.loop_closure:
            detect_loop(kf)
        return kf

    def _archive_match(cur_desc, cur_mask):
        """ONE batched match of the given descriptors against ALL archived
        (retired) keyframes through the device-resident cache.  Shared by
        loop detection and relocalization.  Returns (cand, pairs, counts)
        or None."""
        cand = sorted(i for i, k in enumerate(keyframes) if k.kp.get("desc_host") is not None)
        if not cand:
            return None
        d0 = keyframes[cand[0]].kp["desc_host"]
        C = 1
        while C < len(cand):
            C *= 2  # capacity bucket: stable shapes
        # the candidate list only ever APPENDS (keyframes retire in order):
        # upload only the new rows, and the whole archive only when the
        # capacity grows
        if (C != arch_cache["C"]
                or tuple(cand[: len(arch_cache["cand"])]) != arch_cache["cand"]):
            arch_d = np.zeros((C,) + d0.shape, d0.dtype)
            arch_m = np.zeros((C, d0.shape[0]), bool)
            for s, i in enumerate(cand):
                arch_d[s] = keyframes[i].kp["desc_host"]
                arch_m[s] = np.asarray(keyframes[i].kp["mask"])
            (d_dev,) = _upload(dev, arch_d, dtype=torch.uint8)
            (m_dev,) = _upload(dev, arch_m, dtype=torch.bool)
        else:
            d_dev, m_dev = arch_cache["d"], arch_cache["m"]
            for s in range(len(arch_cache["cand"]), len(cand)):
                i = cand[s]
                (row,) = _upload(dev, keyframes[i].kp["desc_host"], dtype=torch.uint8)
                (mrow,) = _upload(dev, np.asarray(keyframes[i].kp["mask"]), dtype=torch.bool)
                d_dev[s].copy_(row)
                m_dev[s].copy_(mrow)
        arch_cache.update(cand=tuple(cand), C=C, d=d_dev, m=m_dev)
        (cur_m,) = _upload(dev, np.asarray(cur_mask), dtype=torch.bool)
        pairs_np, counts_np = _pull(*_loop_match_jit(d_dev, m_dev, cur_desc, cur_m, mcfg))
        return cand, pairs_np.astype(np.int64), counts_np[: len(cand)]

    def detect_loop(kf: Keyframe):
        """Revisit detection for the just-inserted keyframe: one batched
        match against every archived keyframe, a dual PnP of the best
        candidate's MAP points against both keyframes' observations, and a
        measured relative Sim(3) loop edge on success (see the reference for
        the rationale of each gate)."""
        t_start = time.perf_counter()
        n_new = len(keyframes) - 1
        am = _archive_match(kf.kp["desc"], kf.kp["mask"])

        def done():
            if timings is not None:
                timings.setdefault("loop", []).append((time.perf_counter() - t_start) * 1e3)

        if am is None:
            return done()
        cand, pairs_np, counts_np = am
        # eligibility gates (temporal separation) applied AFTER the match
        elig = [
            s for s, i in enumerate(cand)
            if n_new - i >= scfg.loop_kf_gap
            and kf.frame_idx - keyframes[i].frame_idx >= scfg.loop_min_frame_gap
        ]
        if not elig:
            return done()
        c = max(elig, key=lambda s: counts_np[s])
        if counts_np[c] < scfg.loop_min_matches:
            return done()
        old = keyframes[cand[c]]
        pr = pairs_np[c][: counts_np[c]]
        has3d = old.pt_ids[pr[:, 0]] >= 0
        p3 = pr[has3d]
        if len(p3) < scfg.loop_min_inliers:
            return done()
        slots = old.pt_ids[p3[:, 0]]
        # CURRENT map coordinates; relative pose from TWO PnP solves against
        # the SAME map points (point drift cancels), full-strength GN
        X = map_X[slots]
        it = max(scfg.pnp_iters, 10)
        uv_old = np.stack([old.kp["x"][p3[:, 0]], old.kp["y"][p3[:, 0]]], 1)
        uv_new = np.stack([kf.kp["x"][p3[:, 1]], kf.kp["y"][p3[:, 1]]], 1)
        pose_o, n_o, inl_o = solve_pnp(X, uv_old, old.pose, it)
        pose_n, n_n, inl_n = solve_pnp(X, uv_new, kf.pose, it)
        n_inl = min(n_o, n_n)
        # absolute floor AND majority-inlier gate
        if n_inl < scfg.loop_min_inliers or n_inl < 0.5 * len(p3):
            return done()
        # --- Sim(3) edge measurement: SE(3) part from the dual PnP, the
        # scale from the pairwise-distance ratio of the duplicated points
        new_ids = kf.pt_ids[p3[:, 1]]
        # only DUAL-PnP-INLIER matches feed the scale and the fusion
        inl_both = inl_o & inl_n
        both = (new_ids >= 0) & inl_both
        # ... and only MATURE new-side landmarks, in DISTINCT slots
        mature = map_anchor[np.maximum(new_ids, 0)] < (len(keyframes) - 1)
        both_m = both & mature & (old.pt_ids[p3[:, 0]] != new_ids)
        po_t, pn_t = _upload(dev, pose_o, pose_n)
        Ro, to = P.exp_se3(po_t)
        Rn, tn = P.exp_se3(pn_t)
        Rr, tr_ = P.relative(Ro, to, Rn, tn)
        Ro_m, to_m, w_rel, tr_np = _pull(Ro, to, P.log_so3(Rr), tr_)
        s_rel = 1.0
        if scfg.loop_sim3_scale and both_m.sum() >= 8:
            Xo = map_X[old.pt_ids[p3[both_m, 0]]]
            Xn = map_X[new_ids[both_m]]
            Rn_c, tn_c = rt(kf.pose)
            Y_old = Xo @ Ro_m.T + to_m      # in old cam, old-region scale
            Y_new = Xn @ Rn_c.T + tn_c      # in new cam, new-region scale
            ratios = []
            for sh in (1, 2, 3):
                d_o = np.linalg.norm(Y_old - np.roll(Y_old, sh, 0), axis=1)
                d_n = np.linalg.norm(Y_new - np.roll(Y_new, sh, 0), axis=1)
                okp = d_o > 1e-6
                ratios.append(d_n[okp] / d_o[okp])
            ratios = np.concatenate(ratios)
            if len(ratios) >= 8:
                s_m = float(np.median(ratios))
                q25, q75 = np.quantile(ratios, [0.25, 0.75])
                # consistency gate (tight ratio spread) + sanity clamp
                if q75 <= 1.35 * max(q25, 1e-9) and 0.5 <= s_m <= 2.0:
                    s_rel = s_m
        rel7 = np.zeros(7, np.float32)
        rel7[:3] = w_rel
        rel7[3:6] = s_rel * tr_np
        rel7[6] = np.log(s_rel)
        # duplicated-landmark correspondence the revisit match identified
        fo = old.pt_ids[p3[both, 0]]
        fn_ = new_ids[both]
        keep_f = fo != fn_
        fuse_pairs = np.stack([fo[keep_f], fn_[keep_f]], 1).astype(np.int64)
        loop_edges.append((cand[c], n_new, rel7, float(n_inl), fuse_pairs))
        metrics.event("loop_closure", kf_i=cand[c], kf_j=n_new,
                      matches=int(counts_np[c]), inliers=n_inl,
                      rel_scale=float(np.exp(rel7[6])))
        # ONLINE correction, only for strong edges whose measured loop
        # translation departs from the current estimate's relative by more
        # than loop_online_min_drift median recent keyframe steps
        Ri_c, ti_c = rt(old.pose)
        Rj_c, tj_c = rt(kf.pose)
        tr_cur = tj_c - (Rj_c @ Ri_c.T) @ ti_c
        disc = float(np.linalg.norm(rel7[3:6] - tr_cur))
        (lastp,) = _upload(dev, np.stack([k.pose for k in keyframes[-8:]]))
        Rl, tl = _pull(*P.exp_se3(lastp))
        ctrs = -np.einsum("mji,mj->mi", Rl, tl)
        steps = np.linalg.norm(np.diff(ctrs, axis=0), axis=1)
        step_med = float(np.median(steps)) if len(steps) else 0.0
        significant = disc > scfg.loop_online_min_drift * max(step_med, 1e-9)
        done()
        if (scfg.loop_online and significant
                and n_inl >= scfg.loop_online_min_inliers):
            free = max(scfg.loop_online_free_kfs, scfg.kf_window)
            with _stage(timings, "correction"):
                applied = apply_pose_graph_sim3(
                    keyframes, traj, map_X, map_mask, map_anchor, loop_edges,
                    optimizer=pg_fn, upto_frame=kf.frame_idx, fuse=scfg.loop_fuse,
                    odo_edges=[(a, b, r) for (a, b), r in odo_store.items()],
                    n_fix=max(1, len(keyframes) - free), device=dev,
                )
                if applied:
                    # the constant-velocity state is in the pre-correction frame
                    vel[:] = 0.0
                    refit_map_points(keyframes, map_X, map_mask, intr, device=dev)
            if applied:
                metrics.event("loop_correction", kf_j=n_new, n_kf=len(keyframes))

    def relocalize(kpt):
        """Re-register a LOST frame against the archived keyframes: one
        batched archive match, then PnP of the best candidates' map points
        SEEDED FROM THE CANDIDATE KEYFRAME'S POSE.  Returns (pose, keyframe,
        inliers) or None."""
        am = _archive_match(kpt["desc"], kpt["mask"])
        if am is None:
            return None
        cand, pairs_np, counts_np = am
        for c in np.argsort(counts_np)[::-1][:3]:
            if counts_np[c] < scfg.reloc_min_matches:
                break
            old = keyframes[cand[c]]
            pr = pairs_np[c][: counts_np[c]]
            has3d = old.pt_ids[pr[:, 0]] >= 0
            p3 = pr[has3d]
            if len(p3) < scfg.reloc_min_inliers:
                continue
            slots = old.pt_ids[p3[:, 0]]
            uv = np.stack([kpt["x"][p3[:, 1]], kpt["y"][p3[:, 1]]], 1)
            pose, n_inl, _ = solve_pnp(map_X[slots], uv, old.pose, max(scfg.pnp_iters, 10))
            # absolute floor AND majority gate, as for loop edges
            if n_inl >= scfg.reloc_min_inliers and n_inl >= 0.5 * len(p3):
                return pose, old, n_inl
        return None

    def _live_desc(k):
        if k.feats is not None:
            return k.feats.desc[0]
        (d,) = _upload(dev, k.kp["desc_host"], dtype=torch.uint8)
        return d

    def _live_mask(k):
        if k.feats is not None:
            return k.feats.mask[0]
        (m,) = _upload(dev, np.asarray(k.kp["mask"]), dtype=torch.bool)
        return m

    def track_loop(t0: int, last_pose: np.ndarray) -> int:
        """PnP tracking from frame t0 (constant-velocity twist model).

        Per frame: one extract + match against the live keyframes, then ONE
        copy of everything the bookkeeping needs.  Frame t+1's step is
        enqueued speculatively against the CURRENT keyframes after frame t's
        copy and before the host waits for it; the speculation is dropped
        (and t+1 re-dispatched) only when frame t changes the live set —
        outputs are those of the sequential loop."""
        nonlocal vel
        t = t0
        pending = None   # (frame, feats, _Pull) enqueued against kf_stack
        kf_stack = None  # (token, d_kf, m_kf) — rebuilt on live-set change
        reloc_pair = None  # [archived KF, last KF] after archive reloc
        lost = False

        def dispatch(ti, d_kf, m_kf):
            if features is None:
                ft, pairs_dev, counts_dev = _track_step_jit(frame_on_device(ti), d_kf, m_kf,
                                                            cfg, mcfg)
                return ti, ft, _Pull([pairs_dev, counts_dev, ft.x[0], ft.y[0], ft.mask[0]])
            ft = extract(ti)
            return ti, ft, _Pull(_match_kf_jit(d_kf, m_kf, ft.desc[0], ft.mask[0], mcfg))

        while t < T:
            t_start = time.perf_counter()
            # live matching set: the last two keyframes, or after an archive
            # relocalization the matched keyframe first
            live = (reloc_pair if reloc_pair is not None
                    else keyframes[-2:][::-1])   # [-1] first, then [-2]
            kf = live[0]
            token = (len(keyframes), id(kf))
            if kf_stack is None or kf_stack[0] != token:
                kf_stack = (
                    token,
                    torch.stack([_live_desc(k) for k in live]),
                    torch.stack([_live_mask(k) for k in live]),
                )
            _, d_kf, m_kf = kf_stack
            cur = pending if pending is not None and pending[0] == t else dispatch(t, d_kf, m_kf)
            pending = dispatch(t + 1, d_kf, m_kf) if t + 1 < T else None
            _, ft, pull = cur
            if features is None:
                pairs_np, counts_np, kx, ky, km = pull.wait()
                kpt = dict(x=kx, y=ky, desc=ft.desc[0], mask=km)
            else:
                pairs_np, counts_np = pull.wait()
                kpt = host_kp(t, ft)
            pairs_np = pairs_np.astype(np.int64)
            if timings is not None:
                timings.setdefault("track", []).append((time.perf_counter() - t_start) * 1e3)
            pairs = pairs_np[0][: counts_np[0]]
            # 2D-3D correspondences through the keyframe's map ids
            has_map = kf.pt_ids[pairs[:, 0]] >= 0 if len(pairs) else np.zeros(0, bool)
            p3d = pairs[has_map] if len(pairs) else pairs
            slots = kf.pt_ids[p3d[:, 0]] if len(p3d) else np.zeros(0, np.int64)
            kp_idx = p3d[:, 1] if len(p3d) else np.zeros(0, np.int64)
            # widen the 2D-3D set with the previous keyframe's map points
            if len(live) >= 2:
                kf2 = live[1]
                pairs2 = pairs_np[1][: counts_np[1]]
                if len(pairs2):
                    hm2 = kf2.pt_ids[pairs2[:, 0]] >= 0
                    p2 = pairs2[hm2]
                    new = ~np.isin(p2[:, 1], kp_idx)
                    slots = np.concatenate([slots, kf2.pt_ids[p2[new, 0]]])
                    kp_idx = np.concatenate([kp_idx, p2[new, 1]])
            pose_guess = last_pose + vel
            if len(slots) >= 6:
                uv = np.stack([kpt["x"][kp_idx], kpt["y"][kp_idx]], 1)
                with _stage(timings, "pnp"):
                    pose_t, n_inl, inl = solve_pnp(map_X[slots], uv, pose_guess,
                                                   scfg.pnp_iters)
            else:
                pose_t = pose_guess
                n_inl = 0
                inl = np.zeros(len(slots), bool)

            # --- tracking-loss state machine ---
            tracking_ok = len(slots) >= 6 and n_inl >= scfg.lost_min_inliers
            if scfg.track_lost and not tracking_ok:
                if not lost:
                    lost = True
                    # the velocity model is meaningless across a loss
                    vel[:] = 0.0
                    metrics.event("track_lost", frame=t, inliers=n_inl)
                rel = relocalize(kpt) if scfg.relocalize else None
                if rel is None:
                    # HOLD the last confident pose; no keyframe, no map
                    traj[t] = last_pose
                    tracked.append(0)
                    metrics.event("track", frame=t, inliers=0,
                                  matches=int(counts_np[0]), map_pts=map_n)
                    t += 1
                    continue
                pose_t, old_kf, n_inl = rel
                lost = False
                traj[t] = pose_t
                last_pose = pose_t
                tracked.append(n_inl)
                metrics.event("relocalized", frame=t, kf=int(old_kf.frame_idx), inliers=n_inl)
                if old_kf is not keyframes[-1]:
                    reloc_pair = [old_kf, keyframes[-1]]
                    pending = None  # speculation matched the stale live set
                t += 1
                continue
            if lost:
                # recovering through live-KF matching: compare with the
                # archive relocalizer and re-register on the STRONGER evidence
                rel = relocalize(kpt) if scfg.relocalize else None
                if rel is not None and rel[2] > n_inl:
                    pose_t, old_kf, n_inl = rel
                    lost = False
                    vel[:] = 0.0
                    traj[t] = pose_t
                    last_pose = pose_t
                    tracked.append(n_inl)
                    metrics.event("relocalized", frame=t, kf=int(old_kf.frame_idx),
                                  inliers=n_inl)
                    if old_kf is not keyframes[-1]:
                        reloc_pair = [old_kf, keyframes[-1]]
                        pending = None
                    # defer keyframe decisions to the next frame
                    t += 1
                    continue
                metrics.event("track_recovered", frame=t, inliers=n_inl)
                lost = False
                # (pose_t - last_pose) spans the whole loss gap
                vel[:] = 0.0
            else:
                vel = 0.5 * vel + 0.5 * (pose_t - last_pose)
            traj[t] = pose_t
            last_pose = pose_t
            tracked.append(n_inl)
            metrics.event("track", frame=t, inliers=n_inl,
                          matches=int(counts_np[0]), map_pts=map_n)

            flow = (
                np.median(np.hypot(
                    kpt["x"][pairs[:, 1]] - kf.kp["x"][pairs[:, 0]],
                    kpt["y"][pairs[:, 1]] - kf.kp["y"][pairs[:, 0]],
                )) if len(pairs) else np.inf
            )
            if n_inl < scfg.kf_min_inliers or flow > scfg.kf_flow_px:
                mapped = [(slots[i], kp_idx[i]) for i in np.nonzero(inl)[0]]
                mapped_kp = {int(k) for _, k in mapped}
                unmapped = pairs[~has_map] if len(pairs) else pairs
                if len(unmapped):
                    # don't re-triangulate keypoints already tied to the map
                    keep = ~np.isin(unmapped[:, 1], list(mapped_kp) or [-1])
                    unmapped = unmapped[keep]
                add_keyframe(t, ft, kpt, pose_t, mapped_pairs=mapped,
                             prev_kf=kf, tri_pairs=unmapped)
                pending = None  # speculative t+1 matched stale keyframes
                reloc_pair = None  # back to the natural last-two live set
                metrics.event("keyframe", frame=t, n_kf=len(keyframes), map_pts=map_n)
                with _stage(timings, "ba"):
                    windowed_ba()
                last_pose = keyframes[-1].pose
                if checkpoint_path is not None:
                    from . import checkpoint as _ckpt

                    # only process 0 owns the snapshot file
                    with _stage(timings, "checkpoint"):
                        if metrics_mod.host_index() == 0:
                            _ckpt.save_slam_state(
                                checkpoint_path, _result(t), next_frame=t + 1,
                                keyframes=keyframes, kf_window=scfg.kf_window,
                            )
                    metrics.event("checkpoint", frame=t)
            t += 1
        return t

    def _result(_t) -> SlamResult:
        return SlamResult(
            trajectory=traj,
            keyframe_indices=[k.frame_idx for k in keyframes],
            map_points=map_X, map_mask=map_mask,
            num_tracked=tracked, keyframes=keyframes,
            vel=vel.copy(), loop_edges=list(loop_edges),
            map_anchor=map_anchor, map_n=map_n,
            odo_edges=[(a, b, r) for (a, b), r in sorted(odo_store.items())],
        )

    if resume is not None:
        # restore map + trajectory prefix + the full windowed-BA keyframe
        # context (+ tracker velocity), skip bootstrap.  Legacy
        # (single-keyframe) checkpoints restore a reduced window.
        d = resume.data
        n0 = int(d["next_frame"])
        traj[: len(d["trajectory"])] = d["trajectory"][:T]
        for v in d["num_tracked"][:n0]:
            tracked.append(int(v))
        map_X[:] = d["map_points"]
        map_mask[:] = d["map_mask"]
        # allocation high-water mark (fusion frees slots BELOW it)
        if "map_n" in d:
            map_n = int(d["map_n"])
        else:
            used = np.nonzero(map_mask)[0]
            map_n = int(used[-1]) + 1 if len(used) else 0
        if "map_anchor" in d:
            map_anchor[: len(d["map_anchor"])] = d["map_anchor"]
        if "vel" in d:
            vel = np.asarray(d["vel"], np.float32).copy()
        if "loop_i" in d:
            f_off = d.get("loop_fuse_off")
            f_cat = d.get("loop_fuse_pairs")
            for n_, (i_, j_, r_, w_) in enumerate(zip(
                d["loop_i"], d["loop_j"], d["loop_rel"], d["loop_w"]
            )):
                fp = (
                    np.asarray(f_cat[f_off[n_]: f_off[n_ + 1]], np.int64)
                    if f_off is not None else np.zeros((0, 2), np.int64)
                )
                loop_edges.append((int(i_), int(j_), np.asarray(r_), float(w_), fp))
        if "odo_i" in d:
            for a_, b_, r_ in zip(d["odo_i"], d["odo_j"], d["odo_rel"]):
                odo_store[(int(a_), int(b_))] = np.asarray(r_, np.float32)

        if "kfw_frame_idx" in d:
            win_idx = [int(i) for i in d["kfw_frame_idx"]]
            # retired keyframes (older than the window): stubs carrying
            # identity + pose; the archive below re-attaches their host
            # descriptors/keypoints
            for fi in [int(i) for i in d["keyframe_indices"]]:
                if fi not in win_idx:
                    keyframes.append(Keyframe(
                        frame_idx=fi, pose=traj[fi].copy(), feats=None,
                        kp=dict(desc=None), pt_ids=np.zeros(0, np.int64),
                    ))
            n_desc = int(d.get("kfw_n_desc", 2))
            nw = len(win_idx)
            for i, fi in enumerate(win_idx):
                di = i - (nw - n_desc)   # index into kfw_desc for live KFs
                desc = None
                feats_shim = None
                if di >= 0:
                    (desc,) = _upload(dev, d["kfw_desc"][di], dtype=torch.uint8)
                    (mask_t,) = _upload(dev, d["kfw_mask"][i], dtype=torch.bool)
                    feats_shim = types.SimpleNamespace(desc=desc[None], mask=mask_t[None])
                keyframes.append(Keyframe(
                    frame_idx=fi, pose=d["kfw_pose"][i].copy(), feats=feats_shim,
                    kp=dict(x=d["kfw_x"][i], y=d["kfw_y"][i], desc=desc, mask=d["kfw_mask"][i]),
                    pt_ids=d["kfw_pt_ids"][i].copy(),
                ))
            if "arch_pos" in d:
                for s, pos in enumerate(int(i) for i in d["arch_pos"]):
                    k = keyframes[pos]
                    k.kp["desc_host"] = d["arch_desc"][s]
                    k.kp["mask"] = d["arch_mask"][s]
                    k.kp["x"] = d["arch_x"][s]
                    k.kp["y"] = d["arch_y"][s]
                    if k.pt_ids.size == 0:
                        k.pt_ids = d["arch_pt_ids"][s].copy()
        else:  # legacy single-keyframe checkpoint
            (desc,) = _upload(dev, d["kf_desc"], dtype=torch.uint8)
            (mask_t,) = _upload(dev, d["kf_mask"], dtype=torch.bool)
            keyframes.append(Keyframe(
                frame_idx=int(d["kf_frame_idx"]), pose=d["kf_pose"].copy(),
                feats=types.SimpleNamespace(desc=desc[None], mask=mask_t[None]),
                kp=dict(x=d["kf_x"], y=d["kf_y"], desc=desc, mask=d["kf_mask"]),
                pt_ids=d["kf_pt_ids"].copy(),
            ))
        if "map_anchor" not in d:
            # legacy checkpoint: anchor each landmark to its EARLIEST
            # restored observer, masked orphans to the chain origin
            for i_k, k in enumerate(keyframes):
                if k.pt_ids.size:
                    ids = k.pt_ids[k.pt_ids >= 0]
                    unset = ids[map_anchor[ids] < 0]
                    map_anchor[unset] = i_k
            map_anchor[map_mask & (map_anchor < 0)] = 0
        return _result(track_loop(n0, traj[n0 - 1].copy()))

    # ---------------- bootstrap ----------------
    f0 = extract(0)
    kp0 = host_kp(0, f0)
    traj[0] = 0.0
    kf0 = add_keyframe(0, f0, kp0, np.zeros(6, np.float32))
    tracked.append(int(kp0["mask"].sum()))

    boot_done = False
    t = 1
    last_pose = np.zeros(6, np.float32)
    buffered = []   # pre-bootstrap frames, re-localized once the map exists
    while t < T and not boot_done:
        ft = extract(t)
        kpt = host_kp(t, ft)
        pairs = match(f0, ft)
        metrics.event("bootstrap", frame=t, matches=len(pairs))
        if len(pairs) < 16:
            traj[t] = last_pose
            tracked.append(0)
            buffered.append((t, ft, kpt))
            t += 1
            continue
        flow = np.hypot(
            kpt["x"][pairs[:, 1]] - kp0["x"][pairs[:, 0]],
            kpt["y"][pairs[:, 1]] - kp0["y"][pairs[:, 0]],
        )
        if np.median(flow) < scfg.init_flow_px:
            traj[t] = last_pose
            tracked.append(len(pairs))
            buffered.append((t, ft, kpt))
            t += 1
            continue
        # two-view initialization: 256-hypothesis RANSAC for E, then pose
        x0n, _ = normalized(kp0, pairs[:, 0])
        x1n, _ = normalized(kpt, pairs[:, 1])
        f_mean = float(fxy.mean())
        x0t, x1t = _upload(dev, x0n, x1n)
        valid = torch.ones(len(pairs), dtype=torch.bool, device=dev)
        # eager: N changes with the bootstrap frame (ROADMAP section 1 item 6)
        draws = epipolar.sample_minimal_sets(valid, 256, generator)
        rr = epipolar.ransac_from_samples(x0t, x1t, valid, draws,
                                          threshold=(2.0 / f_mean) ** 2)
        tv = P.recover_pose(rr.E, x0t, x1t, rr.inliers)
        pose_t, num_good = _pull(P.log_se3(tv.R, tv.t), tv.num_good)
        pose_t = np.asarray(pose_t, np.float32)
        traj[t] = pose_t
        last_pose = pose_t
        add_keyframe(t, ft, kpt, pose_t, prev_kf=kf0, tri_pairs=pairs)
        tracked.append(int(num_good))
        with _stage(timings, "ba"):
            windowed_ba()
        last_pose = keyframes[-1].pose
        boot_done = True
        t += 1

        # retroactively localize buffered pre-bootstrap frames with PnP
        # against the fresh map (through keyframe 0's keypoint->map ids)
        for (tb, fb, kpb) in buffered:
            bp = match(kf0.feats, fb)
            if not len(bp):
                continue
            hm = kf0.pt_ids[bp[:, 0]] >= 0
            b3 = bp[hm]
            if len(b3) < 6:
                continue
            slots = kf0.pt_ids[b3[:, 0]]
            uv = np.stack([kpb["x"][b3[:, 1]], kpb["y"][b3[:, 1]]], 1)
            pose_b, n_b, _ = solve_pnp(map_X[slots], uv, np.zeros(6, np.float32),
                                       scfg.pnp_iters)
            traj[tb] = pose_b
            tracked[tb] = n_b
        buffered.clear()

    # ---------------- tracking ----------------
    return _result(track_loop(t, last_pose))
