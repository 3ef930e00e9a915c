"""Rank targets of the port's multi-rank CPU tests (`comm.spawn`, gloo).

A spawned rank imports the module of its target, so this module imports
neither JAX nor the reference.  Each target takes host arrays (NumPy) and
returns host arrays; `group` and `device` come from `comm.spawn`.  The
tiny SLAM scene is tests/test_multiprocess.py:24-47's (T = 8, 96x128, K =
256), built with the port's fixtures.
"""

import os
import time

import numpy as np
import torch

from siftgpu_tpu_torch.core import graphs
from siftgpu_tpu_torch.core.config import MatchConfig, SiftConfig
from siftgpu_tpu_torch.optim import ba
from siftgpu_tpu_torch.optim import pose_graph as pg
from siftgpu_tpu_torch.parallel import (comm, dist_ba, dist_pose_graph, dp, resident_ba, sequence,
                                        spatial)
from siftgpu_tpu_torch.pipeline import metrics, slam
from siftgpu_tpu_torch.pipeline.slam import _pull

from chip_smoke import resident_solve  # noqa: F401 (a rank target)

SCENE_T, SCENE_H, SCENE_W = 8, 96, 128
SCENE_INTR = (110.0, 110.0, SCENE_W / 2.0, SCENE_H / 2.0)
SCENE_SCFG = dict(kf_min_inliers=40, kf_flow_px=4.0, init_flow_px=5.0, ba_iters=2, ba_cg=8,
                  loop_min_frame_gap=3)


def scene(T=SCENE_T):
    """(frames, gt, intr, cfg, mcfg, scfg) of the tiny config-5 scene."""
    from siftgpu_tpu_torch.oracle import fixtures

    frames, gt = fixtures.two_plane_sequence(
        T, SCENE_H, SCENE_W, SCENE_INTR, rvec_step=np.array([0.002, -0.004, 0.001]),
        t_step=np.array([-0.12, 0.012, 0.006]), d_near=5.0, d_far=10.0, seed=4)
    return (frames, gt, SCENE_INTR, SiftConfig(height=SCENE_H, width=SCENE_W, max_keypoints=256),
            MatchConfig(max_match=256), slam.SlamConfig(**SCENE_SCFG))


def _np(t):
    return t.detach().cpu().numpy()


def fail_on_rank(bad, *, group, device):
    """Rank `bad` raises; the others return."""
    if comm.rank(group) == bad:
        raise RuntimeError(f"rank {bad} failed")


def abort_on_rank(bad, collective, *, group, device):
    """Rank `bad` aborts its process (SIGABRT, as a C++ `std::terminate`
    does); the others return, or, with `collective`, wait for it in a
    sum-all-reduce that it never joins."""
    if comm.rank(group) == bad:
        if collective:
            time.sleep(1.0)        # its peers are in the all-reduce by then
        os.abort()
    if collective:
        comm.all_reduce_sum(torch.ones(1, device=device), group)


def run_ba_distributed(sprob, iters, n_cg, *, group, device):
    """(cameras, every rank's points [S, Ps, 3], cost)."""
    state, cost = dist_ba.run_ba_distributed(sprob, group, iters=iters, n_cg=n_cg, device=device)
    return _np(state.cams), _np(dist_ba.gather_points(state.points, group)), float(cost)


PG_OPTIMIZERS = {
    "se3": (pg.PoseGraph, dist_pose_graph.optimize_pose_graph_distributed),
    "sim3": (pg.Sim3PoseGraph, dist_pose_graph.optimize_pose_graph_sim3_distributed),
    "sim3_cg": (pg.Sim3PoseGraph, dist_pose_graph.optimize_pose_graph_sim3_cg_distributed),
}


def optimize_pose_graphs(graphs, iters, *, group, device):
    """{kind: (poses, costs)} of the distributed optimizer of each kind on
    its graph (NumPy fields)."""
    out = {}
    for kind, arrays in graphs.items():
        cls, opt = PG_OPTIMIZERS[kind]
        g = cls(*(torch.from_numpy(np.asarray(a)).to(device) for a in arrays))
        res, costs = opt(g, group, iters=iters)
        out[kind] = (_np(res.poses), _np(costs))
    return out


def extract_features_dp(images, cfg, jit=False, *, group, device):
    """Every rank's gathered Features (of `extract_features_dp_jit` if
    `jit`), as NumPy fields."""
    extract = dp.extract_features_dp_jit if jit else dp.extract_features_dp
    f = dp.gather_features(extract(images, cfg, group, device), group)
    return [_np(a) for a in f]


def extract_sequence_dps(frames, cfg, chunk, *, group, device):
    """The sequence store with the descriptors on the device, then on the
    host (`desc_hbm_budget=0`): each as (host mode, desc, x, y, mask)."""
    out = []
    for budget in (1 << 30, 0):
        seq = sequence.extract_sequence_dp(frames, cfg, group, device, chunk=chunk,
                                           desc_hbm_budget=budget)
        host = isinstance(seq.desc, np.ndarray)
        out.append((host, seq.desc if host else _np(seq.desc), seq.x, seq.y, seq.mask))
    return out


def _summary(res):
    return dict(trajectory=res.trajectory, keyframe_indices=list(res.keyframe_indices),
                map_points=res.map_points, map_mask=res.map_mask,
                num_tracked=list(res.num_tracked),
                loop_edges=[(int(e[0]), int(e[1])) for e in res.loop_edges])


def run_slam_variants(kws, metrics_path, *, group, device):
    """`run_slam_distributed` on the tiny scene once per options dict of
    `kws`; the first run writes its metrics to `metrics_path`."""
    frames, _, intr, cfg, mcfg, scfg = scene()
    out = []
    for i, kw in enumerate(kws):
        with metrics.MetricsLogger(metrics_path if i == 0 else None) as m:
            res = sequence.run_slam_distributed(frames, intr, cfg, mcfg, scfg, group, device,
                                                metrics=m, **kw)
        out.append(_summary(res))
    return out


class _Features:
    """Pre-extracted features in `run_slam`'s duck type, on the CPU."""

    def __init__(self, arrays):
        from siftgpu_tpu_torch import Features

        self.t = Features(*(torch.from_numpy(np.array(a)) for a in arrays))
        self.x, self.y, self.mask = (np.asarray(arrays[i]) for i in (0, 1, 7))

    def frame_feats(self, t):
        return type(self.t)(*(a[t:t + 1] for a in self.t))


def reference_draws(mask, num_hypotheses, generator):
    """The reference's bootstrap RANSAC draws (`jax.random.choice` with
    `PRNGKey(0)` on the same mask), as tests/test_torch_slam.py builds
    them; JAX is imported here, in the rank, only when called."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    m = mask.cpu().numpy()
    p = jnp.asarray(m, jnp.float32)
    p = p / jnp.maximum(p.sum(), 1e-9)
    idx = jax.random.choice(jax.random.PRNGKey(0), len(m), shape=(num_hypotheses, 8), p=p)
    return torch.from_numpy(np.array(idx)).to(torch.int64)


def run_slam_resident(feature_arrays, frames, intr, cfg, mcfg, scfg, *, group, device):
    """The port's `run_slam` on given features with `ResidentBA(group)` and
    `make_pg_optimizer(group)`, on the reference's bootstrap draws."""
    from siftgpu_tpu_torch.geometry import epipolar

    epipolar.sample_minimal_sets = reference_draws
    res = slam.run_slam(frames, intr, cfg, mcfg, scfg, features=_Features(feature_arrays),
                        ba_fn=resident_ba.ResidentBA(group, device),
                        pg_fn=sequence.make_pg_optimizer(group), device=device)
    out = _summary(res)
    out.update(map_n=res.map_n, map_anchor=res.map_anchor)
    return out


def spatial_cases(halo_cases, extract_cases, *, group, device):
    """`comm.exchange_halo` of this rank's row slab of each (frames [B, H, W],
    h) of `halo_cases`, as it comes and after `spatial._reclamp`; then
    `extract_features_spatial` of each (images, cfg, options) of
    `extract_cases`: (its NumPy fields, its per-octave stats), or the text
    of the ValueError it raised."""
    n, r = comm.world_size(group), comm.rank(group)
    halos = []
    for frames, h in halo_cases:
        rows = frames.shape[1] // n
        x = torch.from_numpy(np.ascontiguousarray(frames[:, r * rows:(r + 1) * rows])).to(device)
        p = comm.exchange_halo(x, h, group)
        halos.append((_np(p), _np(spatial._reclamp(p, h, r, n))))
    feats = []
    for images, cfg, kw in extract_cases:
        stats = []
        try:
            f = spatial.extract_features_spatial(images, cfg, group, device, stats=stats, **kw)
        except ValueError as e:
            feats.append(str(e))
            continue
        feats.append(([_np(a) for a in f], stats))
    return halos, feats


class PreSplitResidentBA(resident_ba.ResidentBA):
    """`ResidentBA` as it was before its device work became the three
    programs `_scatter`, `_solve`, `_gather`: an in-place upload, `run_ba`
    and the gather inline (the old methods, verbatim)."""

    def _upload_dirty(self, map_X):
        diff = np.nonzero((map_X != self.mirror).any(axis=1))[0]
        if len(diff) == 0:
            return 0
        cap = resident_ba._pow2(len(diff))
        idx = np.full(cap, self.Ps, np.int64)       # the sink row
        vals = np.zeros((cap, 3), np.float32)
        own = diff // self.Ps == self.rank
        idx[: len(diff)][own] = diff[own] - self.rank * self.Ps
        vals[: len(diff)] = map_X[diff]
        self.pts.index_copy_(0, self._t(idx, torch.int64), self._t(vals))
        self.mirror[diff] = map_X[diff]
        return len(diff)

    def solve(self, cams, obs_c, obs_p, obs_uv, pt_fixed_host, map_X, iters, n_cg):
        self._ensure(map_X)
        self._upload_dirty(map_X)
        obs_c = np.asarray(obs_c, np.int32)
        obs_p = np.asarray(obs_p, np.int64)
        obs_uv = np.asarray(obs_uv, np.float32)
        owner = obs_p // self.Ps
        counts = np.bincount(owner, minlength=self.n)
        Ns = resident_ba._pow2(int(counts.max()) if len(counts) else 1)
        sel = np.nonzero(owner == self.rank)[0]
        k = len(sel)
        cam_s = np.zeros(Ns, np.int32)
        pt_s = np.zeros(Ns, np.int32)
        uv_s = np.zeros((Ns, 2), np.float32)
        w_s = np.zeros(Ns, np.float32)
        cam_s[:k] = obs_c[sel]
        pt_s[:k] = obs_p[sel] - self.rank * self.Ps
        uv_s[:k] = obs_uv[sel]
        w_s[:k] = 1.0
        M = map_X.shape[0]
        fx = np.zeros(self.n * self.Ps, bool)
        fx[:M] = pt_fixed_host
        fx_s = fx[self.rank * self.Ps:(self.rank + 1) * self.Ps]
        prob = ba.BAProblem(
            cams=self._t(np.asarray(cams, np.float32)), points=self.pts[: self.Ps],
            intrinsics=self._intr, cam_idx=self._t(cam_s, torch.int32),
            pt_idx=self._t(pt_s, torch.int32), uv=self._t(uv_s), w=self._t(w_s),
            pt_fixed=self._t(fx_s, torch.bool))
        st = ba.run_ba(prob, iters=iters, n_cg=n_cg, fix_first_cam=True, group=self.group)
        self.pts[: self.Ps] = st.points
        touched = np.unique(obs_p[~pt_fixed_host[obs_p]])
        if not len(touched):
            new_cams, cost = _pull(st.cams, st.cost)
            return np.array(new_cams), float(cost)
        capg = resident_ba._pow2(len(touched))
        gidx = np.full(capg, touched[0], np.int64)
        gidx[: len(touched)] = touched
        g_owner = gidx // self.Ps
        local = np.where(g_owner == self.rank, gidx - self.rank * self.Ps, self.Ps)
        rows = comm.all_gather_rows(self.pts[self._t(local, torch.int64)], self.group)
        vals = rows.view(self.n, capg, 3)[self._t(g_owner, torch.int64),
                                          torch.arange(capg, device=self.device)]
        new_cams, cost, vals = _pull(st.cams, st.cost, vals)
        map_X[touched] = vals[: len(touched)]
        self.mirror[touched] = vals[: len(touched)]
        return np.array(new_cams), float(cost)


def resident_programs(window, edits, *, group, device):
    """`chip_smoke.resident_solve` in this rank through `PreSplitResidentBA`,
    `ResidentBA` and `ResidentBAJit` ({"pre_split", "eager", "jit"}: its
    result and the collectives the run counted, `graphs.COLLECTIVES`), the
    eager run's collectives counted once more inside a capture's tally
    ("tallied": (the tally, `COLLECTIVES` unchanged)), and what
    `graphs.check_backends` does with this rank's group ("backends": the
    ValueError's text, or None where it passed, for each case)."""
    def counted(jit):
        graphs.COLLECTIVES.update(all_reduce=0, all_gather=0)
        res = resident_solve(window, edits, jit, group=group, device=device)
        return res, dict(graphs.COLLECTIVES)

    out = {"eager": counted(False), "jit": counted(True)}
    cls, resident_ba.ResidentBA = resident_ba.ResidentBA, PreSplitResidentBA
    try:
        out["pre_split"] = counted(False)
    finally:
        resident_ba.ResidentBA = cls
    before = dict(graphs.COLLECTIVES)
    with graphs._tally_collectives() as tally:
        resident_solve(window, edits, group=group, device=device)
    out["tallied"] = (tally, graphs.COLLECTIVES == before)

    def refusal(device_, arguments=(group,)):
        try:
            graphs.check_backends("_solve_jit", arguments, device_)
        except ValueError as e:
            return str(e)
        return None

    cases = {"cuda": refusal("cuda"), "cuda:0 nested": refusal(torch.device("cuda", 0),
                                                                ((1, [group]),)),
             "cpu": refusal("cpu"), "no group": refusal("cuda", (None, 3))}
    get_backend = torch.distributed.get_backend
    torch.distributed.get_backend = lambda g=None: "nccl"
    try:
        cases["nccl"] = refusal("cuda")
    finally:
        torch.distributed.get_backend = get_backend
    out["backends"] = cases
    return out
