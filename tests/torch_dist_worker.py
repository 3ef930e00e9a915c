"""Rank targets of the port's multi-rank CPU tests (`comm.spawn`, gloo).

A spawned rank imports the module of its target, so this module imports
neither JAX nor the reference.  Each target takes host arrays (NumPy) and
returns host arrays; `group` and `device` come from `comm.spawn`.  The
tiny SLAM scene is tests/test_multiprocess.py:24-47's (T = 8, 96x128, K =
256), built with the port's fixtures.
"""

import numpy as np
import torch

from siftgpu_tpu_torch.core.config import MatchConfig, SiftConfig
from siftgpu_tpu_torch.optim import pose_graph as pg
from siftgpu_tpu_torch.parallel import (comm, dist_ba, dist_pose_graph, dp, resident_ba, sequence,
                                        spatial)
from siftgpu_tpu_torch.pipeline import metrics, slam

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


def extract_features_dp(images, cfg, *, group, device):
    """Every rank's gathered Features, as NumPy fields."""
    f = dp.gather_features(dp.extract_features_dp(images, cfg, group, device), group)
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
