"""The SLAM loop's online loop correction against the reference, on the CPU
at the size of the reference's own fixture.

tests/test_loop_closure.py's `_loop_scene` (144x192, K = 384, noise 0.05,
its deliberately weak SlamConfig: `chip_smoke.weak_slam_config`), both
loops on the reference's features of the scene and its bootstrap RANSAC
draws, as in tests/test_torch_slam.py's back-end parity:

- Live, over the scene's first PREFIX frames, up to and including the
  frame of the reference's first `loop_correction`: the reference's
  `run_slam` and the port's.  Keyframes, loop edges, each loop closure's
  inliers and the corrections (frame and keyframe) equal; PnP inliers
  within 2 a frame.  The correction rewrites every earlier pose, so the
  poses before it are read from the runs one frame shorter: before the
  first loop closure within 1e-4 (rotations) and 2e-3 (centers after the
  similarity that best maps the port's onto the reference's: BA's free
  scale gauge, see that file).  From the first loop closure on, the loop
  fuses map points, and a slot that one side triangulates and the other
  does not changes the fused sets: there the corrected poses are held
  within 3x the reference's own spread when every pixel of the scene
  moves one f32 ulp (a further reference run, live).
- The whole scene, three ways through the port as tests/test_loop_closure
  .py runs the reference: online (with the end-of-run Sim(3) pose graph),
  end-only (`loop_online=False`, then the pose graph) and plain
  (`loop_online=False, loop_fuse=False`).  The runs' keyframe and loop-edge
  counts equal the reference's (`chip_smoke.ONLINE_REF`, from
  `slam_reference.py --online`), that test's assertions hold (a
  `loop_correction` event, detection not starved, ATE online < 0.7 x plain
  and < 1.4 x end-only) and phase 4d's bound: ATE within max(1.5 x the
  reference's, 2% of the span).

On its own extraction the port's CPU run misses two of those ratios at
the tests' noise seed, and a one-ulp change of the pixels flips them in
either package (`PERF.md`, PR 11): `chip_smoke.py` holds the port's own
extraction on the card over several noise seeds (phase 4d's online step),
and the two-loop fixture's measure (tests/loop_value_worker.py) runs
there only, for its cost."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend.extract import extract_features_jit
from siftgpu_tpu.oracle import fixtures as jfixtures
from siftgpu_tpu.pipeline import metrics as jmetrics
from siftgpu_tpu.pipeline import slam as jslam
from siftgpu_tpu_torch import MatchConfig, SiftConfig
from siftgpu_tpu_torch.geometry import align
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import metrics, slam

from test_torch_slam import PortFeatures, RefFeatures, draws_patch  # noqa: F401 (a fixture)
from torch_threads import one_thread  # noqa: F401 (autouse)

SIZE = (144, 192, 384)
PREFIX = 17     # frames 0-16: the reference's first loop_correction comes at frame 16


def _reference_features(frames):
    h, w, k = SIZE
    feats = extract_features_jit(jnp.asarray(frames), JConfig(height=h, width=w, max_keypoints=k))
    return PortFeatures(feats)


def test_online_correction_meets_reference_assertions(tmp_path, draws_patch):
    pkg = type("Port", (), dict(SiftConfig=SiftConfig, MatchConfig=MatchConfig, slam=slam,
                                align=align, fixtures=fixtures, metrics=metrics))
    with draws_patch():
        got = cs.online_correction_runs(pkg, *SIZE, str(tmp_path), scenes=("loop",),
                                        features=_reference_features, device="cpu")
    ref = cs.ONLINE_REF[SIZE]["seeds"][11]
    for run in ("online", "endonly", "plain"):
        # the same revisits are measured as in the reference's runs
        assert len(got[run]["loop_edges"]) == ref[run]["loop_edges"], run
        assert len(got[run]["keyframes"]) == ref[run]["keyframes"], run
        assert np.isfinite(got[run]["ate"])
    cs.check_online_correction({11: got}, {11: ref})


def _corrections(path):
    """(frame, keyframe) of each loop_correction in a metrics stream: the
    frame is the last one tracked before it."""
    frame, out = None, []
    for line in open(path):
        e = json.loads(line)
        if e["event"] == "track":
            frame = e["frame"]
        elif e["event"] == "loop_correction":
            out.append((frame, e["kf_j"]))
    return out


def _closures(path):
    return [(e["kf_i"], e["kf_j"], e["inliers"]) for e in map(json.loads, open(path))
            if e["event"] == "loop_closure"]


def _pose_diff(a, b, rows=slice(None)):
    """Largest rotation difference and largest center distance after the
    similarity that best maps a's centers onto b's, over `rows`."""
    ca, cb = align.camera_centers(a[rows]), align.camera_centers(b[rows])
    s, R, t = align.umeyama(ca, cb)
    return (float(np.abs(a[rows, :3] - b[rows, :3]).max()),
            float(np.linalg.norm((s * (R @ ca.T)).T + t - cb, axis=1).max()))


def test_online_prefix_matches_reference_live(tmp_path, draws_patch):
    h, w, k = SIZE
    cfg, mcfg = JConfig(height=h, width=w, max_keypoints=k), JMatch(max_match=k)
    scene = {n: cs.slam_loop_scene(jfixtures, h, w, nudge=n) for n in (0, 1)}
    feats = {n: extract_features_jit(jnp.asarray(scene[n][0][:PREFIX]), cfg) for n in (0, 1)}
    intr = scene[0][2]

    def reference(T, nudge=0):
        path = str(tmp_path / f"ref{T}_{nudge}.jsonl")
        with jmetrics.MetricsLogger(path) as m:
            res = jslam.run_slam(scene[nudge][0][:T], intr, cfg, mcfg,
                                 cs.weak_slam_config(jslam), features=RefFeatures(feats[nudge]),
                                 metrics=m)
        return res, path

    def port(T):
        path = str(tmp_path / f"port{T}.jsonl")
        with draws_patch(), metrics.MetricsLogger(path) as m:
            res = slam.run_slam(scene[0][0][:T], intr, SiftConfig(height=h, width=w,
                                                                  max_keypoints=k),
                                MatchConfig(max_match=k), cs.weak_slam_config(slam),
                                features=PortFeatures(feats[0]), metrics=m, device="cpu")
        return res, path

    (ref, rp), (got, pp) = reference(PREFIX), port(PREFIX)
    assert got.keyframe_indices == ref.keyframe_indices
    assert [e[:2] for e in got.loop_edges] == [e[:2] for e in ref.loop_edges]
    assert _closures(pp) == _closures(rp)
    corr = _corrections(rp)
    assert corr and corr[0][0] == PREFIX - 1, corr     # the prefix ends at the first
    assert _corrections(pp) == corr
    n_ref, n_port = np.asarray(ref.num_tracked), np.asarray(got.num_tracked)
    assert np.abs(n_ref - n_port).max() <= 2, (n_ref, n_port)

    # the correction rewrites every earlier pose: the state before it is
    # the run one frame shorter
    before, after = reference(PREFIX - 1)[0], port(PREFIX - 1)[0]
    first_loop = ref.keyframe_indices[ref.loop_edges[0][1]]
    rot, ctr = _pose_diff(after.trajectory, before.trajectory, slice(0, first_loop))
    assert rot < 1e-4 and ctr < 2e-3, (first_loop, rot, ctr)
    rot, ctr = _pose_diff(got.trajectory, ref.trajectory)
    rot_ulp, ctr_ulp = _pose_diff(reference(PREFIX, nudge=1)[0].trajectory, ref.trajectory)
    assert rot <= 3 * rot_ulp and ctr <= 3 * ctr_ulp, (rot, rot_ulp, ctr, ctr_ulp)


def test_reference_bootstrap_at_480x640_rests_on_rounding():
    """Where the packages part at 480x640 (phase 4d's online step: the
    reference's bootstrap keeps 2 points in front of both cameras, the
    port's hundreds; `ONLINE_REF`): the bootstrap's essential-matrix
    RANSAC on identical inputs (the reference's features of frames 0 and
    the bootstrap frame, their matches in normalized coordinates) and
    identical minimal sets (the reference's draws).  The reference's
    refined E keeps at most 20 inliers on these exact inputs and more than
    20 when every coordinate moves one f32 ulp either way; the port's keeps
    more than 20 on all three."""
    from siftgpu_tpu.geometry import epipolar as jepipolar
    from siftgpu_tpu_torch import match_descriptors
    from siftgpu_tpu_torch.geometry import epipolar

    from test_torch_slam import reference_draws

    h, w, k = 480, 640, 2048
    ref = cs.ONLINE_REF[(h, w, k)]["seeds"][11]
    assert ref["num_tracked"][ref["boot"]] <= 20       # the reference's own run
    frames, _, intr = cs.slam_loop_scene(jfixtures, h, w)
    feats = PortFeatures(extract_features_jit(jnp.asarray(frames[[0, ref["boot"]]]),
                                              JConfig(height=h, width=w, max_keypoints=k)))
    f = feats.t
    res = match_descriptors(f.desc[0], f.desc[1], f.mask[0], f.mask[1], MatchConfig(max_match=k))
    pairs = res.pairs[: int(res.count)].numpy()
    fxy, cxy = np.asarray(intr[:2]), np.asarray(intr[2:])
    x0, x1 = ((np.stack([feats.x[i][pairs[:, i]], feats.y[i][pairs[:, i]]], 1) - cxy) / fxy
              for i in (0, 1))
    threshold = (2.0 / float(fxy.mean())) ** 2
    valid = torch.ones(len(pairs), dtype=torch.bool)
    draws = reference_draws(valid, 256, None)
    got = {}
    for nudge in (0, 1, -1):
        a, b = (np.nextafter(x.astype(np.float32), np.float32(nudge * np.inf)) if nudge
                else x.astype(np.float32) for x in (x0, x1))
        r = jepipolar.ransac_essential(jnp.asarray(a), jnp.asarray(b), jnp.ones(len(a), bool),
                                       jax.random.PRNGKey(0), num_hypotheses=256,
                                       threshold=threshold)
        p = epipolar.ransac_from_samples(torch.from_numpy(a), torch.from_numpy(b), valid, draws,
                                         threshold=threshold)
        got[nudge] = (int(r.num_inliers), int(p.num_inliers))
    assert got[0][0] <= 20 < min(got[1][0], got[-1][0]), got
    assert min(p for _, p in got.values()) > 20, got
