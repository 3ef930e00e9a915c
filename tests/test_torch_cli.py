"""The port's command line (`python -m siftgpu_tpu_torch ...`) against the
reference's, with `--cpu`:

  - `_split_flags`: the reference's split of every flag list of
    tests/test_torch_api.py and tests/test_viz.py;
  - `extract`: the `.sift` file within the facade budgets of
    tests/test_torch_api.py against the reference CLI's; the `--npz` store
    has the reference's keys, dtypes and shapes;
  - `match --viz`: the PPM is the reference's `viz.draw_matches` of the
    port's keys and pairs, bit for bit;
  - `dump`: every PGM within one step of the reference's; on the
    reference's pyramid, every PGM byte-identical (the bf16 gradient stacks
    are bit-identical);
  - `twoview` on `.npy` images: tests/test_twoview.py's ground-truth bounds;
  - `slam`: TUM rows with unit quaternions, equal to an in-process
    `run_slam` with its final pass, a `--resume` that replays the run, and
    the reference's metric event kinds;
  - `speed --trace`: a Chrome trace that parses as JSON;
  - without a card and without `--cpu`, `python -m siftgpu_tpu_torch`
    exits non-zero with the device message.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftgpu_tpu.core import image as jimage
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu.pipeline import cli as jcli
from siftgpu_tpu.pipeline import siftio as jsiftio
from siftgpu_tpu.pipeline import viz as jviz
from siftgpu_tpu.pipeline.api import SiftTPU as JSift
from siftgpu_tpu_torch import convert
from siftgpu_tpu_torch.core import image as imio
from siftgpu_tpu_torch.core.config import MatchConfig
from siftgpu_tpu_torch.frontend import pyramid
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import api, checkpoint, cli, siftio, slam, twoview

from test_torch_api import ARGVS, check_keys
from torch_threads import one_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
STORE_KEYS = {"x": np.float32, "y": np.float32, "sigma": np.float32, "theta": np.float32,
              "response": np.float32, "octave": np.int32, "desc": np.uint8, "mask": np.bool_}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    a = fixtures.random_texture(64, 80, seed=5)
    b = fixtures.warp_affine(a, np.eye(2), np.array([2.0, -1.0]))
    paths = (str(d / "a.pgm"), str(d / "b.pgm"))
    for p, img in zip(paths, (a, b)):
        imio.save_pgm(p, img)
    return d, paths


@pytest.mark.parametrize("argv", ARGVS + [["-tc", "256", "img.pgm", "-tc2", "99"]],
                         ids=lambda a: " ".join(a))
def test_split_flags_matches_reference(argv):
    assert cli._split_flags(argv) == jcli._split_flags(argv)


def test_extract_sift_and_store_match_reference(images):
    d, (a, _) = images
    assert jcli.main(["extract", a, "--out", str(d / "j.sift"), "--npz", str(d / "j.npz")]) == 0
    assert cli.main(["extract", a, "--out", str(d / "p.sift"), "--npz", str(d / "p.npz"),
                     "--cpu"]) == 0
    check_keys(jsiftio.read_lowe_ascii(str(d / "j.sift")), siftio.read_lowe_ascii(str(d / "p.sift")))
    ref, got = jsiftio.load_feature_store(str(d / "j.npz")), siftio.load_feature_store(str(d / "p.npz"))
    assert set(got) == set(ref) == set(STORE_KEYS) | {"frame_ids"}
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        if k in STORE_KEYS:
            assert v.dtype == STORE_KEYS[k]
    assert int(got["mask"].sum()) == int(ref["mask"].sum())


def test_match_viz_is_the_reference_drawing(images, capsys):
    d, (a, b) = images
    assert cli.main(["match", a, b, "--viz", str(d / "m.ppm"), "--cpu"]) == 0
    printed = capsys.readouterr().out.splitlines()
    s = api.SiftTPU(device="cpu")
    s.run_sift(a)
    k0, d0 = s.get_feature_vector()
    s.run_sift(b)
    k1, d1 = s.get_feature_vector()
    m = api.SiftMatchTPU(max_sift=max(len(d0), len(d1)), device="cpu")
    m.set_descriptors(0, d0)
    m.set_descriptors(1, d1)
    pairs = m.get_sift_match()
    assert printed[0] == f"{len(d0)} x {len(d1)} features -> {len(pairs)} matches"
    assert len(pairs) > 10
    want = jviz.draw_matches(jimage.load_image(a), jimage.load_image(b), k0, k1, pairs)
    np.testing.assert_array_equal(imio.load_pnm(str(d / "m.ppm")), want)


def test_dump_matches_reference(images, monkeypatch):
    """End to end every PGM within one step of the reference's; on the
    reference's own pyramid the port's dump writes the reference's bytes
    (its bf16 gradient stack is bit-identical)."""
    d, (a, _) = images
    jd, pd, sd = d / "dump_j", d / "dump_p", d / "dump_same"
    assert jcli.main(["dump", a, "--outdir", str(jd)]) == 0
    assert cli.main(["dump", a, "--outdir", str(pd), "--kp", "--cpu"]) == 0
    names = sorted(os.listdir(jd))
    assert sorted(os.listdir(pd)) == sorted(names + ["keypoints.ppm"])
    assert imio.load_pnm(str(pd / "keypoints.ppm")).shape == (64, 80, 3)
    octaves = {n.split("_")[0] for n in names}
    assert len(octaves) >= 3 and sum("gradmag" in n for n in names) == 3 * len(octaves)
    for n in names:
        r, g = (imio.load_pnm(str(x / n)).astype(int) for x in (jd, pd))
        assert r.shape == g.shape and np.abs(r - g).max() <= 1, n

    img = jimage.load_image(a)
    ref_pyr = jpyramid.build_pyramid(jnp.asarray(img[None]), JSift().config_for(*img.shape))
    monkeypatch.setattr(pyramid, "build_pyramid",
                        lambda *_: [convert.tree_to_torch(oc, pyramid.Octave) for oc in ref_pyr])
    assert cli.main(["dump", a, "--outdir", str(sd), "--cpu"]) == 0
    assert sorted(os.listdir(sd)) == names
    for n in names:
        assert (sd / n).read_bytes() == (jd / n).read_bytes(), n


def test_twoview_meets_ground_truth(tmp_path, monkeypatch, capsys):
    h, w = 160, 200
    intr = (180.0, 180.0, w / 2.0, h / 2.0)
    t_gt = np.array([-0.4, 0.05, 0.02])
    img0, img1, meta = fixtures.two_plane_stereo(h, w, intr, [0.01, -0.03, 0.005], t_gt,
                                                 d_near=5.0, d_far=10.0, seed=2)
    for name, img in (("p0.npy", img0), ("p1.npy", img1)):
        np.save(tmp_path / name, img)
    got = []
    real = twoview.two_view_reconstruct_jit   # the CLI's call: the captured entry point
    monkeypatch.setattr(twoview, "two_view_reconstruct_jit",
                        lambda *a: got.append(real(*a)) or got[0])
    assert cli.main(["twoview", str(tmp_path / "p0.npy"), str(tmp_path / "p1.npy"), "--focal", "180",
                     "--seed", "7", "-tc", "1024", "--cpu"]) == 0
    res = got[0]
    assert capsys.readouterr().out.startswith(
        f"matches={int(res.num_matches)} inliers={int(res.num_inliers)}")
    nm, ni = int(res.num_matches), int(res.num_inliers)
    assert nm > 100 and ni > 0.5 * nm
    dR = res.R.double().numpy() @ meta["R"].T
    ang = np.arctan2(np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                                     dR[1, 0] - dR[0, 1]]) / 2, (np.trace(dR) - 1) / 2)
    assert ang < 0.01
    tn = res.t.numpy() / np.linalg.norm(res.t.numpy())
    tg = t_gt / np.linalg.norm(t_gt)
    assert min(np.abs(tn - tg).max(), np.abs(tn + tg).max()) < 0.02
    assert float(res.rms) < 0.75
    m = res.point_mask.numpy()
    z = res.points.numpy()[m][:, 2] / (np.linalg.norm(res.t.numpy()) / np.linalg.norm(t_gt))
    assert ((z > 4.0) & (z < 6.0)).mean() + ((z > 8.0) & (z < 12.0)).mean() > 0.8


def _read_tum(path):
    rows = np.array([[float(v) for v in ln.split()] for ln in open(path)])
    assert rows.shape[1] == 8
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
    return rows


def test_slam_writes_the_in_process_trajectory_and_resumes(tmp_path):
    """tests/test_api.py:246-272's scene, 8 frames long so that the CLI's
    default SlamConfig bootstraps (at frame 6) and takes a keyframe after."""
    T, H, W = 8, 96, 128
    intr = (110.0, 110.0, W / 2.0, H / 2.0)
    frames, _ = fixtures.two_plane_sequence(
        T, H, W, intr, rvec_step=np.array([0.002, -0.004, 0.001]),
        t_step=np.array([-0.12, 0.012, 0.006]), d_near=5.0, d_far=10.0, seed=4)
    seq, ml = tmp_path / "seq.npy", tmp_path / "m.jsonl"
    np.save(seq, frames)
    common = ["slam", str(seq), "--focal", "110", "--cpu"]
    assert cli.main(common + ["--traj", str(tmp_path / "t.txt"), "--metrics", str(ml),
                              "--checkpoint", str(tmp_path / "end.npz")]) == 0
    rows = _read_tum(tmp_path / "t.txt")
    assert len(rows) == T and np.array_equal(rows[:, 0], np.arange(T))

    # the same run in process, with the CLI's final pass
    cfg = api.SiftTPU(device="cpu").config_for(H, W)
    mcfg, scfg = MatchConfig(max_match=cfg.max_keypoints), slam.SlamConfig()
    res = slam.run_slam(frames, intr, cfg, mcfg, scfg, device="cpu")
    if res.loop_edges and slam.apply_pose_graph_sim3(
            res.keyframes, res.trajectory, res.map_points, res.map_mask, res.map_anchor,
            res.loop_edges, odo_edges=res.odo_edges, device="cpu"):
        slam.refit_map_points(res.keyframes, res.map_points, res.map_mask, intr, device="cpu")
    siftio.save_trajectory_tum(str(tmp_path / "in.txt"), res.trajectory)
    np.testing.assert_allclose(rows, _read_tum(tmp_path / "in.txt"), rtol=0, atol=2e-6)
    assert len(res.keyframe_indices) >= 3 and np.abs(rows[-1, 1:4]).max() > 0.1

    # --resume: from the end of the run, and from a checkpoint before frame 7
    assert cli.main(common + ["--resume", "--checkpoint", str(tmp_path / "end.npz"),
                              "--traj", str(tmp_path / "r.txt")]) == 0
    np.testing.assert_allclose(_read_tum(tmp_path / "r.txt"), rows, rtol=0, atol=2e-6)
    part = slam.run_slam(frames[:7], intr, cfg, mcfg, scfg, device="cpu")
    assert part.keyframe_indices == res.keyframe_indices[:2]
    checkpoint.save_slam_state(str(tmp_path / "mid.npz"), part, next_frame=7)
    assert cli.main(common + ["--resume", "--checkpoint", str(tmp_path / "mid.npz"),
                              "--traj", str(tmp_path / "m.txt")]) == 0
    np.testing.assert_allclose(_read_tum(tmp_path / "m.txt"), rows, rtol=0, atol=2e-6)

    kinds = {json.loads(ln)["event"] for ln in open(ml)}
    assert {"bootstrap", "track", "keyframe", "ba_window", "checkpoint"} <= kinds
    assert kinds <= {"bootstrap", "track", "keyframe", "ba_window", "checkpoint", "loop_closure",
                     "loop_correction", "relocalized", "track_lost", "track_recovered"}


def test_speed_writes_a_trace(images, capsys):
    d, (a, _) = images
    assert cli.main(["speed", a, "--iters", "2", "--trace", str(d / "trace"), "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "ms/frame" in out and "Hz (steady-state, 2 iters)" in out
    with open(d / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_module_without_a_card_exits_with_the_device_message(monkeypatch, capsys):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "siftgpu_tpu_torch", "extract", "x.pgm"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device cuda is not available" in out.stderr and not out.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in jcli._COMMANDS:
        assert cli.main([cmd, "x"]) == 1
        assert "device cuda is not available" in capsys.readouterr().err
