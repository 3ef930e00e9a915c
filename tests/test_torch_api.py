"""The port's SiftGPU-style facade against the reference's, on the cases of
tests/test_api.py, with `device="cpu"` for the port.

  - flags: the same dict from every argv list of tests/test_api.py;
  - extraction through the facade (plain and with -fo -1, -obo, -tc1, -tc2,
    -sign, -loweo, -unn): the extract budgets of tests/test_torch_extract.py;
  - files: byte-identical to the reference writers' for the same keys and
    descriptors, and round trips;
  - SiftMatchTPU, plain and guided (H): both facades get the same descriptors
    and locations (the reference facade's), so the pairs are identical;
  - descriptor-only mode: the same mask, descriptors within 1 uint8 step,
    and the reference's own cosine bounds against the full pipeline;
  - a CUDA facade without a card reports SIFTGPU_NOT_SUPPORTED and raises."""

import functools
import time

import numpy as np
import pytest
import torch

from siftgpu_tpu.core import flags as jflags
from siftgpu_tpu.core import image as jimage
from siftgpu_tpu.pipeline import siftio as jsiftio
from siftgpu_tpu.pipeline.api import ComboSiftTPU as JCombo
from siftgpu_tpu.pipeline.api import SiftMatchTPU as JMatcher
from siftgpu_tpu.pipeline.api import SiftTPU as JSift
from siftgpu_tpu_torch.core import flags, image as imio, native
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.pipeline import api, siftio
from siftgpu_tpu_torch.pipeline.api import ComboSiftTPU, SiftMatchTPU, SiftTPU

from helpers import angdiff, desc_cosine
from test_torch_extract import _pair
from torch_threads import one_thread  # noqa: F401 (autouse)

ARGVS = [
    ["-fo", "-1", "-d", "4", "-t", "0.01", "-e", "8", "-m", "-s", "-maxd", "1600",
     "-tc2", "1000", "-loweo", "-unn", "-b", "-cuda", "-v", "2", "-weird"],
    ["-tc", "64"], ["-tc1", "64"], ["-tc2", "64"], ["-tc3", "64"],
    ["-m", "1", "-s", "0"], ["-m", "7"], ["-m", "-5"], ["-m", "abc"], ["-m", "-s", "1"],
    ["-il", "imgs.txt", "-p", "96x80", "-v", "0"],
    ["-obo", "-sign", "-f", "3", "-i", "a.pgm", "-o", "a.sift", "-tc=32", "-m=1", "-s=0"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_parse_flags_matches_reference(argv):
    assert flags.parse_flags(argv) == jflags.parse_flags(argv)


def _as_dict(keys, desc):
    return dict(x=keys[:, 0], y=keys[:, 1], sigma=keys[:, 2], theta=keys[:, 3], desc=desc)


def check_keys(ref, got):
    """The extract budgets (tests/test_torch_extract.py) on (keys, desc) pairs."""
    r, g = _as_dict(*ref), _as_dict(*got)
    assert len(g["x"]) == len(r["x"]) > 20
    pairs = _pair(r, g)
    assert len(pairs) >= 0.99 * len(r["x"])
    tds = np.array([angdiff(r["theta"][a], g["theta"][b]) for a, b in pairs])
    assert np.quantile(tds, 0.75) < 1e-3 and np.quantile(tds, 0.9) < 2e-2 and tds.max() < 0.05
    cos = np.array([desc_cosine(r["desc"][a], g["desc"][b]) for a, b in pairs])
    assert np.quantile(cos, 0.25) > 0.999 and cos.min() > 0.995
    assert max(abs(r["sigma"][a] - g["sigma"][b]) for a, b in pairs) < 1e-2


@functools.lru_cache(maxsize=None)
def _image(h=80, w=96, seed=3):
    return fixtures.random_texture(h, w, seed=seed)


def _both(argv, img, **kw):
    j = JSift(argv, **kw)
    t = SiftTPU(argv, device="cpu", **kw)
    assert j.run_sift(img) and t.run_sift(img)
    return j, t


OPTIONS = [["-fo", "-1", "-tc", "128"], ["-obo", "-tc", "128"], ["-tc1", "40"],
           ["-tc2", "40"], ["-sign", "-tc", "128"], ["-loweo", "-tc", "128"],
           ["-unn", "-tc", "128"]]


@pytest.mark.parametrize("argv", OPTIONS, ids=lambda a: " ".join(a))
def test_facade_options_match_reference(argv):
    j, t = _both(argv, _image())
    assert t._cfg == type(t._cfg)(**{f: getattr(j._cfg, f) for f in j._cfg.__dataclass_fields__})
    check_keys(j.get_feature_vector(), t.get_feature_vector())
    assert t.get_feature_num() == j.get_feature_num()


def test_run_sift_and_files_match_reference(tmp_path):
    j, t = _both(["-tc", "128"], _image())
    assert j.create_context() == t.create_context() == api.SIFTGPU_FULL_SUPPORTED
    keys, desc = t.get_feature_vector()
    assert keys.dtype == np.float32 and keys.shape == (t.get_feature_num(), 4)
    assert desc.dtype == np.uint8 and desc.shape == (len(keys), 128)
    check_keys(j.get_feature_vector(), (keys, desc))

    # the port's writers give the reference writers' bytes for the same data
    for ext, write, jwrite in (("txt", siftio.write_lowe_ascii, jsiftio.write_lowe_ascii),
                               ("bin", siftio.write_binary_sift, jsiftio.write_binary_sift)):
        write(str(tmp_path / f"p.{ext}"), keys, desc)
        jwrite(str(tmp_path / f"j.{ext}"), keys, desc)
        assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    t.save_sift(str(tmp_path / "s.txt"))
    assert (tmp_path / "s.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    t.save_sift(str(tmp_path / "s.bin"), binary=True)
    assert (tmp_path / "s.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()

    k2, d2 = siftio.read_lowe_ascii(str(tmp_path / "s.txt"))
    np.testing.assert_allclose(k2, keys, atol=1e-5)
    np.testing.assert_array_equal(d2, desc)
    k3, d3 = siftio.read_binary_sift(str(tmp_path / "s.bin"))
    np.testing.assert_array_equal(k3, keys)
    np.testing.assert_array_equal(d3, desc)
    for a, b in zip(jsiftio.read_binary_sift(str(tmp_path / "s.bin")), (k3, d3)):
        np.testing.assert_array_equal(a, b)
    # an empty feature set writes the same bytes too
    siftio.write_lowe_ascii(str(tmp_path / "e.p"), keys[:0], desc[:0])
    jsiftio.write_lowe_ascii(str(tmp_path / "e.j"), keys[:0], desc[:0])
    assert (tmp_path / "e.p").read_bytes() == (tmp_path / "e.j").read_bytes()


def test_output_flag_autosaves(tmp_path, capsys):
    """-o saves after every run (later runs to a suffixed path); -v 1 prints
    the totals line; -v 2 prints it and then the per-stage table."""
    out = tmp_path / "auto.sift"
    s = SiftTPU(["-tc", "128", "-o", str(out), "-v", "1"], device="cpu")
    assert s.run_sift(_image())
    assert "#features:" in capsys.readouterr().out
    keys, desc = s.get_feature_vector()
    k2, d2 = siftio.read_lowe_ascii(str(out))
    np.testing.assert_allclose(k2, keys, atol=1e-5)
    np.testing.assert_array_equal(d2, desc)
    assert s.run_sift(_image())
    assert (tmp_path / "auto.sift.1").exists()
    capsys.readouterr()
    s.parse_param(["-v", "2"])
    assert s.run_sift(_image())
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("#features:")
    assert out[1].split() == ["stage", "ms/iter", "ms/frame"]
    rows = [ln.split() for ln in out[2:]]
    assert [r[0] for r in rows] == ["pyramid", "detect", "gradients", "orient+desc", "assemble",
                                    "TOTAL"]
    ms = [float(r[1]) for r in rows]
    assert all(v >= 0 for v in ms) and abs(sum(ms[:-1]) - ms[-1]) <= 0.01 * len(ms)


@functools.lru_cache(maxsize=None)
def _reference_match_inputs():
    img0 = fixtures.random_texture(96, 128, seed=42)
    img1 = fixtures.warp_affine(img0, np.eye(2), np.array([6.0, -3.0]))
    s = JSift(max_keypoints=512)
    s.run_sift(img0)
    k0, d0 = s.get_feature_vector()
    s.run_sift(img1)
    k1, d1 = s.get_feature_vector()
    return k0, d0, k1, d1


def test_sift_match_facade_matches_reference():
    k0, d0, k1, d1 = _reference_match_inputs()
    H = np.array([[1, 0, 6.0], [0, 1, -3.0], [0, 0, 1]], np.float32)
    out = []
    for m in (JMatcher(max_sift=512), SiftMatchTPU(max_sift=512, device="cpu")):
        m.set_descriptors(0, d0)
        m.set_descriptors(1, d1)
        m.SetFeautreLocation(0, k0)
        m.set_feature_location(1, k1)
        out.append((m.get_sift_match(), m.get_guided_sift_match(H=H, hdistmax=3.0),
                    m.get_sift_match(max_match=7, ratiomax=0.6)))
    for a, b in zip(*out):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(b, a)
    pairs, gp, few = out[1]
    assert len(pairs) > 20 and len(gp) > 10 and len(few) == 7
    err = np.hypot(k1[gp[:, 1], 0] - (k0[gp[:, 0], 0] + 6.0),
                   k1[gp[:, 1], 1] - (k0[gp[:, 0], 1] - 3.0))
    assert (err < 3.0).all()


def test_descriptor_only_mode_matches_reference():
    img = fixtures.random_texture(80, 96, seed=9)
    j, t = _both([], img, max_keypoints=128)
    keys, full = j.get_feature_vector()
    keys, full = keys[:32], full[:32]
    for s in (j, t):
        s.set_keypoint_list(keys)
        assert s.run_sift_with_keypoints(img)
    m = t._feats.mask[0].numpy()
    np.testing.assert_array_equal(m, np.asarray(j._feats.mask[0]))
    assert m.all()
    got = t._feats.desc[0].numpy()
    assert np.abs(got.astype(int) - np.asarray(j._feats.desc[0]).astype(int)).max() <= 1
    kp, _ = t.get_feature_vector()
    np.testing.assert_array_equal(kp, keys)
    cos = [desc_cosine(a, b) for a, b in zip(got, full)]
    assert min(cos) > 0.95 and np.mean(cos) > 0.99


def _reference_decode(path, wait_s=120.0):
    """The reference's `load_image` of `path` on its native decoder where
    the port's is available (g++ on PATH), else on its NumPy codecs.

    The reference compiles `native/libsiftloader.so` in place, so a process
    that loads it while another process (tests/test_native.py in a parallel
    worker) is still writing it gets an OSError and stays on the NumPy
    codecs for good (`_TRIED`).  Those codecs differ from the native decode
    by 1 ulp at some pixels, so this retries the reference's load, with
    `_TRIED` reset, until the library is whole."""
    from siftgpu_tpu.core import native as jnative

    if not native.available():
        return jimage.load_image(path)
    deadline = time.monotonic() + wait_s
    while not jnative.available():
        if time.monotonic() > deadline:
            raise AssertionError(f"the reference's native loader did not load in {wait_s} s")
        time.sleep(0.5)
        jnative._TRIED = False
    return jimage.load_image(path)


def test_image_io_matches_reference(tmp_path):
    rgb = (np.random.default_rng(0).random((20, 30, 3)) * 255).astype(np.uint8)
    g = imio.to_grayscale(rgb)
    np.testing.assert_array_equal(g, jimage.to_grayscale(rgb))
    assert g.shape == (20, 30) and 0 <= g.min() and g.max() <= 1
    imio.save_pgm(str(tmp_path / "p.pgm"), g)
    jimage.save_pgm(str(tmp_path / "j.pgm"), g)
    assert (tmp_path / "p.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()
    # the reference's route: its native decoder where g++ builds it (as the
    # port's core/native.py), else its NumPy codecs (as the port's)
    np.testing.assert_array_equal(imio.load_image(str(tmp_path / "p.pgm")),
                                  _reference_decode(str(tmp_path / "j.pgm")))
    np.testing.assert_allclose(imio.load_image(str(tmp_path / "p.pgm")),
                               jimage.to_grayscale(jimage.load_pnm(str(tmp_path / "j.pgm"))),
                               rtol=0, atol=1e-6)
    imio.save_ppm(str(tmp_path / "p.ppm"), rgb)
    jimage.save_ppm(str(tmp_path / "j.ppm"), rgb)
    assert (tmp_path / "p.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(imio.load_pnm(str(tmp_path / "p.ppm")), rgb)
    np.save(tmp_path / "a.npy", g)
    np.testing.assert_array_equal(imio.load_image(str(tmp_path / "a.npy")), g)
    big = np.random.default_rng(1).random((64, 96)).astype(np.float32)
    np.testing.assert_array_equal(imio.downsample_to_fit(big, 30), jimage.downsample_to_fit(big, 30))
    assert imio.downsample_to_fit(big, 30).shape == (16, 24)


def test_maxd_flag_downsamples():
    img = fixtures.random_texture(128, 160, seed=5)
    t = SiftTPU(max_keypoints=128, device="cpu")
    t.parse_param(["-maxd", "80"])
    assert t.run_sift(img)
    assert (t._cfg.height, t._cfg.width) == (64, 80)
    direct = SiftTPU(max_keypoints=128, device="cpu")
    direct.run_sift(imio.downsample_to_fit(img, 80))
    for a, b in zip(t.get_feature_vector(), direct.get_feature_vector()):
        np.testing.assert_array_equal(a, b)


def test_combo_and_image_list_match_reference(tmp_path):
    img0 = _image(seed=13)
    img1 = fixtures.warp_affine(img0, np.eye(2), np.array([4.0, 2.0]))
    paths = []
    for i, im in enumerate((img0, img1)):
        paths.append(str(tmp_path / f"im{i}.pgm"))
        imio.save_pgm(paths[-1], im)
    jcombo = JCombo(argv=["-tc", "128"], max_sift=128)
    combo = ComboSiftTPU(argv=["-tc", "128"], max_sift=128, device="cpu")
    jk0, jk1, jp = jcombo.match_files(*paths)
    k0, k1, pairs = combo.match_files(*paths)
    assert len(k0) == len(jk0)
    check_keys(jcombo.sift.get_feature_vector(), combo.sift.get_feature_vector())
    assert len(pairs) > 10 and abs(len(pairs) - len(jp)) <= max(2, 0.05 * len(jp))
    err = np.hypot(k1[pairs[:, 1], 0] - (k0[pairs[:, 0], 0] + 4.0),
                   k1[pairs[:, 1], 1] - (k0[pairs[:, 0], 1] + 2.0))
    assert (err < 1.0).mean() > 0.9

    # -il list consumed by bare run_sift(), after a -p warm-up at 96x80
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    s = SiftTPU(["-il", str(lst), "-p", "96x80", "-tc", "128"], device="cpu")
    assert s.create_context() == api.SIFTGPU_FULL_SUPPORTED
    counts = []
    while s.run_sift():
        counts.append(s.get_feature_num())
    assert counts == [len(k0), len(k1)]


def test_cuda_facade_without_a_card(monkeypatch):
    """No card: the CUDA facades report SIFTGPU_NOT_SUPPORTED and refuse to
    run; nothing moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = api.create_new_sift_tpu(["-tc", "64"])
    m = api.create_new_sift_match_tpu(64)
    assert s.device.type == m.device.type == "cuda"
    assert s.create_context() == s.verify_context() == api.SIFTGPU_NOT_SUPPORTED
    assert m.verify_context() == api.SIFTGPU_NOT_SUPPORTED
    with pytest.raises(RuntimeError, match="not available"):
        s.run_sift(_image())
    assert s.get_feature_num() == 0
    m.set_descriptors(0, np.zeros((3, 128), np.uint8))
    m.set_descriptors(1, np.zeros((3, 128), np.uint8))
    with pytest.raises(RuntimeError, match="not available"):
        m.get_sift_match()
    s.set_keypoint_list(np.zeros((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="not available"):
        s.run_sift_with_keypoints(_image())
