"""The port's binding of the native loader (`native/loader.cpp`), mirroring
tests/test_native.py: PGM load against the NumPy codecs, PPM colour, the
`-maxd` downsample, the batch loader with a missing file, and the binary
`.sift` writer read back by both packages; the same arrays as the
reference's binding; and the route: with no compiler on PATH
`core.image.load_image` takes the NumPy codecs, and a compiler that fails
to build raises."""

import os

import numpy as np
import pytest

from siftgpu_tpu.core import native as jnative
from siftgpu_tpu.pipeline import siftio as jsiftio
from siftgpu_tpu_torch.core import image as imio
from siftgpu_tpu_torch.core import native
from siftgpu_tpu_torch.pipeline import siftio


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no g++ on PATH: the native route is not taken on this machine")
    return native._lib()


def _pgm(tmp_path, name, img):
    p = str(tmp_path / name)
    imio.save_pgm(p, img)
    return p


def test_load_matches_numpy_codecs_and_reference(lib, tmp_path):
    img = np.random.default_rng(0).random((40, 56)).astype(np.float32)
    p = _pgm(tmp_path, "a.pgm", img)
    out = native.load_image(p)
    assert out.dtype == np.float32 and out.shape == (40, 56)
    np.testing.assert_allclose(out, imio.to_grayscale(imio.load_pnm(p)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(imio.load_image(p), out)   # the route image.py takes
    ref = jnative.load_image(p)
    if ref is not None:                                      # the reference's own build
        np.testing.assert_array_equal(out, ref)
    assert native.library_path(native.find_compiler()).parent == native.BUILD_DIR


def test_ppm_colour(lib, tmp_path):
    rgb = (np.random.default_rng(1).random((16, 20, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "c.ppm")
    imio.save_ppm(p, rgb)
    np.testing.assert_allclose(native.load_image(p), imio.to_grayscale(rgb), rtol=0, atol=2e-3)


def test_maxd_downsample(lib, tmp_path):
    img = np.random.default_rng(2).random((64, 96)).astype(np.float32)
    p = _pgm(tmp_path, "d.pgm", img)
    out = native.load_image(p, maxd=30)
    ref = imio.downsample_to_fit(imio.to_grayscale(imio.load_pnm(p)), 30)
    assert out.shape == ref.shape == (16, 24)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_batch_loader_with_a_missing_file(lib, tmp_path):
    rng = np.random.default_rng(3)
    paths = [_pgm(tmp_path, f"b{i}.pgm", rng.random((32, 40)).astype(np.float32))
             for i in range(6)]
    paths.append(str(tmp_path / "missing.pgm"))
    batch, status = native.load_batch(paths, 32, 40, threads=3)
    assert batch.shape == (7, 32, 40) and batch.dtype == np.float32
    assert (status[:6] == 0).all() and status[6] != 0 and not batch[6].any()
    for i in range(6):
        np.testing.assert_array_equal(batch[i], native.load_image(paths[i]))
    with pytest.raises(OSError, match="native decode failed"):
        native.load_image(paths[6])


def test_binary_sift_read_back_by_both_packages(lib, tmp_path):
    rng = np.random.default_rng(4)
    keys = rng.random((17, 4)).astype(np.float32) * 100
    desc = rng.integers(0, 256, (17, 128)).astype(np.uint8)
    p = str(tmp_path / "n.sift")
    native.write_binary_sift(p, keys, desc)
    for read in (siftio.read_binary_sift, jsiftio.read_binary_sift):
        k2, d2 = read(p)
        np.testing.assert_array_equal(k2, keys)
        np.testing.assert_array_equal(d2, desc)
    # the Python writers' bytes up to the end marker: loader.cpp writes "EOF\0"
    # where `siftio` (in both packages) writes the int32 0x00454F46
    siftio.write_binary_sift(str(tmp_path / "py.sift"), keys, desc)
    native_bytes = open(p, "rb").read()
    assert (tmp_path / "py.sift").read_bytes()[:-4] == native_bytes[:-4]
    assert native_bytes[-4:] == b"EOF\0"
    if jnative.write_binary_sift(str(tmp_path / "j.sift"), keys, desc):
        assert (tmp_path / "j.sift").read_bytes() == native_bytes
    with pytest.raises(ValueError, match="expected keys"):
        native.write_binary_sift(p, keys[:, :3], desc)


def test_no_compiler_takes_the_numpy_codecs(tmp_path, monkeypatch):
    img = np.random.default_rng(5).random((12, 18)).astype(np.float32)
    p = _pgm(tmp_path, "e.pgm", img)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert not native.available()
    np.testing.assert_array_equal(imio.load_image(p), imio.to_grayscale(imio.load_pnm(p)))
    with pytest.raises(RuntimeError, match="needs g\\+\\+ on PATH"):
        native.load_image(p)


def test_failing_compiler_raises(tmp_path, monkeypatch):
    img = np.random.default_rng(6).random((12, 18)).astype(np.float32)
    p = _pgm(tmp_path, "f.pgm", img)
    bad = tmp_path / "bin"
    bad.mkdir()
    cxx = bad / "g++"
    cxx.write_text("#!/bin/sh\necho 'internal compiler error' >&2\nexit 1\n")
    os.chmod(cxx, 0o755)
    monkeypatch.setenv("PATH", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.available() and native.find_compiler() == str(cxx)
    with pytest.raises(RuntimeError, match="failed to build loader.cpp"):
        imio.load_image(p)
    assert os.listdir(tmp_path / "build") == []          # no library, no temporary left
