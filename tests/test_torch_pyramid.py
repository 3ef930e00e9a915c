"""Port pyramid vs the reference's CPU pyramid (its conv route), and the
octave-by-octave extraction (-obo) that builds it one octave at a time.

Tolerance 2e-6 absolute: both sides are f32 separable convolutions of the
same taps on [0, 1] images, summed in different orders; `first_octave = -1`
adds a bilinear 2x upsample (`F.interpolate` against `jax.image.resize`).

`extract_features_obo` is identical to the port's `extract_features` in
every valid slot (the masked tail carries unspecified padding, as in the
reference's tests/test_obo.py), and within the extract budgets of
tests/test_torch_extract.py of the reference's `extract_features_obo`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import extract as jextract
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import extract, pyramid
from siftgpu_tpu_torch.oracle import fixtures

from test_torch_extract import check_features


@pytest.mark.parametrize("h,w,b,fo", [(120, 160, 2, 0), (80, 96, 1, 0), (81, 97, 1, 1),
                                      (61, 83, 2, -1)])
def test_pyramid_matches_reference(h, w, b, fo):
    kw = dict(height=h, width=w, first_octave=fo)
    imgs = np.stack([fixtures.random_texture(h, w, seed=s) for s in range(b)])
    ref = jpyramid.build_pyramid(jnp.asarray(imgs), JConfig(**kw))
    got = pyramid.build_pyramid(torch.from_numpy(imgs), SiftConfig(**kw))
    assert len(got) == len(ref) == SiftConfig(**kw).octaves
    for r, g in zip(ref, got):
        assert tuple(g.gauss.shape) == r.gauss.shape and tuple(g.dog.shape) == r.dog.shape
        np.testing.assert_allclose(g.gauss.numpy(), np.asarray(r.gauss), rtol=0, atol=2e-6)
        np.testing.assert_allclose(g.dog.numpy(), np.asarray(r.dog), rtol=0, atol=2e-6)


def test_downsample_is_top_left_decimation():
    x = torch.arange(2 * 5 * 7, dtype=torch.float32).reshape(2, 5, 7)
    np.testing.assert_array_equal(pyramid.downsample2x(x).numpy(), x.numpy()[:, ::2, ::2])


def test_upsample2x_matches_reference():
    x = np.random.default_rng(0).random((2, 37, 53)).astype(np.float32)
    ref = np.asarray(jpyramid.upsample2x(jnp.asarray(x)))
    got = pyramid.upsample2x(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 74, 106)
    # one f32 ulp at 1.0: the two blend the same two taps in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("kw", [dict(), dict(first_octave=-1, max_keypoints=200),
                                dict(keep_sign=True, max_keypoints=48),
                                dict(truncate_method=2, max_keypoints=40)], ids=str)
def test_obo_matches_extract_features_and_reference(kw):
    img = fixtures.random_texture(80, 96, seed=3)[None]
    cfg = SiftConfig(height=80, width=96, **kw)
    a = extract.extract_features(torch.from_numpy(img), cfg)
    b = extract.extract_features_obo(torch.from_numpy(img), cfg)
    m = a.mask
    assert torch.equal(m, b.mask) and int(m.sum()) > 20
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x[m], y[m]), name
    ref = jextract.extract_features_obo(jnp.asarray(img), JConfig(height=80, width=96, **kw))
    check_features(ref, b)
