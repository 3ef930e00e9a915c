"""Port pyramid vs the reference's CPU pyramid (its conv route).

Tolerance 2e-6 absolute: both sides are f32 separable convolutions of the
same taps on [0, 1] images, summed in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import pyramid
from siftgpu_tpu_torch.oracle import fixtures


@pytest.mark.parametrize("h,w,b,fo", [(120, 160, 2, 0), (80, 96, 1, 0), (81, 97, 1, 1)])
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


def test_upsampled_first_octave_is_refused():
    with pytest.raises(NotImplementedError):
        pyramid.build_pyramid(torch.zeros(1, 32, 32), SiftConfig(height=32, width=32, first_octave=-1))
