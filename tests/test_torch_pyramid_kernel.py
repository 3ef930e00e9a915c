"""The port's octave builder (`ops/pyramid_kernel.py::blur_octave_fused`,
whose CPU route is the plain chain) against the reference's fused Pallas
kernel in interpret mode and its sequential chain.

Bound: 1e-5 absolute on every Gaussian level and DoG, the reference's own
fused-versus-chain bound (tests/test_pyramid_kernel.py): structural errors
(halos, per-level replicate edges, tail rows) would show at 1e-2.  A frame's
octave does not depend on the rest of its batch (to 1e-6 on the CPU, whose
convolutions vary their order with the shape)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu.ops import pyramid_kernel as jkernel
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import pyramid
from siftgpu_tpu_torch.ops import pyramid_kernel
from siftgpu_tpu_torch.oracle import fixtures

TOL = 1e-5


def _max_err(port_octaves, ref_octaves):
    assert len(port_octaves) == len(ref_octaves)
    err = 0.0
    for p, r in zip(port_octaves, ref_octaves):
        assert tuple(p.gauss.shape) == r.gauss.shape and tuple(p.dog.shape) == r.dog.shape
        err = max(err, float(np.abs(p.gauss.numpy() - np.asarray(r.gauss)).max()),
                  float(np.abs(p.dog.numpy() - np.asarray(r.dog)).max()))
    return err


@pytest.mark.parametrize("hw", [(120, 160), (96, 130), (33, 47)])
def test_octaves_match_reference_fused_and_chain(hw):
    h, w = hw
    img = fixtures.random_texture(h, w, seed=1)[None]
    jcfg = JConfig(height=h, width=w, max_keypoints=256)
    cfg = SiftConfig(height=h, width=w, max_keypoints=256)
    x = torch.from_numpy(img)
    fused = pyramid.build_pyramid(x, cfg)                      # default: "fused"
    chain = pyramid.build_pyramid(x, cfg, octave_impl="xla")
    for a, b in zip(fused, chain):                             # both plain on the CPU
        assert torch.equal(a.gauss, b.gauss) and torch.equal(a.dog, b.dog)
    for impl in ("fused_interpret", "xla"):
        ref = jpyramid.build_pyramid(jnp.asarray(img), jcfg, octave_impl=impl)
        assert _max_err(fused, ref) < TOL, impl


def test_batch_and_tail_rows_match_reference():
    """150 rows: not a multiple of the reference kernel's 128-row slab."""
    h, w = 150, 200
    a = fixtures.random_texture(h, w, seed=2)
    b = fixtures.warp_affine(a, np.eye(2), np.array([2.0, 1.0]))
    x = np.stack([a, b])
    jcfg = JConfig(height=h, width=w, max_keypoints=256, num_octaves=2)
    cfg = SiftConfig(height=h, width=w, max_keypoints=256, num_octaves=2)
    got = pyramid.build_pyramid(torch.from_numpy(x), cfg)
    ref = jpyramid.build_pyramid(jnp.asarray(x), jcfg, octave_impl="fused_interpret")
    assert _max_err(got, ref) < TOL
    # batch independence: PyTorch's CPU convolutions pick their loop order
    # by shape, so the plain chain is batch-independent to a few f32 ulp
    # (measured 2.4e-7 on the second octave); the kernel is so bit for bit,
    # which chip_smoke.py checks on the card
    solo = pyramid.build_pyramid(torch.from_numpy(x[1:]), cfg)
    for both, one in zip(got, solo):
        assert float((both.gauss[1] - one.gauss[0]).abs().max()) < 1e-6
        assert float((both.dog[1] - one.dog[0]).abs().max()) < 1e-6
    assert torch.equal(got[0].gauss[1], solo[0].gauss[0])


@pytest.mark.parametrize("shape,flat", [((2, 33, 47), False), ((1, 20, 26), False),
                                        ((2, 24, 32), True)], ids=["odd", "below-halo", "flat"])
def test_blur_octave_fused_matches_reference_kernel(shape, flat):
    """The ops-level function on one octave base: odd sizes, a plane smaller
    than the 43 px cumulative halo (every tap clamps), a flat plane."""
    cfg = SiftConfig()
    taps = [cfg.gaussian_taps(float(s)) for s in cfg.incremental_sigmas()]
    rng = np.random.default_rng(3)
    base = np.full(shape, 0.5, np.float32) if flat else rng.random(shape).astype(np.float32)
    gauss, dog = pyramid_kernel.blur_octave_fused(torch.from_numpy(base), taps)
    rg, rd = jkernel.blur_octave_fused(jnp.asarray(base), taps, interpret=True)
    assert gauss.shape == rg.shape and dog.shape == rd.shape
    assert float(np.abs(gauss.numpy() - np.asarray(rg)).max()) < TOL
    assert float(np.abs(dog.numpy() - np.asarray(rd)).max()) < TOL
    assert torch.equal(gauss[:, 0], torch.from_numpy(base))
    if flat:
        assert float(dog.abs().max()) < TOL


def test_octave_impl_names():
    cfg = SiftConfig(height=32, width=32)
    with pytest.raises(ValueError, match="octave_impl"):
        pyramid.build_pyramid(torch.zeros(1, 32, 32), cfg, octave_impl="fused_interpret")
