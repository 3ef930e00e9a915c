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


def _radii(dog_levels=3):
    cfg = SiftConfig(dog_levels=dog_levels)
    return [(len(t) - 1) // 2 for t in (cfg.gaussian_taps(float(s)) for s in cfg.incremental_sigmas())]


def _csrc_constants():
    """TH, TW, NT, MAX_TAPS, MAX_LEVELS as csrc/pyramid_octave.cu states them."""
    import re
    from pathlib import Path

    src = (Path(pyramid_kernel.__file__).parent.parent / "csrc" / "pyramid_octave.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("TH", "TW", "NT", "MAX_TAPS", "MAX_LEVELS")}


@pytest.mark.parametrize("shape,dog_levels", [
    ((4, 480, 640), 3), ((4, 240, 320), 3), ((4, 120, 160), 3), ((4, 60, 80), 3),
    ((4, 30, 40), 3), ((1, 20, 26), 3), ((1, 33, 47), 3),
    ((4, 480, 640), 2), ((4, 480, 640), 4), ((4, 480, 640), 5)], ids=str)
def test_launch_plan(shape, dog_levels):
    """The octave kernel's launch: 64x64 tiles, one per block at most, each
    level's halo its own radius, the shared windows of the largest radius
    within a block's 227 KB less the static tap arrays; the wrapper's
    constants are the kernel source's."""
    B, H, W = shape
    radii = _radii(dog_levels)
    plan = pyramid_kernel.launch_plan(B, H, W, radii)
    c = _csrc_constants()
    assert plan["tile"] == (c["TH"], c["TW"]) == (64, 64) and plan["threads"] == c["NT"]
    assert plan["tiles"] == B * -(-H // 64) * -(-W // 64)
    assert plan["halo"] == tuple(radii) and len(radii) == dog_levels + 2
    r = max(radii)
    assert plan["smem_bytes"] == 4 * (64 + 2 * r) * (((64 + 2 * r) | 1) + 65)
    assert plan["smem_bytes"] <= 232_448 - (c["MAX_TAPS"] + 2 * c["MAX_LEVELS"]) * 4
    if dog_levels == 3:
        assert radii == [5, 7, 8, 10, 13] and plan["smem_bytes"] == 56_160
    if shape == (4, 480, 640) and dog_levels == 3:
        assert plan["tiles"] == 320


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pyramid_kernel.launch_plan(1, 64, 64, [120])
    with pytest.raises(ValueError, match="taps in all"):
        pyramid_kernel.launch_plan(1, 64, 64, [40, 40, 40, 40])
    with pytest.raises(ValueError, match="levels"):
        pyramid_kernel.launch_plan(1, 64, 64, [])


def _tiled_octave(base, taps_list):
    """A NumPy model of csrc/pyramid_octave.cu's tiling: level s of each
    64x64 tile from level s-1 of the whole plane, through a window of the
    tile plus only that level's radius on each side, every coordinate
    clamped to the image; the row pass over every window row, then the
    column pass over the tile; only in-image outputs are stored."""
    B, H, W = base.shape
    plan = pyramid_kernel.launch_plan(B, H, W, [(len(t) - 1) // 2 for t in taps_list])
    th, tw = plan["tile"]
    levels = [base.astype(np.float64)]
    for t, r in zip(taps_list, plan["halo"]):
        t = np.asarray(t, np.float64)
        prev, out = levels[-1], np.empty_like(levels[-1])
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                rows = np.clip(np.arange(y0 - r, y0 + th + r), 0, H - 1)
                cols = np.clip(np.arange(x0 - r, x0 + tw + r), 0, W - 1)
                win = prev[:, rows][:, :, cols]                       # [B, th+2r, tw+2r]
                tmp = sum(t[k] * win[:, :, k : k + tw] for k in range(2 * r + 1))
                tile = sum(t[k] * tmp[:, k : k + th] for k in range(2 * r + 1))
                hh, ww = min(th, H - y0), min(tw, W - x0)
                out[:, y0 : y0 + hh, x0 : x0 + ww] = tile[:, :hh, :ww]
        levels.append(out)
    gauss = np.stack(levels, 1)
    return gauss, gauss[:, 1:] - gauss[:, :-1]


@pytest.mark.parametrize("shape,dog_levels", [((2, 20, 26), 3), ((1, 33, 47), 3),
                                              ((2, 97, 131), 3), ((1, 97, 131), 2)], ids=str)
def test_tiled_model_matches_plain_chain(shape, dog_levels):
    """The kernel's index arithmetic, checked where no card is: its tiling
    and per-level halos give the plain chain's octave within 1e-6."""
    cfg = SiftConfig(dog_levels=dog_levels)
    taps = [cfg.gaussian_taps(float(s)) for s in cfg.incremental_sigmas()]
    base = np.random.default_rng(7).random(shape).astype(np.float32)
    mg, md = _tiled_octave(base, taps)
    pg, pd = pyramid_kernel.blur_octave_fused_plain(torch.from_numpy(base), taps)
    assert float(np.abs(mg - pg.double().numpy()).max()) < 1e-6
    assert float(np.abs(md - pd.double().numpy()).max()) < 1e-6
    assert np.array_equal(mg[:, 0], base)
