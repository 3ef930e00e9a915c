"""Kernel 5's plain version and the unfused descriptor path vs the reference.

  - `sample_gradients_plain` against the reference's gather route
    (`describe._bilerp_xla`) on the inputs of
    tests/test_pallas_ops.py::test_sample_gradients_matches_xla_bilinear with
    bf16 planes: within 2 ulp or 1e-6 (XLA:CPU may contract the blend into
    FMAs; the port rounds every product and sum);
  - `compute_descriptors` against the reference's with sampler="xla" on the
    inputs of test_descriptors_pallas_path_matches_xla_path, fed the
    reference's gradient stack: within 1 uint8 step;
  - `describe_at_keypoints` against the reference's on the inputs of
    tests/test_api.py::test_descriptor_only_mode_matches_full_pipeline, with
    keypoints at every octave's edges added: the same mask and octaves,
    descriptors within 1 step;
  - the sampler's skip rule (`plane < 0`) and shared `out` buffers, and
    `describe_at_keypoints` (each keypoint sampled once, on its own octave)
    bit for bit against the per-octave pattern it replaced: every octave
    describing the whole list in 512-keypoint chunks, keeping its rows."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu import extract_features_jit
from siftgpu_tpu.frontend import describe as jdescribe
from siftgpu_tpu.frontend import orient as jorient
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu.frontend.redetect import describe_at_keypoints as j_describe_at_keypoints
from siftgpu_tpu_torch.convert import keypoints_from_reference, to_torch
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import describe, orient, pyramid, redetect
from siftgpu_tpu_torch.ops import desc_sampler
from siftgpu_tpu_torch.oracle import fixtures


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def _sampler_inputs(in_bounds=True):
    rng = np.random.default_rng(0)
    P, H, W = 6, 100, 120
    planes = rng.normal(0, 1, (P, H, W)).astype(np.float32)
    N, G2 = 24, 256
    plane = rng.integers(0, P, N).astype(np.int32)
    cy = rng.uniform(20, H - 20, N)
    cx = rng.uniform(20, W - 20, N)
    spread = 15 if in_bounds else 60       # 60 px: grids that leave the image
    py = (cy[:, None] + rng.uniform(-spread, spread, (N, G2))).astype(np.float32)
    px = (cx[:, None] + rng.uniform(-spread, spread, (N, G2))).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    return bf(planes), bf(planes * 2.0), plane, py, px


@pytest.mark.parametrize("in_bounds", [True, False], ids=["in_image", "leaves_image"])
def test_plain_sampler_matches_reference_bilerp(in_bounds):
    gx, gy, plane, py, px = _sampler_inputs(in_bounds)
    P, H, W = gx.shape
    N, G2 = py.shape
    # the reference's layout: one image (B = 1) whose S = P levels are the planes
    grads = jorient.GradStack(gx=gx[None], gy=gy[None], h=H, w=W,
                              y0=jnp.zeros((), jnp.int32), global_h=H)
    rx, ry = jdescribe._bilerp_xla(grads, jnp.asarray(py).reshape(1, N, 16, 16),
                                   jnp.asarray(px).reshape(1, N, 16, 16), jnp.asarray(plane)[None])
    sx, sy = desc_sampler.sample_gradients(to_torch(gx), to_torch(gy), torch.from_numpy(plane),
                                           torch.from_numpy(py), torch.from_numpy(px))
    for got, ref in ((sx, rx), (sy, ry)):
        got, ref = got.numpy(), np.asarray(ref).reshape(N, G2)
        ok = (_ulps(got, ref) <= 2) | (np.abs(got - ref) <= 1e-6)
        assert ok.all(), np.abs(got - ref).max()


def test_plain_sampler_single_keypoint_and_plane_edges():
    """N = 1 on an odd-sized plane, samples at and beyond every edge: the
    clamped taps of `_bilerp_xla`, computed by hand."""
    H, W = 7, 9
    g = (np.arange(H * W, dtype=np.float32).reshape(1, H, W) / 8).astype(np.float32)
    gx = torch.from_numpy(g).to(torch.bfloat16)
    py = torch.tensor([[-3.0, 0.0, 6.0, 6.5, 2.25, 100.0]])
    px = torch.tensor([[-1.0, 8.0, 8.0, 0.5, 3.75, -50.0]])
    sx, sy = desc_sampler.sample_gradients(gx, -gx, torch.zeros(1, dtype=torch.int32), py, px)
    gf = gx.to(torch.float32)[0].numpy()
    want = [gf[0, 0], gf[0, 8], gf[6, 8], gf[6, 0] * 0.5 + gf[6, 1] * 0.5,
            None, gf[6, 0]]
    y, x = 2.25, 3.75
    want[4] = (gf[2, 3] * 0.75 * 0.25 + gf[2, 4] * 0.75 * 0.75
               + gf[3, 3] * 0.25 * 0.25 + gf[3, 4] * 0.25 * 0.75)
    np.testing.assert_allclose(sx[0].numpy(), np.array(want, np.float32), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(sy.numpy(), -sx.numpy())


@functools.lru_cache(maxsize=None)
def _describe_inputs():
    cfg = JConfig(height=96, width=128, max_keypoints=128)
    img = fixtures.random_texture(96, 128, seed=3)
    pyr = jpyramid.build_pyramid(jnp.asarray(img[None]), cfg)
    grads = jorient.gradient_stack(pyr[0].gauss, cfg)
    rng = np.random.default_rng(1)
    K = 40
    y = rng.uniform(6, 90, (1, K)).astype(np.float32)
    x = rng.uniform(6, 122, (1, K)).astype(np.float32)
    sig = rng.uniform(1.7, 3.1, (1, K)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, (1, K)).astype(np.float32)
    gl = rng.integers(1, cfg.dog_levels + 1, (1, K)).astype(np.int32)
    return cfg, grads, (y, x, sig, th, gl)


@pytest.mark.parametrize("unnormalized", [False, True])
def test_compute_descriptors_matches_reference(unnormalized):
    jcfg, grads, kp = _describe_inputs()
    jcfg = jcfg.replace(unnormalized=unnormalized)
    ref = np.asarray(jdescribe.compute_descriptors(grads, *map(jnp.asarray, kp), jcfg,
                                                   sampler="xla")).astype(int)
    tg = orient.GradStack(gx=to_torch(grads.gx), gy=to_torch(grads.gy), h=grads.h, w=grads.w)
    cfg = SiftConfig(height=96, width=128, max_keypoints=128, unnormalized=unnormalized)
    got = describe.compute_descriptors(tg, *map(torch.from_numpy, kp), cfg, chunk=16)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(int) - ref)
    assert d.max() <= 1
    assert ref.max() > 0


def test_bin_chunk_wrap_edge_keeps_last_bin():
    """`_bin_chunk` keeps clip(floor(ob), 0, NB-1): an angle that rounds to
    2π puts its weight on bin NB-1, unlike `_bin_chunk_fast`."""
    jcfg, cfg = JConfig(), SiftConfig()
    G2, NB = cfg.descriptor_grid ** 2, cfg.descriptor_bins
    sgx = np.ones((1, 2, G2), np.float32)
    sgy = np.full((1, 2, G2), -1e-9, np.float32)
    sgy[0, 1] = 1e-3
    th = np.zeros((1, 2), np.float32)
    raw = describe._bin_chunk(torch.from_numpy(sgx), torch.from_numpy(sgy),
                              torch.from_numpy(th), cfg).numpy().reshape(2, 16, NB)
    ref = np.asarray(jdescribe._bin_chunk(jnp.asarray(sgx), jnp.asarray(sgy),
                                          jnp.asarray(th), jcfg)).reshape(2, 16, NB)
    np.testing.assert_allclose(raw, ref, rtol=2e-5, atol=1e-7)
    assert raw[0, :, NB - 1].sum() > 0 and not raw[0, :, : NB - 1].any()
    assert raw[1, :, 0].sum() > 0


@pytest.mark.parametrize("first_octave", [0, -1])
def test_describe_at_keypoints_matches_reference(first_octave):
    img = fixtures.random_texture(80, 96, seed=9)
    jcfg = JConfig(height=80, width=96, max_keypoints=128, first_octave=first_octave)
    f = extract_features_jit(jnp.asarray(img[None]), jcfg)
    keys = keypoints_from_reference(f)
    keys = np.concatenate([keys, _edge_keypoints(80, 96, first_octave, jcfg.octaves),
                           [[40.0, 30.0, -2.0, 0.0], [40.0, 30.0, 500.0, 1.0]]])
    keys = keys.astype(np.float32)                     # last two: no valid octave
    ref = j_describe_at_keypoints(jnp.asarray(img[None]), jnp.asarray(keys[None]), jcfg)
    cfg = SiftConfig(height=80, width=96, max_keypoints=128, first_octave=first_octave)
    got = redetect.describe_at_keypoints(torch.from_numpy(img[None]),
                                         torch.from_numpy(keys[None]), cfg)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.octave.numpy(), np.asarray(ref.octave))
    assert not got.mask[0, -2:].any() and bool(got.mask[0, :-2].all())
    d = np.abs(got.desc.numpy().astype(int) - np.asarray(ref.desc).astype(int))
    assert d.max() <= 1
    assert int(got.mask.sum()) > 20


def _edge_keypoints(h, w, first_octave, octaves, sigma0=1.6):
    """Per octave, keypoints of that octave's scale at the image's corners,
    edges and just outside them, their grids leaving the image."""
    keys = []
    for o in range(octaves):
        sig = sigma0 * 2.0 ** (o + first_octave) * 1.3
        for x, y in ((0, 0), (w - 1, h - 1), (w - 0.5, 0.25), (-0.75, h / 2), (w / 2, h - 0.01)):
            keys.append([x, y, sig, 0.4 * o + 0.3])
    return np.array(keys, np.float32)


def test_sampler_skip_rule_and_shared_buffer():
    """plane < 0 skips a keypoint: its rows keep the buffer's bytes; the
    other rows equal the one-shot call's, and two calls with disjoint live
    rows fill one buffer as one call would."""
    gx, gy, plane, py, px = (to_torch(a) if not isinstance(a, np.ndarray) else torch.from_numpy(a)
                             for a in _sampler_inputs(False))
    one = desc_sampler.sample_gradients(gx, gy, plane, py, px)
    skip = torch.arange(plane.shape[0]) % 3 == 1
    fill = torch.full_like(py, float("nan")), torch.full_like(py, -7.0)
    out = desc_sampler.sample_gradients(gx, gy, torch.where(skip, -1, plane), py, px,
                                        out=tuple(f.clone() for f in fill))
    for o, f, r in zip(out, fill, one):
        assert torch.equal(o[skip].view(torch.int32), f[skip].view(torch.int32))
        assert torch.equal(o[~skip].view(torch.int32), r[~skip].view(torch.int32))
    desc_sampler.sample_gradients(gx, gy, torch.where(skip, plane, -1), py, px, out=out)
    for o, r in zip(out, one):
        assert torch.equal(o.view(torch.int32), r.view(torch.int32))
    none = desc_sampler.sample_gradients(gx, gy, torch.full_like(plane, -1), py, px)
    assert not any(bool(t.any()) for t in none)


def _per_octave_pattern(images, keypoints, cfg):
    """describe_at_keypoints as it was: every octave describes the whole
    list, in 512-keypoint chunks, with its own scale, and keeps its rows."""
    x, y, sig, th = (keypoints[..., i] for i in range(4))
    S, G = cfg.dog_levels, cfg.descriptor_grid
    B, K = x.shape
    pyr = pyramid.build_pyramid(images, cfg)
    ratio = redetect._log2(torch.clamp(sig, min=1e-6) / cfg.sigma0) - cfg.first_octave
    oct_f = torch.floor(ratio)
    octave = oct_f.clamp(0, cfg.octaves - 1).to(torch.int32)
    valid = (sig > 0) & (oct_f >= 0) & (oct_f < cfg.octaves)
    desc = torch.zeros((B, K, 128), dtype=torch.uint8)
    shift = 0.5 if cfg.lowe_origin else 0.0
    for o in range(cfg.octaves):
        scale = cfg.octave_scale(o)
        xo, yo = x / scale - shift, y / scale - shift
        sl = torch.clamp(sig / scale, cfg.sigma0 * 0.5, cfg.sigma0 * 4.0)
        lvl = torch.round(S * redetect._log2(torch.clamp(sl, min=1e-6) / cfg.sigma0))
        lvl = lvl.clamp(1, S).to(torch.int32) - 1
        g = orient.gradient_stack(pyr[o].gauss, cfg)
        Hp, Wp = g.gx.shape[-2:]
        raws = []
        for i in range(0, K, 512):
            c = slice(i, i + 512)
            C = xo[:, c].shape[1]
            py, px = describe._sample_coords(yo[:, c], xo[:, c], sl[:, c], th[:, c], cfg)
            inb = (px >= 0) & (px <= g.w - 1) & (py >= 0) & (py <= g.h - 1)
            plane = (torch.arange(B, dtype=torch.int32)[:, None] * S + lvl[:, c]).reshape(-1)
            sx, sy = desc_sampler.sample_gradients(
                g.gx.reshape(B * S, Hp, Wp), g.gy.reshape(B * S, Hp, Wp), plane,
                py.reshape(B * C, G * G).contiguous(), px.reshape(B * C, G * G).contiguous())
            sx = (sx.reshape(B, C, G, G) * inb).reshape(B, C, G * G)
            sy = (sy.reshape(B, C, G, G) * inb).reshape(B, C, G * G)
            raws.append(describe._bin_chunk(sx, sy, th[:, c], cfg))
        d = describe.finalize_descriptors(torch.cat(raws, 1), cfg)
        desc = torch.where(((octave == o) & valid)[..., None], d, desc)
    return octave, valid, desc


@pytest.mark.parametrize("first_octave", [0, -1])
def test_describe_at_keypoints_bits_of_per_octave_pattern(first_octave):
    """600 keypoints (two binning chunks) on two frames: the reference's
    extraction's keypoints, every octave's edges, scales at the octave
    boundaries, invalid sigmas (0, negative, too large)."""
    imgs = np.stack([fixtures.random_texture(72, 88, seed=s) for s in (4, 5)])
    cfg = SiftConfig(height=72, width=88, max_keypoints=256, first_octave=first_octave)
    rng = np.random.default_rng(first_octave + 3)
    keys = []
    for _ in range(2):
        k = np.concatenate([
            _edge_keypoints(72, 88, first_octave, cfg.octaves),
            np.stack([rng.uniform(-5, 93, 540), rng.uniform(-5, 77, 540),
                      cfg.sigma0 * 2.0 ** rng.uniform(first_octave - 0.5, 4.5, 540),
                      rng.uniform(0, 2 * np.pi, 540)], 1),
            [[30, 30, cfg.sigma0 * 2.0 ** (o + first_octave), 1.0] for o in range(cfg.octaves)],
            [[30, 30, s, 0.5] for s in (0.0, -3.0, 1e4)]])
        keys.append(k[:600])
    keys = torch.from_numpy(np.stack(keys).astype(np.float32))
    images = torch.from_numpy(imgs)
    got = redetect.describe_at_keypoints(images, keys, cfg)
    octave, valid, desc = _per_octave_pattern(images, keys, cfg)
    assert torch.equal(got.mask, valid) and torch.equal(got.octave[valid], octave[valid])
    assert torch.equal(got.desc, desc)
    assert 0 < int(valid.sum()) < valid.numel() and len(set(octave[valid].tolist())) == cfg.octaves
