"""The slab arguments of kernels 1-3 (a spatial slab's place in the frame)
in the port's plain versions, against the reference's XLA routes on the
CPU, fed the reference's pyramid:

  - kernel 1, `owned_rows=(lo, hi)`: pooled scores and score planes bit-
    identical to `_octave_scores(..., scores_impl="xla")` /
    `_dense_scores_xla` (as tests/test_pallas_ops.py:100-130 holds the
    Pallas kernel), records within tests/test_torch_detect.py's budget at
    the candidates, no candidate outside [lo, hi), `detect_octave` equal;
    owned rows that cut a 16 x 64 tile, lo = 0 / hi = H, none;
  - kernel 2, `y0` / `global_h`: the gradient stack bit-identical to
    `gradient_stack(..., impl="xla")` (tests/test_pallas_ops.py:159-167),
    for a negative y0, global_h inside the slab and a slab that reaches
    the image's bottom (its one-sided edge row doubled, as the reference);
  - kernel 3, `y0g` / `global_h`: a slab cut from a taller image
    (tests/test_kp_engine.py:80-126): the fused route's plain version
    against the reference's unfused route within that test's bounds, the
    unfused orientation within tests/test_torch_orient_unfused.py's, the
    unfused sampler's descriptors within 1 step; once with the slab at
    global row 16 of a 112-row image, once with the image's rows 20..89
    inside the slab, so that windows and samples leave it at both edges.

Without slab arguments every plane equals the reference's default bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import describe as jdescribe
from siftgpu_tpu.frontend import detect as jdetect
from siftgpu_tpu.frontend import orient as jorient
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu_torch import convert
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import describe, detect, fused, orient
from siftgpu_tpu_torch.frontend.detect import OctaveKeypoints
from siftgpu_tpu_torch.frontend.pyramid import Octave
from siftgpu_tpu_torch.ops import detect_scores
from siftgpu_tpu_torch.oracle import fixtures

SIZES = [(64, 96), (57, 130)]


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def pyr(request):
    h, w = request.param
    kw = dict(height=h, width=w, max_keypoints=256)
    jcfg, cfg = JConfig(**kw), SiftConfig(**kw)
    img = fixtures.random_texture(h, w, seed=3, smooth=2)[None]
    jpyr = jax.jit(lambda x: jpyramid.build_pyramid(x, jcfg)[:2])(jnp.asarray(img))
    return jcfg, cfg, jpyr, [convert.tree_to_torch(oc, Octave) for oc in jpyr]


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_scores_with_owned_rows_match_reference(pyr):
    jcfg, cfg, jpyr, tpyr = pyr
    n_cand = 0
    for joc, toc in zip(jpyr, tpyr):
        Hd = toc.dog.shape[2]
        for owned in (None, (5, Hd - 7), (3, 19), (0, Hd), (Hd - 20, Hd)):
            ref = [np.asarray(a) for a in jdetect._dense_scores_xla(joc.dog, jcfg, owned)]
            got = [a.numpy() for a in detect_scores.detect_scores(toc.dog, cfg, owned)]
            np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
            np.testing.assert_array_equal(_bits(got[1]), _bits(ref[1]))
            rb = jdetect._octave_scores(joc.dog, jcfg, owned, scores_impl="xla")[0]
            gb = detect._octave_scores(toc.dog, cfg, owned)[0]
            np.testing.assert_array_equal(_bits(gb.numpy()), _bits(rb))
            lo, hi = owned or (0, Hd)
            for plane in ref[:2]:     # candidates: rows in [lo, hi), records in budget
                b, s, yp, x = np.nonzero(plane > 0)
                y = 2 * yp + ((plane[b, s, yp, x].view(np.int32) & 3) >> 1)
                assert ((y >= lo) & (y < hi)).all()
                n_cand += len(b)
                for r, g in zip(ref[2:], got[2:]):
                    rv, gv = r[b, s, y, x], g[b, s, y, x]
                    ulp = np.abs(rv.view(np.int32).astype(np.int64) - gv.view(np.int32))
                    assert ((ulp <= 4) | (np.abs(rv - gv) <= 1e-6)).all()
            whole = detect_scores.detect_scores(toc.dog, cfg)
            if owned in (None, (0, Hd)):   # the defaults: today's whole-volume bits
                for a, g in zip(whole, got):
                    np.testing.assert_array_equal(_bits(a.numpy()), _bits(g))
            kr = jdetect.detect_octave(joc, jcfg, 64, owned_rows=owned, scores_impl="xla")
            kg = detect.detect_octave(toc, cfg, 64, owned_rows=owned)
            m = np.asarray(kr.mask)
            np.testing.assert_array_equal(kg.mask.numpy(), m)
            for f in ("y", "x", "sigma"):
                np.testing.assert_allclose(getattr(kg, f).numpy()[m], np.asarray(getattr(kr, f))[m],
                                           rtol=0, atol=1e-5, err_msg=f)
    assert n_cand > 20


def test_gradients_with_slab_factor_match_reference(pyr):
    jcfg, cfg, jpyr, tpyr = pyr
    for joc, toc in zip(jpyr, tpyr):
        h = toc.gauss.shape[2]
        # none; y0 < 0 (global row 0 inside); global_h inside the slab; the
        # slab reaching the image's bottom; both image edges inside
        for y0, gh in ((None, None), (-3, h + 10), (5, h - 2), (7, h + 7), (-3, h - 6)):
            ref = jorient.gradient_stack(joc.gauss, jcfg, y0=None if y0 is None else jnp.int32(y0),
                                         global_h=gh, impl="xla")
            got = orient.gradient_stack(toc.gauss, cfg, y0=y0, global_h=gh)
            assert (got.h, got.w, got.y0, got.image_h) == (h, ref.w, y0 or 0, gh or h)
            for r, g in ((ref.gx, got.gx), (ref.gy, got.gy)):
                r = np.asarray(r.astype(jnp.float32))
                assert r.shape == tuple(g.shape)
                np.testing.assert_array_equal(g.to(torch.float32).numpy(), r)


@pytest.fixture(scope="module")
def slab():
    """The octave 0 of a 96x160 frame as a slab: its stages through the
    reference's unfused route, run as one program for both placements
    (y0, global_h): (16, 112), the slab at row 16 reaching the image's
    bottom, and (-20, 70), the image's rows 0..69 at slab rows 20..89."""
    kw = dict(height=96, width=160, max_keypoints=64)
    jcfg, cfg = JConfig(**kw), SiftConfig(**kw)
    img = jnp.asarray(fixtures.random_texture(96, 160, seed=11, smooth=3)[None])
    n = jcfg.max_orientations

    @jax.jit
    def reference(x, y0, global_h):
        oc = jpyramid.build_pyramid(x, jcfg)[0]
        kp = jdetect.detect_octave(oc, jcfg, 64)
        grads = jorient.gradient_stack(oc.gauss, jcfg, y0=y0, global_h=global_h, impl="xla")
        theta, valid = jorient.compute_orientations(grads, kp, jcfg)
        B, K = kp.y.shape
        dup = lambda a: jnp.repeat(a[..., None], n, axis=-1).reshape(B, K * n)
        desc = jdescribe.compute_descriptors(grads, dup(kp.y), dup(kp.x), dup(kp.sigma),
                                             theta.reshape(B, K * n), dup(kp.grad_level), jcfg,
                                             sampler="xla")
        return oc.gauss, kp, theta, valid, desc

    out = {}
    for y0, gh in ((16, 112), (-20, 70)):
        gauss, kp, theta, valid, desc = reference(img, jnp.int32(y0), jnp.int32(gh))
        out[(y0, gh)] = (convert.to_torch(gauss), convert.tree_to_torch(kp, OctaveKeypoints),
                         np.asarray(theta), np.asarray(valid), np.asarray(desc))
    return cfg, out


def _angle(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("place", [(16, 112), (-20, 70)], ids=["bottom", "both-edges"])
def test_slab_orientation_and_descriptors(slab, place):
    cfg, out = slab
    gauss, kp, th_r, v_r, d_r = out[place]
    y0, gh = place
    grads = orient.gradient_stack(gauss, cfg, y0=y0, global_h=gh)
    B, K = kp.y.shape
    n = cfg.max_orientations
    dup = lambda a: a[..., None].expand(B, K, n).reshape(B, K * n)

    # the fused route's plain version against the reference's unfused route,
    # on keypoints whose support stays inside the slab's planes
    th_f, m_f, d_f = (a.numpy() for a in fused.orient_describe_fused(grads, kp, cfg))
    ky = dup(kp.y).numpy()
    inside = ky >= 33.0
    if y0 < 0:
        inside &= ky <= 96 - 33.0
    mask_r, mask_f = v_r.reshape(B, K * n) & inside, m_f & inside
    assert (mask_r == mask_f).mean() > 0.98
    both = mask_r & mask_f
    assert both.sum() > 10
    dth = _angle(th_r.reshape(B, K * n)[both], th_f[both])
    close = dth < 1e-3
    assert close.mean() > 0.9
    assert np.abs(d_r[both][close].astype(int) - d_f[both][close].astype(int)).max() <= 4

    # the unfused orientation: the same validity, angles within 1e-4
    th_u, v_u = (a.numpy() for a in orient.compute_orientations(grads, kp, cfg))
    np.testing.assert_array_equal(v_u, v_r)
    assert _angle(th_u, th_r)[v_r].max() < 1e-4

    # the unfused sampler on the reference's angles: descriptors within 1 step
    d_u = describe.compute_descriptors(grads, dup(kp.y), dup(kp.x), dup(kp.sigma),
                                       torch.from_numpy(th_r.reshape(B, K * n).copy()),
                                       dup(kp.grad_level), cfg).numpy()
    live = v_r.reshape(B, K * n)
    assert np.abs(d_u[live].astype(int) - d_r[live].astype(int)).max() <= 1
