"""Port gradient stack and fused orientation + sampling vs the reference's CPU
route, fed the reference's pyramid and keypoints.

  - `gradient_stack`: bit-identical bf16 planes;
  - the plain `orient_sample` against `orient.compute_orientations` plus
    `describe._sample_coords` / `_bilerp_xla` · inb, on the budgets the
    reference holds its own fused kernel to (tests/test_kp_engine.py):
    validity agreement > 0.99, theta q98 < 1e-2 and max < 0.2, and sampled
    gradients within 1e-5 where theta agrees to 1e-6.  The two differ in
    summation order and in XLA's FMA contraction, so a near-tie peak may
    flip and angles move in the last bits.
"""

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
from siftgpu_tpu_torch.frontend import orient
from siftgpu_tpu_torch.ops import kp_engine
from siftgpu_tpu_torch.oracle import fixtures


@pytest.fixture(scope="module", params=[(120, 160, 5), (96, 128, 11)], ids=str)
def case(request):
    h, w, seed = request.param
    kw = dict(height=h, width=w, max_keypoints=256)
    jcfg, cfg = JConfig(**kw), SiftConfig(**kw)
    imgs = np.stack([fixtures.random_texture(h, w, seed=seed, smooth=3),
                     fixtures.random_texture(h, w, seed=seed + 1, smooth=3)])
    oc = jpyramid.build_pyramid(jnp.asarray(imgs), jcfg)[0]
    kp = jdetect.detect_octave(oc, jcfg, 128)
    grads = jorient.gradient_stack(oc.gauss, jcfg, impl="xla")
    return jcfg, cfg, oc, kp, grads


def test_gradient_stack_bit_identical(case):
    jcfg, cfg, oc, _, grads = case
    got = orient.gradient_stack(convert.to_torch(oc.gauss), cfg)
    assert (got.h, got.w) == (grads.h, grads.w)
    for g, r in ((got.gx, grads.gx), (got.gy, grads.gy)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == r.shape
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(r).view(np.int16))


def test_orient_sample_matches_reference(case):
    jcfg, cfg, _, kp, grads = case
    B, K = kp.y.shape
    S, Hp, Wp = grads.gx.shape[1:]
    n = cfg.max_orientations
    G2 = cfg.descriptor_grid ** 2

    theta_ref, valid_ref = jorient.compute_orientations(grads, kp, jcfg)
    th_r = np.asarray(theta_ref).reshape(B * K, n)
    v_r = np.asarray(valid_ref).reshape(B * K, n)

    plane = (np.arange(B)[:, None] * S + np.asarray(kp.grad_level) - 1).reshape(-1)
    t = lambda a: convert.to_torch(a).reshape(-1)
    mask = t(kp.mask)
    th, haspk, sgx, sgy = kp_engine.orient_sample(
        convert.to_torch(grads.gx).reshape(B * S, Hp, Wp),
        convert.to_torch(grads.gy).reshape(B * S, Hp, Wp),
        torch.from_numpy(plane.astype(np.int32)), t(kp.y), t(kp.x), t(kp.sigma),
        cfg, mask, grads.h, grads.w,
    )
    th, haspk = th.numpy(), haspk.numpy()
    valid = haspk.copy()
    valid[:, 0] = mask.numpy()
    assert int(mask.sum()) > 20
    assert (valid == v_r).mean() > 0.99

    both = valid & v_r
    dth = np.abs(th[both] - th_r[both])
    dth = np.minimum(dth, 2 * np.pi - dth)
    assert np.quantile(dth, 0.98) < 1e-2
    assert dth.max() < 0.2

    # reference samples at the reference's angles, slot by slot
    def dup(a):
        return jnp.repeat(a[..., None], n, axis=-1).reshape(B, K * n)

    th2 = jnp.asarray(th_r.reshape(B, K * n))
    py, px = jdescribe._sample_coords(dup(kp.y), dup(kp.x), dup(kp.sigma), th2, jcfg)
    inb = (px >= 0) & (px <= grads.w - 1) & (py >= 0) & (py <= grads.global_h - 1)
    rx, ry = jdescribe._bilerp_xla(grads, py, px, dup(kp.grad_level) - 1)
    rx = np.asarray(rx * inb).reshape(B * K, n, G2)
    ry = np.asarray(ry * inb).reshape(B * K, n, G2)
    close = both & (np.abs(th - th_r) <= 1e-6)
    assert close[:, 0].mean() > 0.5
    np.testing.assert_allclose(sgx.numpy().reshape(B * K, n, G2)[close], rx[close], rtol=0, atol=1e-5)
    np.testing.assert_allclose(sgy.numpy().reshape(B * K, n, G2)[close], ry[close], rtol=0, atol=1e-5)
    # slots that are not sampled are zero
    unsampled = ~valid
    assert not sgx.numpy().reshape(B * K, n, G2)[unsampled].any()


def test_exp_window_matches_reference_polynomial():
    from siftgpu_tpu.ops import kp_engine as jkp

    x = np.linspace(-6.0, 0.0, 1001).astype(np.float32)
    np.testing.assert_allclose(kp_engine.exp_window(torch.from_numpy(x)).numpy(),
                               np.asarray(jkp.exp_window(jnp.asarray(x))), rtol=0, atol=2e-7)
    assert kp_engine.EXPW == jkp._EXPW


def _reference_orientations(d, jcfg):
    """The reference's `orient.compute_orientations` on the planes and
    keypoints of an `orient_windows` / `orient_keypoints` dict, as one frame
    whose S levels are the planes."""
    from siftgpu_tpu.frontend.detect import OctaveKeypoints

    P, h, w = d["gx"].shape
    grads = jorient.GradStack(jnp.asarray(d["gx"])[None].astype(jnp.bfloat16),
                              jnp.asarray(d["gy"])[None].astype(jnp.bfloat16),
                              h, w, jnp.int32(0), h)
    j = lambda a: jnp.asarray(a)[None]
    zeros = np.zeros_like(d["y"])
    kp = OctaveKeypoints(j(d["y"]), j(d["x"]), j(zeros), j(d["plane"] + 1), j(d["sigma"]),
                         j(zeros), j(d["mask"]))
    theta, valid = jorient.compute_orientations(grads, kp, jcfg)
    return np.asarray(theta)[0], np.asarray(valid)[0]


@pytest.mark.parametrize("kind", ["flat", "tie", "ratio", "below", "n9-masked-corners"])
def test_orient_sample_built_windows_match_reference(kind):
    """Histograms built to be exact, through the plain version and the
    reference: an empty histogram (no peak: theta 0 in slot 0), two equal
    peaks (the lower bin first), a second peak at exactly peak_ratio * max
    (kept: >=) and one bf16 step below it (dropped); and N = 9 random
    keypoints with masked rows and the four plane corners.  These fix the
    tie rules the card's kernel is held to."""
    cfg, jcfg = SiftConfig(), JConfig()
    if kind.startswith("n9"):
        d = fixtures.orient_keypoints(9, seed=3, masked=0.3, corners=True)
    else:
        d = fixtures.orient_windows((kind,))
    t = torch.from_numpy
    P, h, w = d["gx"].shape
    th, haspk, sgx, sgy = kp_engine.orient_sample(
        t(d["gx"]).to(torch.bfloat16), t(d["gy"]).to(torch.bfloat16), t(d["plane"]),
        t(d["y"]), t(d["x"]), t(d["sigma"]), cfg, t(d["mask"]), h, w)
    th, haspk = th.numpy(), haspk.numpy()
    valid = haspk.copy()
    valid[:, 0] = d["mask"]
    th_r, v_r = _reference_orientations(d, jcfg)
    np.testing.assert_array_equal(valid, v_r)
    np.testing.assert_allclose(th[valid], th_r[valid], rtol=0, atol=1e-5)
    two_pi, nb = 2 * np.pi, cfg.orientation_bins
    if kind == "flat":
        assert not haspk.any() and not th.any() and not sgx.numpy()[:, 256:].any()
    elif kind in ("tie", "ratio"):
        assert haspk[0].tolist() == [True, True]
        np.testing.assert_allclose(th[0], [two_pi * 0.5 / nb, two_pi * 18.5 / nb], atol=1e-6)
    elif kind == "below":
        assert haspk[0].tolist() == [True, False] and th[0, 1] == 0.0
    else:
        masked = ~d["mask"]
        assert masked.any() and d["mask"].any()
        for out in (th, haspk, sgx.numpy(), sgy.numpy()):
            assert not out[masked].any()
