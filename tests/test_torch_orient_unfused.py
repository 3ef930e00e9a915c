"""The port's unfused orientation route (`frontend/orient.py::
compute_orientations`, `_hist_onehot`) against the reference's, fed the
reference's gradient stack and keypoints (converted with `convert.py`):

  - on real keypoints of two 120x160 frames: the budget of
    tests/test_kp_engine.py:51-76 (validity agreement > 0.99, theta q98 <
    1e-2, max < 0.2), and in fact equal validity and angles within 1e-4
    (the same algorithm in f32; XLA contracts some products into FMAs);
  - on built histograms (an empty one, an exact tie, a second peak at
    exactly 0.8 max and one just below, masked keypoints and the plane
    corners): the same validity and theta within 1e-5;
  - against the fused route's plain version (`kp_engine.orient_sample_plain`)
    on the same keypoints, on the same budget;
  - `_hist_onehot` against the reference's on random weights and bins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import detect as jdetect
from siftgpu_tpu.frontend import orient as jorient
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu.frontend.detect import OctaveKeypoints as JKeypoints
from siftgpu_tpu_torch import convert
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import orient
from siftgpu_tpu_torch.frontend.detect import OctaveKeypoints
from siftgpu_tpu_torch.ops import kp_engine
from siftgpu_tpu_torch.oracle import fixtures


def _port_stack(grads):
    return orient.GradStack(gx=convert.to_torch(grads.gx), gy=convert.to_torch(grads.gy),
                            h=grads.h, w=grads.w)


def _angle_diff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture(scope="module")
def case():
    kw = dict(height=120, width=160, max_keypoints=256)
    jcfg, cfg = JConfig(**kw), SiftConfig(**kw)
    imgs = np.stack([fixtures.random_texture(120, 160, seed=s, smooth=3) for s in (5, 6)])

    @jax.jit       # one program: op-by-op dispatch would take ~30 s to compile
    def reference(x):
        oc = jpyramid.build_pyramid(x, jcfg)[0]
        kp = jdetect.detect_octave(oc, jcfg, 128)
        grads = jorient.gradient_stack(oc.gauss, jcfg, impl="xla")
        return (kp, grads.gx, grads.gy) + jorient.compute_orientations(grads, kp, jcfg)

    kp, gx, gy, theta, valid = reference(jnp.asarray(imgs))
    grads = jorient.GradStack(gx, gy, 120, 160, jnp.int32(0), 120)
    return cfg, kp, grads, np.asarray(theta), np.asarray(valid)


def test_real_keypoints_match_reference(case):
    cfg, kp, grads, th_r, v_r = case
    th, valid = orient.compute_orientations(_port_stack(grads), convert.tree_to_torch(
        kp, OctaveKeypoints), cfg)
    th, valid = th.numpy(), valid.numpy()
    assert th.shape == th_r.shape == (2, 128, cfg.max_orientations)
    assert int(np.asarray(kp.mask).sum()) > 20
    assert (valid == v_r).mean() > 0.99
    both = valid & v_r
    dth = _angle_diff(th[both], th_r[both])
    assert np.quantile(dth, 0.98) < 1e-2 and dth.max() < 0.2
    # the same f32 algorithm: in fact equal validity, every angle within 1e-4
    np.testing.assert_array_equal(valid, v_r)
    assert _angle_diff(th, th_r).max() < 1e-4


@pytest.mark.parametrize("kind", ["flat", "tie", "ratio", "below", "n9-masked-corners"])
def test_built_windows_match_reference(kind):
    """The histograms of tests/test_torch_orient.py's built windows."""
    cfg, jcfg = SiftConfig(), JConfig()
    if kind.startswith("n9"):
        d = fixtures.orient_keypoints(9, seed=3, masked=0.3, corners=True)
    else:
        d = fixtures.orient_windows((kind,))
    P, h, w = d["gx"].shape
    jgrads = jorient.GradStack(jnp.asarray(d["gx"])[None].astype(jnp.bfloat16),
                               jnp.asarray(d["gy"])[None].astype(jnp.bfloat16),
                               h, w, jnp.int32(0), h)
    zeros = np.zeros_like(d["y"])
    fields = (d["y"], d["x"], zeros, d["plane"] + 1, d["sigma"], zeros, d["mask"])
    # eager, as tests/test_torch_orient.py: under jit XLA contracts the
    # peak-ratio product into an FMA and the exact 0.8 case moves
    th_r, v_r = jorient.compute_orientations(
        jgrads, JKeypoints(*(jnp.asarray(a)[None] for a in fields)), jcfg)
    th, valid = orient.compute_orientations(
        _port_stack(jgrads), OctaveKeypoints(*(torch.from_numpy(np.asarray(a))[None]
                                               for a in fields)), cfg)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(v_r))
    np.testing.assert_allclose(th.numpy(), np.asarray(th_r), rtol=0, atol=1e-5)
    if kind == "flat":
        assert not th.any() and valid[..., 1:].sum() == 0


def test_matches_the_fused_plain_version(case):
    cfg, kp, grads, _, _ = case
    B, K = kp.y.shape
    S, Hp, Wp = grads.gx.shape[1:]
    pkp = convert.tree_to_torch(kp, OctaveKeypoints)
    stack = _port_stack(grads)
    th, valid = orient.compute_orientations(stack, pkp, cfg)
    plane = (torch.arange(B)[:, None] * S + pkp.grad_level - 1).reshape(-1).to(torch.int32)
    flat = lambda t: t.reshape(-1)
    th_f, haspk, _, _ = kp_engine.orient_sample_plain(
        stack.gx.reshape(B * S, Hp, Wp), stack.gy.reshape(B * S, Hp, Wp), plane,
        flat(pkp.y), flat(pkp.x), flat(pkp.sigma), cfg, flat(pkp.mask), grads.h, grads.w)
    v_f = haspk.numpy().copy()
    v_f[:, 0] = flat(pkp.mask).numpy()
    v = valid.reshape(B * K, -1).numpy()
    assert (v == v_f).mean() > 0.99
    both = v & v_f
    dth = _angle_diff(th.reshape(B * K, -1).numpy()[both], th_f.numpy()[both])
    assert np.quantile(dth, 0.98) < 1e-2 and dth.max() < 0.2


def test_hist_onehot_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.random((2, 5, 300)).astype(np.float32)
    bins = rng.integers(0, 36, (2, 5, 300)).astype(np.int32)
    got = orient._hist_onehot(torch.from_numpy(w), torch.from_numpy(bins).long(), 36)
    ref = np.asarray(jorient._hist_onehot(jnp.asarray(w), jnp.asarray(bins), 36))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    want = np.zeros((2, 5, 36))
    for b in range(2):
        for k in range(5):
            np.add.at(want[b, k], bins[b, k], w[b, k])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
