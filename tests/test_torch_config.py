"""The port's configs equal the reference's, field for field and helper for
helper, and `convert` carries configs and arrays across."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core import config as jconfig
from siftgpu_tpu.frontend.detect import OctaveKeypoints as JKeypoints
from siftgpu_tpu_torch import convert
from siftgpu_tpu_torch.core import config as tconfig
from siftgpu_tpu_torch.frontend.detect import OctaveKeypoints as TKeypoints

CASES = [
    {},
    dict(height=120, width=160, max_keypoints=512),
    dict(height=80, width=96, max_keypoints=256, first_octave=1),
    dict(height=1088, width=1920, dog_levels=4, sigma0=1.8, max_filter_width=7),
    dict(height=64, width=64, per_octave_cap=40, num_octaves=2, max_orientations=3),
]


def _same_fields(a_cls, b_cls):
    fa = [(f.name, f.default) for f in dataclasses.fields(a_cls)]
    fb = [(f.name, f.default) for f in dataclasses.fields(b_cls)]
    assert fa == fb


def test_field_names_and_defaults():
    _same_fields(jconfig.SiftConfig, tconfig.SiftConfig)
    _same_fields(jconfig.MatchConfig, tconfig.MatchConfig)


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_derived_helpers(kw):
    j, t = jconfig.SiftConfig(**kw), tconfig.SiftConfig(**kw)
    for name in ("gauss_levels", "upsampled", "base_shape", "octaves",
                 "total_candidate_cap", "max_detect_sigma", "orient_window_radius",
                 "descriptor_grid", "descriptor_dim"):
        assert getattr(j, name) == getattr(t, name), name
    for o in range(j.octaves):
        assert j.octave_shape(o) == t.octave_shape(o)
        assert j.octave_scale(o) == t.octave_scale(o)
        assert j.octave_cap(o) == t.octave_cap(o)
    np.testing.assert_array_equal(j.level_sigmas(), t.level_sigmas())
    np.testing.assert_array_equal(j.incremental_sigmas(), t.incremental_sigmas())
    assert j.initial_blur_sigma() == t.initial_blur_sigma()
    for s in list(j.incremental_sigmas()) + [j.initial_blur_sigma()]:
        np.testing.assert_array_equal(j.gaussian_taps(float(s)), t.gaussian_taps(float(s)))
    assert dataclasses.asdict(j.replace(border=3)) == dataclasses.asdict(t.replace(border=3))


@pytest.mark.parametrize("kw", CASES[:3])
def test_convert_round_trip(kw):
    j = jconfig.SiftConfig(**kw)
    t = convert.sift_config_from_reference(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jm = jconfig.MatchConfig(max_match=77, ratio_max=0.7)
    tm = convert.match_config_from_reference(dataclasses.asdict(jm))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    with pytest.raises(ValueError):
        convert.sift_config_from_reference({**dataclasses.asdict(j), "bogus": 1})


def test_convert_arrays():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    bf = jnp.asarray(a).astype(jnp.bfloat16)
    tb = convert.to_torch(bf)
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(), np.asarray(bf.astype(jnp.float32)))
    np.testing.assert_array_equal(tb.view(torch.int16).numpy(),
                                  np.asarray(bf).view(np.int16))
    kp = JKeypoints(*(jnp.asarray(a) for _ in range(6)), mask=jnp.asarray(a > 0))
    tk = convert.tree_to_torch(kp, TKeypoints)
    assert isinstance(tk, TKeypoints) and tk.mask.dtype == torch.bool
    np.testing.assert_array_equal(tk.sigma.numpy(), a)
