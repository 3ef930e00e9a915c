"""bench_torch.py's 1080p and 4k sections on the CPU, at small sizes: their
keypoint caps bind, kernels 1-3 and the octave kernel are held against
their plain versions, and every gate raises on bad output (a cap that does
not bind, a kernel off its plain version, a call that does not repeat: a
replay of the captured extraction off the eager call's bits)."""

import pytest
import torch

import bench_torch as bt
from siftgpu_tpu_torch import extract_features
from siftgpu_tpu_torch.ops import detect_scores, kp_engine, pyramid_kernel
from torch_threads import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["1080p", "4k"])
def test_frame_section_small(name):
    out = bt.SECTION_FNS[name](CPU, bt.SMALL[name], bt.SEEDS[name])
    assert out["kp"] == bt.SMALL[name].k
    # kernels 1-3 and the octave kernel held against their plain versions
    assert set(out["max_abs_err"]) == {"blur_octave_fused", "detect_scores", "grad_stencil",
                                       "orient_sample"}
    assert out["reps_s"] is None and out["events"] is None


def test_frame_section_raises_where_the_cap_does_not_bind():
    with pytest.raises(AssertionError, match="does not bind"):
        bt.section_1080p(CPU, bt.SMALL["1080p"]._replace(k=4096), 7)


def _off(fn, change):
    return lambda *a, **kw: change(fn(*a, **kw))


FAULTS = {   # a kernel's wrapper off its plain version, and what says so
    "octave": (pyramid_kernel, "blur_octave_fused", lambda o: (o[0], o[1] + 1e-3),
               "blur_octave_fused .* max abs err"),
    "detect": (detect_scores, "detect_scores", lambda o: (o[0] + 1.0,) + tuple(o[1:]),
               "score plane 0 differs"),
    "orient": (kp_engine, "orient_sample", lambda o: (o[0] + 0.3,) + tuple(o[1:]),
               "theta q98"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_frame_section_raises_on_a_kernel_off_its_plain_version(monkeypatch, fault):
    mod, name, change, msg = FAULTS[fault]
    monkeypatch.setattr(mod, name, _off(getattr(mod, name), change))
    with pytest.raises(AssertionError, match=msg):
        bt.section_4k(CPU, bt.SMALL["4k"], 9)


def test_frame_section_raises_on_a_call_that_does_not_repeat(monkeypatch):
    calls = []

    def drifting(images, cfg):
        f = extract_features(images, cfg)
        calls.append(1)
        return f._replace(x=f.x + 1e-3 * (len(calls) - 1))

    # the timed entry point's first call has the eager call's bits, its
    # second drifts
    monkeypatch.setattr(bt, "extract_features_jit", drifting)
    with pytest.raises(AssertionError, match="second replay is not bit-identical"):
        bt.section_4k(CPU, bt.SMALL["4k"], 9)
