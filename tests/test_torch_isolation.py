"""The port stands alone: it imports with JAX and the reference blocked, and
without nvcc building a kernel raises instead of falling back."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import pyramid
from siftgpu_tpu_torch.ops import (_build, desc_sampler, detect_scores, grad_stencil, kp_engine,
                                   match_kernel, pyramid_kernel, small_eig)

KERNEL_NAMES = ["detect_scores", "grad_stencil", "orient_sample", "match_best2",
                "match_best2_gated", "sample_gradients", "blur_octave_fused", "small_eig"]
REPO = Path(__file__).resolve().parent.parent


def test_imports_without_jax_or_reference():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "siftgpu_tpu"):
            sys.modules[name] = None          # any import of them now fails
        import siftgpu_tpu_torch
        from siftgpu_tpu_torch import bounds, convert
        from siftgpu_tpu_torch.core import (config, flags, graphs, image, native, precision,
                                            scalespace)
        from siftgpu_tpu_torch.frontend import (describe, detect, extract, fused, match, orient,
                                                pyramid, redetect)
        from siftgpu_tpu_torch.geometry import align, epipolar, pose
        from siftgpu_tpu_torch.ops import (_build, desc_sampler, detect_scores, grad_stencil,
                                           kp_engine, match_kernel, pyramid_kernel, small_eig)
        from siftgpu_tpu_torch.optim import ba, pnp, pose_graph
        from siftgpu_tpu_torch.parallel import (comm, dist_ba, dist_pose_graph, dp, dryrun,
                                                resident_ba, sequence, spatial)
        from siftgpu_tpu_torch.oracle import fixtures
        from siftgpu_tpu_torch.frontend.orient import compute_orientations
        from siftgpu_tpu_torch.pipeline import (api, checkpoint, cli, metrics, profile, server,
                                                siftio, slam, twoview, viz)
        import bench_torch
        import ransac_witness                 # and chip_smoke, which it imports
        assert not any(m == "jax" or m.startswith(("jax.", "siftgpu_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print(sorted(_build.KERNELS))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(sorted(KERNEL_NAMES))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    for kern in _build.KERNELS.values():
        monkeypatch.setattr(kern, "_lib", None)
        before = kern.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kern.lib()
        assert kern.launches == before


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_non_cpu_tensor_never_takes_the_plain_version(name):
    """A tensor that is not on the CPU goes to the kernel route, whose checks
    refuse anything but a CUDA tensor: no silent plain fallback."""
    cfg = SiftConfig(height=32, width=32)
    meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
    calls = {
        "detect_scores": lambda: detect_scores.detect_scores(meta(1, 5, 32, 32), cfg),
        "grad_stencil": lambda: grad_stencil.grad_stencil(meta(1, 6, 32, 32), 3, 35, 35),
        "orient_sample": lambda: kp_engine.orient_sample(
            meta(3, 35, 35, dt=torch.bfloat16), meta(3, 35, 35, dt=torch.bfloat16),
            meta(4, dt=torch.int32), meta(4), meta(4), meta(4), cfg,
            meta(4, dt=torch.bool), 32, 32),
        "match_best2": lambda: match_kernel.match_best2(
            meta(1, 8, 128, dt=torch.uint8), meta(1, 8, 128, dt=torch.uint8),
            meta(1, 8), meta(1, 8), meta(1, 8, dt=torch.bool), meta(1, 8, dt=torch.bool)),
        "match_best2_gated": lambda: match_kernel.match_best2_gated(
            meta(1, 8, 128, dt=torch.uint8), meta(1, 8, 128, dt=torch.uint8),
            meta(1, 8), meta(1, 8), meta(1, 8, dt=torch.bool), meta(1, 8, dt=torch.bool),
            "hf", meta(1, 7, 8), meta(1, 5, 8), 9.0, 2.0),
        "sample_gradients": lambda: desc_sampler.sample_gradients(
            meta(3, 35, 35, dt=torch.bfloat16), meta(3, 35, 35, dt=torch.bfloat16),
            meta(4, dt=torch.int32), meta(4, 256), meta(4, 256)),
        "blur_octave_fused": lambda: pyramid_kernel.blur_octave_fused(
            meta(2, 32, 32), [cfg.gaussian_taps(float(s)) for s in cfg.incremental_sigmas()]),
        "small_eig": lambda: (small_eig.eigh_sym(meta(512, 9, 9)), small_eig.svd3(meta(3, 3))),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[name]()
    assert _build.KERNELS[name].launches == 0


@pytest.mark.parametrize("octave_impl", [None, "fused"])
def test_pyramid_on_a_non_cpu_tensor_never_takes_the_plain_chain(monkeypatch, octave_impl):
    """The pyramid's octaves of a tensor that is not on the CPU go to the
    octave kernel's route, which refuses anything but a CUDA tensor; the
    plain chain is not run.  Only octave_impl="xla" asks for the chain."""
    def chain(*args):
        raise AssertionError("the plain chain ran for a non-CPU tensor")

    monkeypatch.setattr(pyramid_kernel, "blur_octave_fused_plain", chain)
    cfg = SiftConfig(height=32, width=32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pyramid.build_pyramid(torch.empty(1, 32, 32, device="meta"), cfg, octave_impl)
    assert _build.KERNELS["blur_octave_fused"].launches == 0
