"""bench_torch.py's 16k and stage-table sections on the CPU at small sizes,
and chip_smoke.py's phase 5b, which runs every section, on the CPU."""

import torch

import bench_torch as bt
import chip_smoke as cs
from torch_threads import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def test_16k_section_small():
    out = bt.section_16k(CPU, bt.SMALL["16k"], bt.SEEDS["16k"])
    assert out["permutation_recovered"] == 512 and out["matches"] == 0


def test_stages_section_small():
    out = bt.section_stages(CPU, bt.SMALL["stages"], 0)
    assert out["stages_s"] is None


def test_phase_5b_on_the_cpu():
    launches, frame_launches, errs = cs.bench_phase(CPU)
    kernels = {"detect_scores", "grad_stencil", "orient_sample", "match_best2",
               "match_best2_gated", "sample_gradients", "blur_octave_fused", "small_eig"}
    assert set(launches) == set(frame_launches) == kernels
    # the plain versions launch nothing
    assert not any(launches.values()) and not any(frame_launches.values())
    assert len(errs) == 2 and all(set(e) < kernels for e in errs)


def test_counts_are_bench_shapes_untimed():
    """Phase 5b's sizes on the card (`bench_torch.COUNTS`): bench.py's shapes
    and caps, one call a section, no rep and no event timed."""
    assert set(bt.COUNTS) == set(bt.SIZES)
    for name, s in bt.SIZES.items():
        c = bt.COUNTS[name]
        assert (c.h, c.w, c.k, c.b) == (s.h, s.w, s.k, s.b), name
        assert (c.iters, c.reps, c.events) == (1, 0, 0), name
