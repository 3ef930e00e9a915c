"""The comparison that decides `correct` has to fail its control and the
faults a cell can have.

The control is the reference put in the program's place, computed in the
nearest precision below the configuration's (TF32 for float32 with TF32
off, 4 bits for uint8); TF32 is the operands rounded to 10 mantissa bits,
so it runs alike on the CPU and the card.  The faults are planted in the
program underneath a run that skips only the harness's look for a card:
a step that returns its state unchanged (every call answers with the
first call's outputs), half of the batch left out (the first half's answers given for the
rest), and an answer altered where it is produced: one frame's keypoints
moved by a pixel, or one pair's matches pointed at the next column.  A
single keypoint's slip stays inside the keypoint limits, which leave room
for the rare keypoint that rounding moves across a threshold; a matched
set is compared exactly."""

import pytest
import torch

from benchmark.lib import program, runner
from benchmark.reference import sift as ref_sift
from benchmark.tests.sizes import SMALL

M = runner.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.3e-3, 0.0])
    y = ref_sift.tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10
    assert y[2] == 1.0                          # a tie goes to the even mantissa
    assert y[3] == 1.0 + 2**-9
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((y - x).abs() <= x.abs() * 2**-11).all()


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_comparison(workload):
    parts = runner.cell(M, workload)
    ctl = parts["kind"].control(runner.lowered(parts["config"]))
    res, numbers, _ = runner.run_cell(workload, 11, 0.5, False, "cpu", entries=ctl, settle=0,
                                      sizes=SMALL[workload])
    assert res["correct"] is False, numbers


def _faulty(workload, kind):
    prog = program.entries(runner.cell(M, workload)["kind"].ENTRIES)
    extract = getattr(prog, "extract", None)
    match_batch, match = prog.match_batch, getattr(prog, "match", None)

    def half_batch(frames, cfg):
        n = frames.shape[0]
        if n < 2:
            return extract(frames, cfg)
        f = extract(frames[: n // 2], cfg)
        idx = torch.arange(n) % (n // 2)
        return type(f)(*(t[idx] for t in f))

    def half_pairs(d0, d1, m0, m1, cfg):
        n = d0.shape[0]
        r = match_batch(d0[: n // 2], d1[: n // 2], m0[: n // 2], m1[: n // 2], cfg)
        idx = torch.arange(n) % (n // 2)
        return type(r)(*(t[idx] for t in r))

    def moved_keypoint(frames, cfg):
        f = extract(frames, cfg)
        x = f.x.clone()
        x[0] += 1.0
        return f._replace(x=x)

    def altered_match(d0, d1, m0, m1, cfg):
        r = match_batch(d0, d1, m0, m1, cfg)
        pairs = r.pairs.clone()
        pairs[0, :, 1] = torch.where(pairs[0, :, 1] >= 0, (pairs[0, :, 1] + 1) % d1.shape[1], -1)
        return r._replace(pairs=pairs)

    def altered_single(d0, d1, m0, m1, cfg):
        r = match(d0, d1, m0, m1, cfg)
        pairs = r.pairs.clone()
        pairs[:, 1] = torch.where(pairs[:, 1] >= 0, (pairs[:, 1] + 1) % d1.shape[0], -1)
        return r._replace(pairs=pairs)

    first = {}

    def stale(fn, name):
        def call(*args):
            if name not in first:
                first[name] = fn(*args)
            return first[name]
        return call

    faults = {
        "stale": dict(extract=stale(extract, "extract"), match_batch=stale(match_batch, "batch"),
                      match=stale(match, "single")),
        "half_batch": dict(extract=half_batch, match_batch=half_pairs),
        "answer_altered": dict(extract=moved_keypoint),
        "match_altered": dict(match_batch=altered_match, match=altered_single),
    }
    for name, fn in faults[kind].items():
        if hasattr(prog, name):
            setattr(prog, name, fn)
    return prog


FAULTS = [("vga-stream", "stale"), ("colmap-exhaustive", "stale"), ("colmap-extract", "stale"),
          ("vga-frame", "stale"), ("vga-stream", "half_batch"), ("vga-stream", "answer_altered"),
          ("vga-stream", "match_altered"), ("colmap-exhaustive", "half_batch"),
          ("colmap-exhaustive", "match_altered"), ("colmap-extract", "answer_altered"),
          ("vga-frame", "answer_altered"), ("vga-frame", "match_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_fault_in_the_timed_path_fails_the_comparison(workload, fault):
    res, numbers, _ = runner.run_cell(workload, 13, 0.5, False, "cpu",
                                      entries=_faulty(workload, fault), settle=0,
                                      sizes=SMALL[workload])
    assert res["correct"] is False, numbers


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_own_size_on_the_card(card, workload):
    """On the card at the cell's size (the configuration and traffic as
    BENCHMARK.json names them), three seeds."""
    parts = runner.cell(M, workload)
    ctl = parts["kind"].control(runner.lowered(parts["config"]))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        res, numbers, _ = runner.run_cell(workload, seed, 6.0, False, card, entries=ctl, settle=0)
        assert res["correct"] is False, (seed, numbers)
