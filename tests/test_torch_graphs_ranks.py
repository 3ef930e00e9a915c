"""The rank programs (`parallel/resident_ba.py`'s `_scatter_jit`,
`_solve_jit`, `_gather_jit`, `ResidentBAJit`; `parallel/dp.py`'s
`extract_features_dp_jit`) and what `core/graphs.py` does with a process
group, on the CPU.  On the card, chip_smoke.py phase 4f holds their
replays on NCCL bit for bit to the eager calls, and its gloo ranks show
the refusal.  Here:

- on CPU tensors each program is its eager function: the same bits,
  nothing captured, no launch counted;
- in a 1-rank gloo group, `chip_smoke.resident_solve` (two solves around
  a few host edits) through `ResidentBA` and `ResidentBAJit` gives the
  bits of the class as it was before its device work was split into the
  programs (`torch_dist_worker.PreSplitResidentBA`), with the same
  collectives counted (`graphs.COLLECTIVES`); inside a capture's tally
  they are counted there and not into `COLLECTIVES`;
- `graphs.check_backends` refuses a gloo group with a CUDA device (also
  inside a tuple or list), naming the entry point and the backend,
  and passes a gloo group on the CPU, no group, and an NCCL group.

`tests/test_torch_resident_ba.py` and `tests/test_torch_dp.py` hold
`ResidentBAJit` and `extract_features_dp_jit` in 2 gloo ranks to the
reference on a 2-device mesh.
"""

import numpy as np
import pytest

import chip_smoke as cs
import torch_dist_worker as worker
from siftgpu_tpu_torch import SiftConfig
from siftgpu_tpu_torch.frontend import extract
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.parallel import comm, dp, resident_ba
from test_torch_graphs import check_cpu_route, same_bits
from torch_threads import one_thread  # noqa: F401 (autouse)

PROGRAMS = {name: (getattr(resident_ba, f + "_jit"), getattr(resident_ba, f))
            for name, f in cs.RESIDENT_PROGRAMS.items()}


def _window():
    prob = cs.ba_problem()
    return cs.resident_window(*(a.numpy() for a in (prob.cams, prob.points, prob.cam_idx,
                                                    prob.pt_idx, prob.uv, prob.intrinsics)))


@pytest.fixture(scope="module")
def program_calls():
    """Each program's calls in one process's `resident_solve` (the second
    solve's upload is the scatter)."""
    with cs.recorded_programs({}) as calls:
        cs.resident_solve(_window(), cs.RESIDENT_EDITS, group=None, device="cpu")
    return calls


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_on_cpu_is_its_eager_function(program_calls, name):
    jit, eager = PROGRAMS[name]
    for args in program_calls[name]:
        check_cpu_route(jit, eager, args, {})


def test_extract_features_dp_jit_on_cpu_is_eager():
    imgs = np.stack([fixtures.random_texture(64, 80, seed=s) for s in range(2)])
    cfg = SiftConfig(height=64, width=80, max_keypoints=128, num_octaves=2)
    got = dp.extract_features_dp_jit(imgs, cfg, device="cpu")
    assert same_bits(tuple(got), tuple(dp.extract_features_dp(imgs, cfg, device="cpu")))
    assert not extract.extract_features_jit.captures


@pytest.fixture(scope="module")
def one_rank():
    (out,) = comm.spawn(worker.resident_programs, 1, "gloo", "cpu", _window(),
                        cs.RESIDENT_EDITS, timeout=120, threads=1)
    return out


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("label", ["eager", "jit"])
def test_resident_solve_keeps_its_bits(one_rank, label):
    (got, counted), (want, want_counted) = one_rank[label], one_rank["pre_split"]
    assert len(got) == len(want) == 6 and _same(got, want)
    assert got[3] == len(cs.RESIDENT_EDITS)       # the second solve's uploaded slots
    assert counted == want_counted


def test_collectives_are_counted(one_rank):
    counted = one_rank["eager"][1]
    assert counted["all_reduce"] > 0 and counted["all_gather"] == 2   # a gather a solve
    tally, untouched = one_rank["tallied"]
    assert tally == counted and untouched


def test_backend_check(one_rank):
    cases = one_rank["backends"]
    for case in ("cuda", "cuda:0 nested"):
        assert "_solve_jit" in cases[case] and "'gloo'" in cases[case], case
    assert cases["cpu"] is None and cases["no group"] is None and cases["nccl"] is None
