"""The port's uint8 matching, plain and guided, against the reference's
blockwise streaming matcher (`siftgpu_tpu/frontend/match.py::
_match_streaming`) on the CPU.

The reference streams d1 in column blocks, merging each block's best-2
into running (best, second, argbest) rows with a strict `>` (ties keep the
earlier column), and takes each column's argbest row within its block,
which holds every row.  The port runs one best-2 reduction over all
columns at every size (`ops/match_kernel.py`).  The routes compared:

  - auto: the reference's default `MatchConfig` (block_size 0), which
    streams 1024-column blocks above 4096 columns: N0 = 256, N1 = 4608;
  - explicit: `block_size` set, on the same set (512) and on N0 = 700,
    N1 = 900 (128);

each ungated and through the H, F and H+F gates, at the default ratio
test and at ratio_max 1.5, where a row whose best column is repeated
passes it, so the column its tie went to shows in the pairs.  Exact ties:
repeated d1 columns (descriptor and location) on both sides of block
edges, inside one block and across distant blocks, and repeated d0 rows
across the port kernel's 128-row tiles.

Budget (ROADMAP.md's ground rules): pairs and count bit-identical; winner
similarities within 2 ulp, with `dist` within 1e-6 plus that budget
through arccos, where both sides form the similarity from the same
reciprocal norms: the port's selection (`ops/match_kernel.py` with its
`_finalize`) is fed the reference's own (`_u8_parts`).  Through the
public functions each side forms its own norms, and the reference's
`lax.rsqrt` is not correctly rounded (ROADMAP.md's standing differences),
which moves winner similarities by up to 3 ulp on these sets; there
`dist` is held to tests/test_torch_guided.py's 4-ulp budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.frontend import match as jmatch
from siftgpu_tpu_torch.core.config import MatchConfig
from siftgpu_tpu_torch.frontend import match
from siftgpu_tpu_torch.ops import match_kernel

from test_torch_guided import GATES, _cross
from test_torch_match import _check, _noisy_copy, _rand_desc

SHIFT = np.array([9.0, -4.0], np.float32)
# set name -> (N0, N1, seed, repeated column pairs (lo, hi), repeated rows)
SETS = {
    "256x4608": (256, 4608, 21, [(1023, 1024), (2047, 2048), (4095, 4096), (1500, 1600),
                                 (100, 3500)], [(127, 128), (200, 201)]),
    "700x900": (700, 900, 22, [(127, 128), (255, 256), (300, 310), (100, 700), (767, 768)],
                [(127, 128), (383, 384), (10, 650)]),
}
# (set, route, reference block_size): 0 streams by the auto switch
ROUTES = [("256x4608", "auto", 0), ("256x4608", "explicit", 512), ("700x900", "explicit", 128)]
RATIOS = {"default": {}, "ties_pass": {"ratio_max": 1.5}}


def _build(n0, n1, seed, col_ties, row_ties):
    """d0 [n0] rows; d1 [n1] with a noisy copy of every d0 row at a column
    of its own (the repeated pairs' `lo` columns taken by the first rows),
    random rows elsewhere; loc1 of a copy = its row's loc0 + SHIFT."""
    rng = np.random.default_rng(seed)
    d0 = _rand_desc(n0, seed + 100)
    loc0 = rng.uniform(0, 640, (n0, 2)).astype(np.float32)
    for a, b in row_ties:
        d0[b], loc0[b] = d0[a], loc0[a]
    d1 = _rand_desc(n1, seed + 200)
    loc1 = rng.uniform(0, 640, (n1, 2)).astype(np.float32)
    his = {hi for _, hi in col_ties}
    free = np.array([j for j in range(n1) if j not in his and j not in {lo for lo, _ in col_ties}])
    pos = np.concatenate([[lo for lo, _ in col_ties],
                          rng.permutation(free)[: n0 - len(col_ties)]]).astype(int)
    order = rng.permutation(n0)           # the rows that own the tie columns, at random
    tie_rows = [int(i) for i in order if not any(int(i) == b for _, b in row_ties)][: len(col_ties)]
    rest = [int(i) for i in order if int(i) not in tie_rows]
    rows = np.array(tie_rows + rest)
    d1[pos] = _noisy_copy(d0[rows], seed + 300, noise=4)
    loc1[pos] = loc0[rows] + SHIFT
    for lo, hi in col_ties:
        d1[hi], loc1[hi] = d1[lo], loc1[lo]
    m0 = rng.random(n0) > 0.03
    m1 = rng.random(n1) > 0.03
    for a, b in row_ties:
        m0[a] = m0[b] = True
    for lo, hi in col_ties:
        m1[lo] = m1[hi] = True
    H = np.array([[1, 0, SHIFT[0]], [0, 1, SHIFT[1]], [0, 0, 1]], np.float32)
    return dict(d0=d0, d1=d1, loc0=loc0, loc1=loc1, m0=m0, m1=m1, H=H, F=_cross(*SHIFT),
                tie_rows=tie_rows)


@pytest.fixture(scope="module")
def sets():
    """The sets, built once for the module."""
    return {name: _build(*spec) for name, spec in SETS.items()}


def _reference(c, gate, block_size, ratio):
    cfg = JMatch(block_size=block_size, **RATIOS[ratio])
    assert jmatch._effective_block(cfg, c["d1"].shape[0]) > 0   # the streaming route
    d0, d1 = jnp.asarray(c["d0"]), jnp.asarray(c["d1"])
    m0, m1 = jnp.asarray(c["m0"]), jnp.asarray(c["m1"])
    if gate == "none":
        return jmatch.match_descriptors(d0, d1, m0, m1, cfg)
    use_h, use_f = GATES[gate]
    return jmatch.guided_match_descriptors(
        d0, d1, jnp.asarray(c["loc0"]), jnp.asarray(c["loc1"]),
        H=jnp.asarray(c["H"]) if use_h else None, F=jnp.asarray(c["F"]) if use_f else None,
        mask0=m0, mask1=m1, hdist_max=6.0, fdist_max=3.0, cfg=cfg)


def _port(c, gate, block_size, ratio):
    cfg = MatchConfig(block_size=block_size, **RATIOS[ratio])
    t = lambda k: torch.from_numpy(c[k])
    if gate == "none":
        return match.match_descriptors(t("d0"), t("d1"), t("m0"), t("m1"), cfg)
    use_h, use_f = GATES[gate]
    return match.guided_match_descriptors(
        t("d0"), t("d1"), t("loc0"), t("loc1"), H=t("H") if use_h else None,
        F=t("F") if use_f else None, mask0=t("m0"), mask1=t("m1"), hdist_max=6.0,
        fdist_max=3.0, cfg=cfg)


def _port_selection(c, gate, ratio):
    """The port's selection and `_finalize` on the reference's reciprocal
    norms (its `_u8_parts`), the gates from the port's operands."""
    t = lambda k: torch.from_numpy(c[k])[None]
    rn = [torch.from_numpy(np.asarray(jmatch._u8_parts(jnp.asarray(c[k]))[1]))[None]
          for k in ("d0", "d1")]
    args = (t("d0"), t("d1"), *rn, t("m0"), t("m1"))
    if gate == "none":
        sel = match_kernel.match_best2(*args)
    else:
        use_h, use_f = GATES[gate]
        g, rows, cols = match.gate_operands(t("loc0")[0], t("loc1")[0],
                                            t("H")[0] if use_h else None,
                                            t("F")[0] if use_f else None)
        sel = match_kernel.match_best2_gated(*args, g, rows[None], cols[None],
                                             *match.gate_thresholds(6.0, 3.0))
    return match._finalize(*(x[0] for x in sel), MatchConfig(**RATIOS[ratio]))


@pytest.mark.parametrize("ratio", sorted(RATIOS))
@pytest.mark.parametrize("gate", ["none", "h", "f", "hf"])
@pytest.mark.parametrize("name,route,block_size", ROUTES, ids=[f"{s}-{r}" for s, r, _ in ROUTES])
def test_match_equals_reference_streaming(sets, name, route, block_size, gate, ratio):
    c = sets[name]
    ref = _reference(c, gate, block_size, ratio)
    _check(_port_selection(c, gate, ratio), ref, sim_ulps=2)
    got = _port(c, gate, block_size, ratio)
    _check(got, ref, sim_ulps=4)
    pairs = {tuple(p) for p in got.pairs[: int(got.count)].tolist()}
    assert len(pairs) > 0.5 * c["d0"].shape[0]
    # every repeated column went to its lower index, in both routes
    for (lo, hi), i in zip(SETS[name][3], c["tie_rows"]):
        assert (i, hi) not in pairs
        if ratio == "ties_pass" and c["m0"][i]:
            assert (i, lo) in pairs, (i, lo)
    # of two repeated rows, only the lower passes the mutual check
    for a, b in SETS[name][4]:
        assert not any(p[0] == b for p in pairs)
