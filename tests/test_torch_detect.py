"""Port detection vs the reference's CPU route, fed the reference's DoG.

  - score planes: bit-identical to `_dense_scores_xla` (same f32 compares,
    selects and bit packing);
  - subpixel records: within 4 ulp or 1e-6 absolute, whichever is larger,
    at every candidate pixel (nonzero score).  XLA:CPU contracts the Cramer
    solve's multiply-adds into FMAs and PyTorch does not; away from the
    candidates the records are unused by contract and their ill-conditioned
    solves differ by more;
  - winners identical, refined y / x / sigma within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import detect as jdetect
from siftgpu_tpu.frontend import pyramid as jpyramid
from siftgpu_tpu_torch import convert
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import detect
from siftgpu_tpu_torch.frontend.pyramid import Octave
from siftgpu_tpu_torch.ops import detect_scores
from siftgpu_tpu_torch.oracle import fixtures

CASES = [(120, 160, 2, 5), (80, 96, 1, 3), (97, 131, 1, 7)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}x{c[1]}b{c[2]}")
def case(request):
    h, w, b, seed = request.param
    kw = dict(height=h, width=w, max_keypoints=256)
    jcfg, cfg = JConfig(**kw), SiftConfig(**kw)
    imgs = np.stack([fixtures.random_texture(h, w, seed=seed + i) for i in range(b)])
    jpyr = jpyramid.build_pyramid(jnp.asarray(imgs), jcfg)
    tpyr = tuple(convert.tree_to_torch(oc, Octave) for oc in jpyr)
    return jcfg, cfg, jpyr, tpyr


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_scores_and_records(case):
    jcfg, cfg, jpyr, tpyr = case
    dense = jax.jit(lambda d: jdetect._dense_scores_xla(d, jcfg, None))
    n_cand = 0
    for joc, toc in zip(jpyr, tpyr):
        ref = [np.asarray(a) for a in dense(joc.dog)]
        got = [a.numpy() for a in detect_scores.detect_scores(toc.dog, cfg)]
        for r, g in zip(ref, got):
            assert r.shape == g.shape
        np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
        np.testing.assert_array_equal(_bits(got[1]), _bits(ref[1]))
        for plane in ref[:2]:  # candidate pixels from the row-pooled planes
            b, s, yp, x = np.nonzero(plane > 0)
            y = 2 * yp + ((plane[b, s, yp, x].view(np.int32) & 3) >> 1)
            n_cand += len(b)
            for r, g in zip(ref[2:], got[2:]):
                rv, gv = r[b, s, y, x], g[b, s, y, x]
                ulp = np.abs(rv.view(np.int32).astype(np.int64) - gv.view(np.int32))
                assert ((ulp <= 4) | (np.abs(rv - gv) <= 1e-6)).all()
    assert n_cand > 20


def test_winners_identical(case):
    jcfg, cfg, jpyr, tpyr = case
    for o, (joc, toc) in enumerate(zip(jpyr, tpyr)):
        cap = cfg.octave_cap(o)
        jw = jdetect.detect_winners(joc.dog, jcfg, cap, scores_impl="xla")
        bscore, _, (_, Ws), (nb1, Hs2) = detect._octave_scores(toc.dog, cfg)
        top, bidx = detect._run_topk(bscore, cap)
        tw = detect._decode_topk(top, bidx, nb1, Hs2, Ws)
        for f in ("py", "px", "l", "cand"):
            np.testing.assert_array_equal(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)), f)


def test_detect_pyramid(case):
    jcfg, cfg, jpyr, tpyr = case
    ref = jdetect.detect_pyramid(jpyr, jcfg)
    got = detect.detect_pyramid(tpyr, cfg)
    n = 0
    for r, g in zip(ref, got):
        m = np.asarray(r.mask)
        np.testing.assert_array_equal(g.mask.numpy(), m)
        np.testing.assert_array_equal(g.grad_level.numpy()[m], np.asarray(r.grad_level)[m])
        for f in ("y", "x", "sigma"):
            np.testing.assert_allclose(getattr(g, f).numpy()[m], np.asarray(getattr(r, f))[m],
                                       rtol=0, atol=1e-5, err_msg=f)
        np.testing.assert_allclose(g.response.numpy()[m], np.asarray(r.response)[m],
                                   rtol=1e-5, atol=1e-7)
        n += int(m.sum())
    assert n > 10
