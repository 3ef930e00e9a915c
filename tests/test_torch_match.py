"""Port matcher vs the reference on the same uint8 and float sets (the
cases of tests/test_match.py): pairs and count identical.

`dist` is arccos of the winner similarity.  The reference forms similarities
with `lax.rsqrt`, the port with `torch.rsqrt`, which differ in the last ulp,
so winner similarities agree within 2 ulp (see the last test); arccos
magnifies that by 1/sin(dist), so `dist` is held to 1e-6 plus that
propagated budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu.core.config import MatchConfig as JMatch
from siftgpu_tpu.frontend import match as jmatch
from siftgpu_tpu_torch.core.config import MatchConfig
from siftgpu_tpu_torch.frontend import match
from siftgpu_tpu_torch.ops import match_kernel


def _rand_desc(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((n, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.minimum(d, 0.35)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.clip(np.floor(512 * d + 0.5), 0, 255).astype(np.uint8)


def _noisy_copy(d, seed, noise=6):
    rng = np.random.default_rng(seed)
    return np.clip(d.astype(np.int32) + rng.integers(-noise, noise + 1, d.shape),
                   0, 255).astype(np.uint8)


def _parity_sets():
    d0 = _rand_desc(100, 1)
    perm = np.random.default_rng(2).permutation(100)
    d1 = np.concatenate([_noisy_copy(d0, 3)[perm], _rand_desc(60, 4)])
    return d0, d1


def _check(res, ref, sim_ulps=2):
    np.testing.assert_array_equal(res.pairs.numpy(), np.asarray(ref.pairs))
    assert int(res.count) == int(ref.count)
    rd, jd = res.dist.numpy().astype(np.float64), np.asarray(ref.dist).astype(np.float64)
    ulp_sim = np.spacing(np.cos(jd).astype(np.float32)).astype(np.float64)
    budget = 1e-6 + sim_ulps * ulp_sim / np.maximum(np.sin(jd), 1e-3)
    assert (np.abs(rd - jd) <= budget).all()


CFGS = [dict(max_match=256), dict(max_match=40), dict(max_match=256, mutual_best=False),
        dict(max_match=256, ratio_max=0.6, dist_max=0.5)]


@pytest.mark.parametrize("kw", CFGS, ids=str)
def test_match_parity_with_reference(kw):
    d0, d1 = _parity_sets()
    ref = jmatch.match_descriptors(jnp.asarray(d0), jnp.asarray(d1), cfg=JMatch(**kw))
    res = match.match_descriptors(torch.from_numpy(d0), torch.from_numpy(d1), cfg=MatchConfig(**kw))
    _check(res, ref)
    assert int(res.count) > (30 if kw.get("max_match", 256) < 100 else 60)


def test_match_respects_masks():
    d0 = _rand_desc(32, 5)
    d1 = _noisy_copy(d0, 6)
    m0 = np.ones(32, bool)
    m0[:10] = False
    m1 = np.ones(32, bool)
    m1[20:25] = False
    ref = jmatch.match_descriptors(jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(m0),
                                   jnp.asarray(m1), cfg=JMatch(max_match=64))
    res = match.match_descriptors(torch.from_numpy(d0), torch.from_numpy(d1),
                                  torch.from_numpy(m0), torch.from_numpy(m1),
                                  cfg=MatchConfig(max_match=64))
    _check(res, ref)
    p = res.pairs[: int(res.count)].numpy()
    assert (p[:, 0] >= 10).all() and not np.isin(p[:, 1], np.arange(20, 25)).any()


def test_match_batch_matches_reference():
    d0, d1 = _parity_sets()
    e0, e1 = _rand_desc(160, 8), _noisy_copy(_rand_desc(160, 8), 9)[::-1].copy()
    D0, D1 = np.stack([d0[:100], e0[:100]]), np.stack([d1[:150], e1[:150]])
    m0 = np.ones((2, 100), bool)
    m0[1, ::7] = False
    cfg, jcfg = MatchConfig(max_match=128), JMatch(max_match=128)
    ref = jmatch.match_descriptors_batch(jnp.asarray(D0), jnp.asarray(D1), jnp.asarray(m0),
                                         None, jcfg)
    res = match.match_descriptors_batch(torch.from_numpy(D0), torch.from_numpy(D1),
                                        torch.from_numpy(m0), None, cfg)
    for p in range(2):
        _check(type(res)(*(f[p] for f in res)), type(ref)(*(f[p] for f in ref)))


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def test_best2_reduction_matches_reference_similarities():
    """Selections identical.  The port's reciprocal norms are correctly
    rounded and the reference's `lax.rsqrt` is within 1 ulp of that (checked
    here over this set), so the winner similarities (dot * rn1) * rn0 agree
    within 2 ulp."""
    d0, d1 = _parity_sets()
    p0, p1 = jmatch._u8_parts(jnp.asarray(d0)), jmatch._u8_parts(jnp.asarray(d1))
    sim = np.asarray(jmatch._u8_sim(p0, p1))
    jb, js, jj = (np.asarray(a) for a in jmatch._best2_sim(jnp.asarray(sim)))
    t0, t1 = torch.from_numpy(d0)[None], torch.from_numpy(d1)[None]
    rn0, rn1 = match_kernel.recip_norms(t0), match_kernel.recip_norms(t1)
    assert _ulps(rn0[0].numpy(), p0[1]).max() <= 1
    assert _ulps(rn1[0].numpy(), p1[1]).max() <= 1
    ones0, ones1 = torch.ones(1, 100, dtype=torch.bool), torch.ones(1, 160, dtype=torch.bool)
    bs, ss, bj, ci = match_kernel.match_best2(t0, t1, rn0, rn1, ones0, ones1)
    np.testing.assert_array_equal(bj[0].numpy(), jj)
    np.testing.assert_array_equal(ci[0].numpy(), sim.argmax(axis=0))
    assert _ulps(bs[0].numpy(), jb).max() <= 2
    assert _ulps(ss[0].numpy(), js).max() <= 2


@pytest.mark.parametrize("kw", CFGS, ids=str)
def test_float_descriptors_match_reference(kw):
    """Float descriptors take the dense f32 route (L2-normalised rows, one
    f32 matmul): pairs and count identical to the reference's; the rows are
    normalised and the dots summed in another order, so `dist` is held to
    1e-6 plus 16 ulp of the similarity through arccos."""
    d0, d1 = _parity_sets()
    d0, d1 = d0.astype(np.float32) / 512, d1.astype(np.float32) / 512
    ref = jmatch.match_descriptors(jnp.asarray(d0), jnp.asarray(d1), cfg=JMatch(**kw))
    res = match.match_descriptors(torch.from_numpy(d0), torch.from_numpy(d1), cfg=MatchConfig(**kw))
    _check(res, ref, sim_ulps=16)
    assert int(res.count) > (30 if kw.get("max_match", 256) < 100 else 60)
    # the batch entry point takes the same route, masks included
    m0 = np.ones((1, 100), bool)
    m0[0, ::5] = False
    refb = jmatch.match_descriptors_batch(jnp.asarray(d0[None]), jnp.asarray(d1[None]),
                                          jnp.asarray(m0), None, JMatch(**kw))
    resb = match.match_descriptors_batch(torch.from_numpy(d0[None]), torch.from_numpy(d1[None]),
                                         torch.from_numpy(m0), None, MatchConfig(**kw))
    _check(type(resb)(*(f[0] for f in resb)), type(refb)(*(f[0] for f in refb)), sim_ulps=16)
