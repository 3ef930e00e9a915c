"""The slice as a whole: the port's `extract_features` + `match_descriptors`
against the reference's `extract_features_jit` on the CPU.

Budgets are those the reference holds itself to against its oracle
(tests/test_extract_parity.py:55-62): equal counts, >= 99% of keypoints
paired within 0.5 px, theta q75 < 1e-3 / q90 < 2e-2 / max < 0.05, descriptor
cosine q25 > 0.999 / min > 0.995, sigma within 1e-2.  Then the matcher on a
known shift: > 90% inliers at < 1 px."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siftgpu_tpu import SiftConfig as JConfig
from siftgpu_tpu import extract_features_jit
from siftgpu_tpu_torch import MatchConfig, SiftConfig, extract_features, match_descriptors
from siftgpu_tpu_torch.oracle import fixtures

from helpers import angdiff, desc_cosine, features_to_numpy

SHIFT = (7.0, -4.0)


def _pair(a, b, pos_tol=0.5):
    used, pairs = set(), []
    for ia in range(len(a["x"])):
        d2 = (b["x"] - a["x"][ia]) ** 2 + (b["y"] - a["y"][ia]) ** 2
        cand = [c for c in np.where(d2 < pos_tol ** 2)[0] if c not in used]
        if not cand:
            continue
        td = np.array([angdiff(a["theta"][ia], b["theta"][c]) for c in cand])
        ib = cand[int(td.argmin())]
        used.add(ib)
        pairs.append((ia, ib))
    return pairs


def _image(feats, i):
    return features_to_numpy(type(feats)(*(f[i:i + 1] for f in feats)))


@functools.lru_cache(maxsize=None)
def _run(name):
    if name == "120x160_shift":
        h, w, k = 120, 160, 512
        img0 = fixtures.random_texture(h, w, seed=42)
        imgs = np.stack([img0, fixtures.warp_affine(img0, np.eye(2), np.array(SHIFT))])
    else:
        h, w, k = 80, 96, 256
        imgs = fixtures.random_texture(h, w, seed=3)[None]
    ref = extract_features_jit(jnp.asarray(imgs), JConfig(height=h, width=w, max_keypoints=k))
    got = extract_features(torch.from_numpy(imgs), SiftConfig(height=h, width=w, max_keypoints=k))
    return ref, got


@pytest.fixture(params=["120x160_shift", "80x96_parity"])
def case(request):
    return _run(request.param)


def check_features(ref, got):
    """The extract budgets, image by image: the reference's Features `ref`
    against the port's `got`."""
    assert got.desc.dtype == torch.uint8 and tuple(got.desc.shape) == ref.desc.shape
    for i in range(ref.mask.shape[0]):
        r = features_to_numpy(type(ref)(*(np.asarray(f)[i:i + 1] for f in ref)))
        g = _image(type(got)(*(f.numpy() for f in got)), i)
        assert len(g["x"]) == len(r["x"]) > 20
        pairs = _pair(r, g)
        assert len(pairs) >= 0.99 * len(r["x"])
        tds = np.array([angdiff(r["theta"][a], g["theta"][b]) for a, b in pairs])
        assert np.quantile(tds, 0.75) < 1e-3
        assert np.quantile(tds, 0.9) < 2e-2
        assert tds.max() < 0.05
        cos = np.array([desc_cosine(r["desc"][a], g["desc"][b]) for a, b in pairs])
        assert np.quantile(cos, 0.25) > 0.999
        assert cos.min() > 0.995
        sd = np.array([abs(r["sigma"][a] - g["sigma"][b]) for a, b in pairs])
        assert sd.max() < 1e-2


def test_features_match_reference(case):
    check_features(*case)


def test_masked_rows_are_padding(case):
    _, got = case
    m, r = got.mask[0].numpy(), got.response[0].numpy()
    assert m[: m.sum()].all() and not m[m.sum():].any()
    assert (np.diff(r[m]) <= 1e-9).all()


def test_known_shift_matches():
    _, got = _run("120x160_shift")
    res = match_descriptors(got.desc[0], got.desc[1], got.mask[0], got.mask[1], MatchConfig())
    c = int(res.count)
    p = res.pairs[:c].numpy()
    x0, y0, x1, y1 = (a.numpy() for a in (got.x[0], got.y[0], got.x[1], got.y[1]))
    err = np.hypot(x1[p[:, 1]] - (x0[p[:, 0]] + SHIFT[0]), y1[p[:, 1]] - (y0[p[:, 0]] + SHIFT[1]))
    assert c > 50
    assert (err < 1.0).mean() > 0.9
