"""The port's config 3 (`parallel/spatial.py`, `comm.exchange_halo`) in 2
gloo ranks on the CPU, one spawn for every case (`tests/torch_dist_worker.py::
spatial_cases`).

- The halo exchange, with and without the re-clamp, equals the reference's
  `_exchange_halo` / `_reclamp` in a 2-device `shard_map` bit for bit, at a
  halo below, equal to and above the slab's rows (the last clips the hops).
- `extract_features_spatial` at tests/test_parallel.py:40-63's 256x96, K =
  512 (every octave on slabs), with `min_rows=64` (octave 2 gathered), and
  `-fo 1` on a 512x192 frame of twice the texture scale (decimated to the
  same before the split): both
  ranks bit-identical, and within that test's bounds of
  one process's `extract_features` (equal counts > 50, sorted (x, y, sigma,
  theta) within 5e-3, descriptors within 2 steps).
- The same 256x96 run against the reference's `extract_features_spatial`
  on a 2-device mesh, within the port's extraction budgets
  (tests/test_torch_extract.py::check_features).
- The per-octave stats: the exchange's rows and bytes; the ValueErrors;
  `convert` carries a reference config with `-fo n` over with its shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dist_worker as worker
from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.parallel import spatial as jspatial
from siftgpu_tpu_torch import Features, SiftConfig, convert, extract_features
from siftgpu_tpu_torch.oracle import fixtures
from siftgpu_tpu_torch.parallel import comm, spatial
from test_torch_extract import check_features
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W, K = 256, 96, 512
HALO_FRAMES = np.random.default_rng(7).random((2, 16, 5)).astype(np.float32)   # 8 rows a rank
HALOS = (3, 8, 13)
EXTRACT = {   # name: (frame height, width and texture scale, config options, spatial options)
    "slabs": ((H, W, 2), dict(), {}),
    "gathered": ((H, W, 2), dict(), {"min_rows": 64}),
    "fo1": ((2 * H, 2 * W, 4), dict(first_octave=1), {}),
}


def _image(h=H, w=W, smooth=2):
    return fixtures.random_texture(h, w, seed=3, smooth=smooth)[None]


def _config(name):
    (h, w, _), c, _ = EXTRACT[name]
    return SiftConfig(height=h, width=w, max_keypoints=K, **c)


@pytest.fixture(scope="module")
def ranks():
    img = _image()
    cases = [(_image(*hw), _config(name), kw) for name, (hw, _, kw) in EXTRACT.items()]
    cases += [(img, SiftConfig(height=H, width=W, max_keypoints=K, first_octave=-1), {}),
              (img[:, :255], SiftConfig(height=255, width=W, max_keypoints=K), {})]
    return comm.spawn(worker.spatial_cases, 2, "gloo", "cpu", [(HALO_FRAMES, h) for h in HALOS],
                      cases, timeout=300, threads=1)


@pytest.mark.parametrize("h", HALOS)
def test_exchange_halo_matches_reference(ranks, h):
    mesh = Mesh(np.array(jax.devices()[:2]), ("spatial",))

    def f(x):
        idx = jax.lax.axis_index("spatial")
        p = jspatial._exchange_halo(x, h, "spatial", idx, 2)
        return p, jspatial._reclamp(p, h, idx, 2)

    spec = P(None, "spatial", None)
    ref = jax.shard_map(f, mesh=mesh, in_specs=spec, out_specs=(spec, spec),
                        check_vma=False)(jnp.asarray(HALO_FRAMES))
    n_rows = 8 + 2 * h
    for r, (halos, _) in enumerate(ranks):
        got = halos[HALOS.index(h)]
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a)[:, r * n_rows:(r + 1) * n_rows], b)


def _rows(f):
    m = f.mask[0]
    a = np.stack([f.x[0][m], f.y[0][m], f.sigma[0][m], f.theta[0][m]], axis=1)
    order = np.lexsort((a[:, 3], a[:, 1], a[:, 0]))
    return a[order], f.desc[0][m][order].astype(int)


@pytest.mark.parametrize("name", list(EXTRACT))
def test_spatial_matches_one_process(ranks, name):
    i = list(EXTRACT).index(name)
    (a, _), (b, _) = ranks[0][1][i], ranks[1][1][i]
    for x, y in zip(a, b):
        assert np.array_equal(x, y)                  # every rank the same bits
    img = torch.from_numpy(_image(*EXTRACT[name][0]))
    one = Features(*(t.numpy() for t in extract_features(img, _config(name))))
    got = Features(*a)
    assert one.mask.sum() == got.mask.sum() > 50
    ra, da = _rows(one)
    rb, db = _rows(got)
    np.testing.assert_allclose(ra, rb, atol=5e-3)
    assert np.abs(da - db).max() <= 2


def test_spatial_matches_reference(ranks):
    cfg = JConfig(height=H, width=W, max_keypoints=K)
    ref = jspatial.extract_features_spatial(jnp.asarray(_image()), cfg,
                                            Mesh(np.array(jax.devices()[:2]), ("spatial",)))
    got = Features(*(torch.from_numpy(a) for a in ranks[0][1][0][0]))
    check_features(ref, got)


def test_spatial_stats(ranks):
    """Octave 0 sends its 2 x 96 boundary rows; the later slabs (64, 32 rows)
    are under the halo and go whole; the gathered octave sends its slab."""
    _, stats = ranks[0][1][0]
    assert [(s["mode"], s["rows"], s["calls"]) for s in stats] == [
        ("spatial", 128, 1), ("spatial", 64, 1), ("spatial", 32, 1)]
    assert [s["bytes_sent"] for s in stats] == [2 * 96 * W * 4, 64 * 48 * 4, 32 * 24 * 4]
    assert all(s["bytes_gathered"] == 2 * s["bytes_sent"] and s["ms"] >= 0 for s in stats)
    _, stats = ranks[0][1][1]
    assert [(s["mode"], s["rows"]) for s in stats] == [("spatial", 128), ("spatial", 64),
                                                       ("gathered", 32)]


def test_spatial_value_errors(ranks):
    for r in ranks:
        fo, split = r[1][3:]
        assert "first_octave -1" in fo and "do not split" in split
    with pytest.raises(ValueError, match="do not match"):
        spatial.extract_features_spatial(_image()[:, :128], SiftConfig(height=H, width=W),
                                         device="cpu")


@pytest.mark.parametrize("fo", [1, 2])
def test_convert_carries_first_octave(fo):
    ref = JConfig(height=1088, width=1920, max_keypoints=4096, first_octave=fo)
    got = convert.sift_config_from_reference(dataclasses.asdict(ref))
    assert got == SiftConfig(height=1088, width=1920, max_keypoints=4096, first_octave=fo)
    assert got.octaves == ref.octaves
    assert [got.octave_shape(o) for o in range(got.octaves)] == [
        tuple(ref.octave_shape(o)) for o in range(ref.octaves)]
    assert [got.octave_scale(o) for o in range(got.octaves)] == [
        ref.octave_scale(o) for o in range(ref.octaves)]
