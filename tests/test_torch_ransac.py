"""The port's two departures from the reference's RANSAC
(`geometry/epipolar.py::ransac_from_samples`), on tests/test_geometry.py's
synthetic two-view scene (numpy, from a seed; 30 of 120 correspondences
moved off their epipolar lines):

- a minimal set that repeats a correspondence wins only where no set of 8
  distinct ones scores (the reference ranks all sets by score alone);
- a refit replaces E only if it keeps at least as many inliers (the
  reference takes every refit).

The hypotheses' and refits' matrices are chosen through a patched
`eight_point`, so that which E scores what does not rest on a solver's
rounding; scores and inlier sets are exact integer counts.  Last,
`ransac_witness.py`'s switchable RANSAC against the port's and the
reference's rules."""

import numpy as np
import pytest
import torch

from siftgpu_tpu_torch.geometry import epipolar

from test_geometry import _essential_from_rt, _synthetic_two_view

THR = 1e-5
N = 120


@pytest.fixture(scope="module")
def scene():
    x0, x1, R, t, _, bad = _synthetic_two_view(N, seed=2, noise=1e-4, outliers=30)
    E = torch.from_numpy(_essential_from_rt(R, t).astype(np.float32))
    # a wrong essential matrix: the same rotation, the baseline turned
    E_wrong = torch.from_numpy(_essential_from_rt(R, np.array([0.1, 1.0, 0.2]))
                               .astype(np.float32))
    return (torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(x1)), E, E_wrong,
            sorted(set(range(N)) - bad))


def _patch(monkeypatch, hyp=None, refit=None):
    """eight_point returning `hyp` [H, 3, 3] for the minimal sets and `refit`
    for the refits on the full set, where given."""
    real = epipolar.eight_point

    def fake(x0, x1, w):
        if x0.dim() == 3 and hyp is not None:
            return hyp
        if x0.dim() == 2 and refit is not None:
            return refit
        return real(x0, x1, w)

    monkeypatch.setattr(epipolar, "eight_point", fake)


def _inliers(E, x0, x1):
    return epipolar.sampson_distance(E, x0, x1) < THR


@pytest.mark.parametrize("repeats", [(True, False, False), (True, True, True)])
def test_repeated_minimal_set_loses_to_a_distinct_one(scene, monkeypatch, repeats):
    """Set 0 holds the true E (every inlier), sets 1 and 2 the wrong one and a
    blend of the two.  Where set 0 repeats a correspondence and another set
    does not, the best distinct set wins though it scores less; where every
    set repeats one, the top score wins, as in the reference."""
    x0, x1, E, E_wrong, good = scene
    hyp = torch.stack([E, E_wrong, E + 0.05 * E_wrong])
    scores = [int(_inliers(h, x0, x1).sum()) for h in hyp]
    assert scores[0] > max(scores[1:])
    sets = torch.tensor([good[:8], good[8:16], good[16:24]])
    for i, rep in enumerate(repeats):
        if rep:
            sets[i, 1] = sets[i, 0]
    _patch(monkeypatch, hyp=hyp)
    res = epipolar.ransac_from_samples(x0, x1, torch.ones(N, dtype=torch.bool), sets,
                                       threshold=THR, refine_iters=0)
    distinct = [i for i, rep in enumerate(repeats) if not rep]
    want = max(distinct, key=lambda i: (scores[i], -i)) if distinct else 0
    assert int(res.best_score) == scores[want]
    assert torch.equal(res.E, hyp[want])
    assert torch.equal(res.inliers, _inliers(hyp[want], x0, x1))


@pytest.mark.parametrize("refit", ["better", "worse"])
def test_refit_kept_only_if_not_worse(scene, monkeypatch, refit):
    """The winning hypothesis is a blend that keeps some inliers; a refit to
    the true E (more inliers) replaces it, a refit to the wrong E (fewer)
    does not, at each of the two refinement steps."""
    x0, x1, E, E_wrong, good = scene
    blend = E + 0.02 * E_wrong
    new = E if refit == "better" else E_wrong
    n_blend, n_new = (int(_inliers(m, x0, x1).sum()) for m in (blend, new))
    assert (n_new > n_blend) if refit == "better" else (n_new < n_blend)
    _patch(monkeypatch, hyp=blend[None].expand(4, 3, 3), refit=new)
    res = epipolar.ransac_from_samples(x0, x1, torch.ones(N, dtype=torch.bool),
                                       torch.tensor([good[8 * i:8 * i + 8] for i in range(4)]),
                                       threshold=THR, refine_iters=2)
    keep = new if refit == "better" else blend
    assert torch.equal(res.E, keep)
    assert torch.equal(res.inliers, _inliers(keep, x0, x1))
    assert int(res.num_inliers) == max(n_blend, n_new)
    assert int(res.best_score) == n_blend


@pytest.mark.parametrize("rules", ["port", "reference"])
def test_witness_script_rules(rules):
    """`ransac_witness.py`'s RANSAC with both rules is `ransac_from_samples`
    bit for bit; with neither it keeps the reference's rules, held as
    tests/test_torch_geometry.py holds the port's scoring: on the
    reference's own draws, inlier sets equal to `ransac_essential`'s but for
    1%, best scores within 1."""
    import jax
    import jax.numpy as jnp

    import ransac_witness as rw
    from siftgpu_tpu.geometry import epipolar as jepi
    from test_torch_geometry import _reference_draws

    x0, x1, *_ = _synthetic_two_view(N, seed=2, noise=1e-4, outliers=30)
    mask = np.ones(N, bool)
    mask[[3, 50]] = False
    key = jax.random.PRNGKey(0)
    idx = torch.from_numpy(_reference_draws(mask, key, 256))
    a, b = torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(x1))
    m = torch.from_numpy(mask)
    if rules == "port":
        got = rw.ransac(a, b, m, idx, threshold=THR, distinct=True, keep=True)
        want = epipolar.ransac_from_samples(a, b, m, idx, threshold=THR)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        got = rw.ransac(a, b, m, idx, threshold=THR)
        ref = jepi.ransac_essential(x0, x1, jnp.asarray(mask), key, num_hypotheses=256,
                                    threshold=THR)
        assert (got.inliers.numpy() != np.asarray(ref.inliers)).mean() <= 0.01
        assert abs(int(got.best_score) - int(ref.best_score)) <= 1
