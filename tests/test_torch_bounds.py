"""The kernels' least times (`siftgpu_tpu_torch/bounds.py`): byte and
operation counts at the main path's shapes (4 x 480x640, S = 3, K = 2048,
3 pairs) and the facade's, against numbers worked out by hand."""

import pytest

from siftgpu_tpu_torch import bounds

# (work, bytes, {type: operations}, bound by)
CASES = {
    # base read, 6 Gaussian + 5 DoG planes written: 12 planes of 4x480x640 f32;
    # per pixel 2 passes x 91 taps x 2 + 5 subtractions
    "blur_octave_fused": (bounds.blur_octave_work(4, 480, 640, [5, 7, 8, 10, 13]),
                          58_982_400, {"f32": 1_228_800 * 369}, "bytes"),
    # DoG [4, 5, 480, 640] read; 2 pooled [4, 3, 240, 640] + 4 records
    # [4, 3, 480, 640] written
    "detect_scores": (bounds.detect_scores_work(4, 3, 480, 640),
                      24_576_000 + 73_728_000, {"f32": 147 * 3_686_400}, "bytes"),
    # levels 1..3 f32 read, gx, gy bf16 written
    "grad_stencil": (bounds.grad_stencil_work(4, 3, 480, 640, 480, 640),
                     14_745_600 + 14_745_600, {"f32": 6 * 3_686_400}, "bytes"),
    # octave 0: 12 bf16 planes (less than the 8192 windows), 8192 keypoints'
    # 17 B of inputs, theta + haspk and 2 x 512 f32 samples written
    "orient_sample": (bounds.orient_sample_work(12, 480, 640, 8192, 8192, 9192, 35, 36, 2, 256),
                      14_745_600 + 8192 * 17 + 8192 * 2 * 5 + 33_554_432,
                      {"f32": 8192 * (1225 * 35 + 36 * 30) + 9192 * 256 * 45}, "bytes"),
    # 3 pairs of 2048 x 2048: descriptors, norms, masks; 3 f32 + 1 i32 out
    "match_best2": (bounds.match_best2_work(3, 2048, 2048),
                    3 * 4096 * 133 + 3 * 2048 * 16,
                    {"int8": 2 * 128 * 3 * 2048 ** 2, "f32": 5 * 3 * 2048 ** 2}, "operations"),
    # the facade's H+F call: 4096 x 4096, 7 row and 5 column gate operands
    "match_best2_gated": (bounds.match_best2_work(1, 4096, 4096, gate="hf"),
                          2 * 4096 * 133 + 12 * 4096 * 4 + 4096 * 16,
                          {"int8": 256 * 4096 ** 2, "f32": 22 * 4096 ** 2}, "operations"),
    # 512 keypoints x 256 samples on 3 planes of 120x160: the planes are less
    # than 4 taps per sample
    "sample_gradients": (bounds.sample_gradients_work(3, 120, 160, 512, 256),
                         1_048_576 + 2048 + 230_400 + 1_048_576, {"f32": 32 * 131_072}, "bytes"),
    # the two-view path's 512 minimal-set 9 x 9 eighs (3392 convergence tests
    # of 2 x (36 + 9) + 2 ops, 103,680 rotations of 15 + 54 for V + 66 for
    # the blocks of A): M read, w and V written; per matrix 3 x 81 for the
    # load, sort and signs
    "small_eig eigh": (bounds.small_eig_work("eigh", 512, 9, 3392, 103_680),
                       512 * (81 + 9 + 81) * 4,
                       {"f64": 3392 * 92 + 103_680 * 135 + 512 * 243}, "operations"),
    # its 512 3 x 3 SVDs (2038 tests of 14 ops, 4578 rotations of 69): A
    # read, U, S, Vh written; per matrix 27 + 150
    "small_eig svd3": (bounds.small_eig_work("svd3", 512, 3, 2038, 4578),
                       512 * 30 * 4, {"f64": 2038 * 14 + 4578 * 69 + 512 * 177}, "bytes"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_work_counts(name):
    work, nbytes, ops, by = CASES[name]
    assert work.bytes == nbytes
    assert work.ops == ops
    ms, got_by = bounds.bound([work])
    t_bytes = nbytes / 3.35e12
    t_ops = sum(n / {"f32": 67e12, "f64": 34e12, "int8": 1979e12}[k] for k, n in ops.items())
    assert got_by == by
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)


def test_orient_sample_outputs_and_window_cap():
    """The main path's 15,872 keypoints write 65,011,712 B of samples; with
    no live keypoint no gradient byte is read; with few, only their
    windows."""
    w = bounds.orient_sample_work(60, 480, 640, 15_872, 0, 0, 35, 36, 2, 256)
    assert w.bytes == 65_011_712 + 15_872 * (2 * 5) + 15_872 * 17
    assert w.ops == {"f32": 0}
    few = bounds.orient_sample_work(12, 480, 640, 10, 10, 10, 35, 36, 2, 256)
    assert few.bytes - bounds.orient_sample_work(12, 480, 640, 10, 0, 10, 35, 36, 2, 256).bytes \
        == 10 * 2 * 35 * 35 * 2


def test_sample_gradients_counts_sampled_rows():
    """A skipped keypoint costs only its plane index: 2048 keypoints of which
    400 are sampled move what 400 do, plus 1648 x 4 B of indices."""
    all_ = bounds.sample_gradients_work(12, 480, 640, 400, 256)
    some = bounds.sample_gradients_work(12, 480, 640, 2048, 256, sampled=400)
    assert some.bytes == all_.bytes + 1648 * 4 and some.ops == all_.ops
    assert bounds.sample_gradients_work(12, 480, 640, 2048, 256, sampled=2048) == \
        bounds.sample_gradients_work(12, 480, 640, 2048, 256)
    none = bounds.sample_gradients_work(12, 480, 640, 2048, 256, sampled=0)
    assert none.bytes == 2048 * 4 and none.ops == {"f32": 0}


def test_bound_sums_calls():
    """Five octaves' bound is the bound of their summed bytes (~78.6 MB at
    the main path's shapes: 23.5 us at 3.35 TB/s)."""
    shapes = [(480, 640), (240, 320), (120, 160), (60, 80), (30, 40)]
    works = [bounds.blur_octave_work(4, h, w, [5, 7, 8, 10, 13]) for h, w in shapes]
    total = sum(w.bytes for w in works)
    assert total == 12 * 4 * 4 * sum(h * w for h, w in shapes) == 78_566_400
    ms, by = bounds.bound(works)
    assert by == "bytes" and ms == pytest.approx(total / 3.35e9, rel=1e-12)
    assert bounds.bound([]) == (0.0, "bytes")
