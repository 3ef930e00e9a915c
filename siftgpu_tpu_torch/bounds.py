"""The least time an H100 could take for each kernel's work.

For a call, the bound is the larger of two times: the bytes the function
must move — each input byte read once, each output byte written once,
whatever the kernel reads again — over the card's memory rate, and the
operations it does on these inputs over the card's peak rate for their type
(the sum over types where a call mixes them).  Where the work depends on the
data (masked keypoints, orientation slots that are sampled), the counts are
this call's.  Published peaks of one H100 SXM at its full 700 W (NVIDIA's
data sheet, dense): 3.35 TB/s of HBM, 67 TFLOP/s in f32 outside the tensor
cores, 34 TFLOP/s in f64 outside the tensor cores, 1,979 TOP/s in int8.

Each `*_work` function takes a call's shapes and returns a `Work`; `bound`
turns a list of them into (ms, "bytes" | "operations").  Operation counts
per element are stated beside each function: a comparison, a min/max, a
conversion or a transcendental counts as one operation, so the counts are
small and the kernels are bound by bytes except `match_best2`.
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional, Tuple

__all__ = ["Work", "PEAK_BYTES_PER_S", "PEAK_OPS_PER_S", "bound", "blur_octave_work",
           "detect_scores_work", "grad_stencil_work", "orient_sample_work",
           "match_best2_work", "sample_gradients_work", "small_eig_work"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12, "int8": 1979e12}

F32, BF16, I32, U8 = 4, 2, 4, 1


class Work(NamedTuple):
    bytes: int
    ops: Dict[str, int]


def bound(works: Iterable[Work]) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") for the calls `works` together."""
    works = list(works)
    t_bytes = sum(w.bytes for w in works) / PEAK_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[k] for w in works for k, n in w.ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def blur_octave_work(B: int, H: int, W: int, radii) -> Work:
    """Kernel 6: the base read, L = len(radii) + 1 Gaussian planes and L - 1
    DoG planes written; per pixel and level a row and a column pass of
    2r + 1 taps (a multiply and an add each) and one subtraction."""
    radii = list(radii)
    px = B * H * W
    planes = 1 + (len(radii) + 1) + len(radii)
    ops = px * sum(2 * 2 * (2 * r + 1) + 1 for r in radii)
    return Work(planes * px * F32, {"f32": ops})


# detect_scores, per pixel of the S inner DoG slices: 26 maxima and 26
# minima, |v| and 4 tests, the Cramer record (79: the Hessian 3x3 and
# gradient differences, its adjugate, determinant, reciprocal, offsets and
# value), the edge test (7) and the corner packing (4)
DETECT_OPS_PER_PIXEL = 26 + 26 + 5 + 79 + 7 + 4


def detect_scores_work(B: int, S: int, H: int, W: int) -> Work:
    """Kernel 1: the DoG volume [B, S+2, H, W] read; two row-pooled score
    planes [B, S, He/2, We] and four record planes [B, S, He, We] written
    ((He, We) = (H, W) rounded up to even)."""
    He, We = H + H % 2, W + W % 2
    out = 2 * B * S * (He // 2) * We + 4 * B * S * He * We
    return Work((B * (S + 2) * H * W + out) * F32, {"f32": DETECT_OPS_PER_PIXEL * B * S * H * W})


def grad_stencil_work(B: int, S: int, H: int, W: int, Hp: int, Wp: int) -> Work:
    """Kernel 2: Gaussian levels 1..S read; gx, gy [B, S, Hp, Wp] bf16
    written; per pixel two differences, two halvings, two conversions."""
    return Work(B * S * H * W * F32 + 2 * B * S * Hp * Wp * BF16, {"f32": 6 * B * S * H * W})


# orient_sample, per window pixel: offsets and r^2 (5), the exponent (2),
# the degree-7 polynomial (14), the radius and row masks (3), the magnitude
# (4), atan2, wrap and bin (5), the histogram add (2); per sample: the grid
# coordinates (8), floor, clamps and fractions (10), the bilinear sums of two
# planes (22) and the image mask (5)
ORIENT_OPS_PER_PIXEL = 5 + 2 + 14 + 3 + 4 + 5 + 2
SAMPLE_OPS = 8 + 10 + 22 + 5


def orient_sample_work(P: int, Hp: int, Wp: int, N: int, n_masked: int, n_sampled: int,
                       win: int, nb: int, nori: int, G2: int) -> Work:
    """Kernel 3 on N keypoints, n_masked of them live, n_sampled
    orientation slots sampled (slot 0 of every live keypoint and each
    further slot with a peak).  Reads: the bf16 gx, gy planes, but no more
    than the live keypoints' windows; plane, y, x, sigma and mask per
    keypoint.  Writes: theta f32 and haspk bool [N, nori], sgx, sgy f32
    [N, nori * G2] (masked keypoints' zeros included).  Operations: the
    window pixels of live keypoints, the histogram's 6 smoothings and peak
    tests (nb x 30), and the samples of sampled slots."""
    grads = min(2 * P * Hp * Wp * BF16, n_masked * 2 * win * win * BF16)
    read = grads + N * (I32 + 3 * F32 + U8)
    write = N * nori * (F32 + U8) + 2 * N * nori * G2 * F32
    ops = n_masked * (win * win * ORIENT_OPS_PER_PIXEL + nb * 30) + n_sampled * G2 * SAMPLE_OPS
    return Work(read + write, {"f32": ops})


# match_best2 per pair (i, j): the 128-byte dot (2 x 128 int8 operations),
# then the two scalings and the best-2 and column updates (5 f32); the gates
# add, per pair, 5 f32 operations for "h" and 12 for "f"
GATE_OPS = {None: 0, "h": 5, "f": 12, "hf": 17}


def match_best2_work(P: int, N0: int, N1: int, D: int = 128, gate=None) -> Work:
    """Kernels 4 and 4g on P pairs of [N0, D] x [N1, D] uint8 sets: the
    descriptors, reciprocal norms and masks read (and, gated, the gate
    operands: 2/5/7 rows per row and 2/5/5 per column for h/f/hf); bsim,
    ssim, bestj [P, N0] and col_best_i [P, N1] written."""
    rows, cols = {None: (0, 0), "h": (2, 2), "f": (5, 5), "hf": (7, 5)}[gate]
    read = P * (N0 + N1) * (D * U8 + F32 + U8) + P * (rows * N0 + cols * N1) * F32
    write = P * N0 * 3 * F32 + P * N1 * I32
    pairs = P * N0 * N1
    return Work(read + write, {"int8": 2 * D * pairs, "f32": (5 + GATE_OPS[gate]) * pairs})


def sample_gradients_work(P: int, H: int, W: int, N: int, G2: int,
                          sampled: Optional[int] = None) -> Work:
    """Kernel 5 on N keypoints, `sampled` of them not skipped (all N by
    default): N plane indices read; for each sampled keypoint its G2 sample
    coordinates (y, x) read, the bf16 planes but no more than four taps per
    sample of each, and its sgx, sgy rows (G2 f32 each) written; per sample
    the floor, clamp, fraction and bilinear arithmetic of both planes."""
    n = N if sampled is None else sampled
    grads = min(2 * P * H * W * BF16, 2 * 4 * n * G2 * BF16)
    read = 2 * n * G2 * F32 + N * I32 + grads
    return Work(read + 2 * n * G2 * F32, {"f32": (SAMPLE_OPS - 8 - 5) * n * G2})


def small_eig_work(kind: str, B: int, n: int, tests: int, rotations: int) -> Work:
    """The small-matrix kernel (`ops/small_eig.py`): B matrices of n x n f32
    read (3 x 3 for "svd3"); "eigh" writes w [B, n] and V [B, n, n], "svd3"
    U, S and Vh.  In f64, the Jacobi work this input needs (`tests`
    convergence tests and `rotations` rotations, summed over the batch, as
    the plain version counts them): a test sums the squares of the upper
    triangle and the diagonal (2 ops an entry) and compares (2); a rotation
    forms theta, t, c, s (15) and updates two columns of V (6 ops an entry:
    6 n) and A: for n = 3, 4 two rows and two columns (12 n); for n = 9,
    whose rounds rotate the 2 x 2 blocks of the upper block triangle and
    mirror them, its columns in the blocks above it and its rows in those
    to its right (6 (n + 2) = 66 wherever it sits in the round).  Per matrix
    the load and symmetrisation, the stable sort and the signs (3 n^2);
    "svd3" adds A^T A (45), A V (45) and U's columns, norms, the cross
    product and S (60)."""
    per_test = 2 * (n * (n - 1) // 2 + n) + 2
    per_rotation = 15 + 6 * n + (6 * (n + 2) if n == 9 else 12 * n)
    ops = tests * per_test + rotations * per_rotation + B * 3 * n * n
    if kind == "eigh":
        nbytes = B * (n * n + n + n * n) * F32
    else:
        ops += B * (45 + 45 + 60)
        nbytes = B * (9 + 9 + 3 + 9) * F32
    return Work(nbytes, {"f64": ops})
