"""The best-2 match reduction's work (`match_best2_kernel` and its split
merge, `merge_rows_kernel`) on P pairs of [N0, D] x [N1, D] uint8 sets: the
descriptors, reciprocal norms and masks read; bsim, ssim, bestj [P, N0] and
col_best_i [P, N1] written; per pair (i, j) the D-byte dot (2 D int8
operations), then the two scalings and the best-2 and column updates (5
f32)."""

from .peaks import F32, I32, U8, Work


def match_best2_work(P: int, N0: int, N1: int, D: int = 128) -> Work:
    read = P * (N0 + N1) * (D * U8 + F32 + U8)
    write = P * N0 * 3 * F32 + P * N1 * I32
    pairs = P * N0 * N1
    return Work(read + write, {"int8": 2 * D * pairs, "f32": 5 * pairs})
