"""The fused orientation + sampling work (`orient_sample_kernel`) on N
keypoints, n_masked of them live, n_sampled orientation slots sampled.
Reads: the bf16 gx, gy planes, but no more than the live keypoints'
windows; plane, y, x, sigma and mask per keypoint.  Writes: theta f32 and
haspk bool [N, nori], sgx, sgy f32 [N, nori * G2].  Operations: per window
pixel of a live keypoint offsets and r^2 (5), the exponent (2), the
degree-7 polynomial (14), the radius and row masks (3), the magnitude (4),
atan2, wrap and bin (5), the histogram add (2); the histogram's 6
smoothings and peak tests (nb x 30); per sample of a sampled slot the grid
coordinates (8), floor, clamps and fractions (10), the bilinear sums of two
planes (22) and the image mask (5)."""

from .peaks import BF16, F32, I32, U8, Work

ORIENT_OPS_PER_PIXEL = 5 + 2 + 14 + 3 + 4 + 5 + 2
SAMPLE_OPS = 8 + 10 + 22 + 5


def orient_sample_work(P: int, Hp: int, Wp: int, N: int, n_masked: int, n_sampled: int,
                       win: int, nb: int, nori: int, G2: int) -> Work:
    grads = min(2 * P * Hp * Wp * BF16, n_masked * 2 * win * win * BF16)
    read = grads + N * (I32 + 3 * F32 + U8)
    write = N * nori * (F32 + U8) + 2 * N * nori * G2 * F32
    ops = n_masked * (win * win * ORIENT_OPS_PER_PIXEL + nb * 30) + n_sampled * G2 * SAMPLE_OPS
    return Work(read + write, {"f32": ops})
