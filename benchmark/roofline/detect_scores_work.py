"""The dense score pass's work (`detect_scores_kernel`): the DoG volume
[B, S+2, H, W] read; two row-pooled score planes [B, S, He/2, We] and four
record planes [B, S, He, We] written ((He, We) = (H, W) rounded up to
even).  Per pixel of the S inner slices: 26 maxima and 26 minima, |v| and 4
tests, the Cramer record (79), the edge test (7) and the corner packing (4)."""

from .peaks import F32, Work

DETECT_OPS_PER_PIXEL = 26 + 26 + 5 + 79 + 7 + 4


def detect_scores_work(B: int, S: int, H: int, W: int) -> Work:
    He, We = H + H % 2, W + W % 2
    out = 2 * B * S * (He // 2) * We + 4 * B * S * He * We
    return Work((B * (S + 2) * H * W + out) * F32, {"f32": DETECT_OPS_PER_PIXEL * B * S * H * W})
