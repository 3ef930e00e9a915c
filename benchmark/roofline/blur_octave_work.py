"""The octave builder's work (`blur_octave_kernel`): the base read, L =
len(radii) + 1 Gaussian planes and L - 1 DoG planes written; per pixel and
level a row and a column pass of 2r + 1 taps (a multiply and an add each)
and one subtraction."""

from .peaks import F32, Work


def blur_octave_work(B: int, H: int, W: int, radii) -> Work:
    radii = list(radii)
    px = B * H * W
    planes = 1 + (len(radii) + 1) + len(radii)
    ops = px * sum(2 * 2 * (2 * r + 1) + 1 for r in radii)
    return Work(planes * px * F32, {"f32": ops})
