"""The benchmark's inputs, made on the device from the seed.

Frozen recipes, copied at commit 72032356832fccc0fed74691f2666c2a15816fcf:
`siftgpu_tpu_torch/oracle/fixtures.py::random_texture` (uniform noise, a
(2s+1)-tap box blur along the rows and then the columns, edges
replicated) and `chip_smoke.py::make_frames` (a texture shifted by a
whole number of pixels a frame, which `warp_affine` does exactly; here the
frames are crops of one larger texture, so new content enters at the
edges as a moving camera sees it), and `chip_smoke.py::large_sets` (uint8
sets whose correspondences carry 10% of their bytes moved by up to +-2).

Every seed gives the same sizes: the seed changes the values only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["generator", "textures", "sequence", "descriptor_sets", "all_pairs"]


def generator(device, seed: int, stream: int = 0) -> torch.Generator:
    """A generator on `device` for `seed` (any whole number below 2**62)
    and an input stream number."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 62))
    return g


def _box_blur(x: torch.Tensor, smooth: int) -> torch.Tensor:
    """[N, H, W]: the (2s+1)-tap mean along the rows, then the columns,
    replicated edges."""
    k = 2 * smooth + 1
    w = torch.full((1, 1, 1, k), 1.0 / k, dtype=torch.float32, device=x.device)
    y = F.conv2d(F.pad(x[:, None], (smooth, smooth, 0, 0), mode="replicate"), w)
    return F.conv2d(F.pad(y, (0, 0, smooth, smooth), mode="replicate"), w.view(1, 1, k, 1))[:, 0]


def textures(n: int, h: int, w: int, smooth: int, g: torch.Generator, device) -> torch.Tensor:
    """n independent smoothed random textures [n, h, w] f32 in [0, 1]."""
    out = torch.empty((n, h, w), dtype=torch.float32, device=device)
    for i in range(n):  # one at a time: the blur's temporaries stay one image large
        out[i] = _box_blur(torch.rand((1, h, w), generator=g, device=device), smooth)[0]
    return out


def sequence(n: int, h: int, w: int, shift, smooth: int, g, device) -> torch.Tensor:
    """n frames [n, h, w] of one texture seen by a camera that moves
    (dx, dy) = `shift` px a frame: frame k at (y, x) shows the texture at
    (y - k dy, x - k dx)."""
    dx, dy = int(shift[0]), int(shift[1])
    big = textures(1, h + abs(dy) * (n - 1), w + abs(dx) * (n - 1), smooth, g, device)[0]
    oy, ox = max(0, dy) * (n - 1), max(0, dx) * (n - 1)
    return torch.stack([big[oy - dy * k: oy - dy * k + h, ox - dx * k: ox - dx * k + w]
                        for k in range(n)]).contiguous()


def _sift_like(n: int, g, device, clip: float = 0.2) -> torch.Tensor:
    """n uint8 rows made as SIFT makes them: non-negative, normalised,
    clipped at `clip`, renormalised, x512, rounded and clipped to 255."""
    raw = -torch.log(torch.rand((n, 128), generator=g, device=device).clamp(min=1e-7)) ** 2
    d = raw / raw.norm(dim=1, keepdim=True).clamp(min=1e-12)
    d = d.clamp(max=clip)
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-12)
    return torch.clamp(torch.floor(512.0 * d + 0.5), 0, 255).to(torch.uint8)


def descriptor_sets(sets: int, per_set: int, overlap: float, noise_share: float, noise_max: int,
                    g, device) -> torch.Tensor:
    """[sets, per_set, 128] uint8: set i observes rows [i s, i s + per_set)
    of a scene pool, s = per_set (1 - overlap), in its own seeded order;
    `noise_share` of each observation's bytes move by up to +-noise_max."""
    step = max(1, int(round(per_set * (1.0 - overlap))))
    pool = _sift_like(step * (sets - 1) + per_set, g, device)
    out = torch.empty((sets, per_set, 128), dtype=torch.uint8, device=device)
    for i in range(sets):
        rows = pool[i * step + torch.randperm(per_set, generator=g, device=device)]
        noise = torch.randint(-noise_max, noise_max + 1, rows.shape, generator=g, device=device)
        noise = noise * (torch.rand(rows.shape, generator=g, device=device) < noise_share)
        out[i] = torch.clamp(rows.to(torch.int32) + noise, 0, 255).to(torch.uint8)
    return out


def all_pairs(n: int):
    """The n (n - 1) / 2 unordered pairs (i, j), i < j, in order."""
    return [(i, j) for i in range(n) for j in range(i + 1, n)]
