"""FFT plumbing of the reference: zero and symmetric padding, cropping,
the origin-centred embedding of a filter (MATLAB psf2otf's spatial
half) and the unit-ball projection of the learner's filters."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def pad_zero(x: torch.Tensor, r: int, size: Sequence[int]) -> torch.Tensor:
    """[..., H, W] placed at offset (r, r) in zeros of [..., *size]."""
    out = x.new_zeros((*x.shape[:-2], *size))
    out[..., r:r + x.shape[-2], r:r + x.shape[-1]] = x
    return out


def pad_symmetric(x: torch.Tensor, r: int) -> torch.Tensor:
    """padarray(x, [r r], 'symmetric', 'both'): mirrored with the edge
    sample, for r no wider than the image."""
    top, bottom = x[..., :r, :].flip(-2), x[..., -r:, :].flip(-2)
    x = torch.cat([top, x, bottom], -2)
    left, right = x[..., :, :r].flip(-1), x[..., :, -r:].flip(-1)
    return torch.cat([left, x, right], -1)


def crop(x: torch.Tensor, r: int, h: int, w: int) -> torch.Tensor:
    return x[..., r:r + h, r:r + w]


def embed(d: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Filters [..., s, s] zero-padded to [..., *size] with their centre
    rolled to the origin."""
    s = d.shape[-1]
    out = d.new_zeros((*d.shape[:-2], *size))
    out[..., :s, :s] = d
    return torch.roll(out, (-(s // 2), -(s // 2)), dims=(-2, -1))


def extract(d_full: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of :func:`embed`: the centred s x s support."""
    rolled = torch.roll(d_full, (s // 2, s // 2), dims=(-2, -1))
    return rolled[..., :s, :s]


def otf(d: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Half spectra of the filters [..., s, s] on the domain ``size``."""
    return torch.fft.rfft2(embed(d, size))


def project_filters(d_full: torch.Tensor, s: int) -> torch.Tensor:
    """KernelConstraintProj (dzParallel.m:208): the centred s x s
    support, each filter scaled onto the unit l2 ball when outside it,
    re-embedded at the origin."""
    sup = extract(d_full, s)
    sq = (sup * sup).sum((-2, -1), keepdim=True)
    scale = torch.where(sq >= 1.0, sq.clamp(min=1e-30).rsqrt(),
                        torch.ones_like(sq))
    return embed(sup * scale, d_full.shape[-2:])


def gaussian(size: int, sigma: float, dtype, device) -> torch.Tensor:
    """fspecial('gaussian', [size size], sigma)."""
    r = (size - 1) / 2
    t = torch.arange(size, dtype=dtype, device=device) - r
    g = torch.exp(-(t[:, None] ** 2 + t[None, :] ** 2) / (2 * sigma * sigma))
    return g / g.sum()


def rconv2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """'same' convolution of [n, H, W] with reflected (symmetric) edges
    (image_helpers/rconv2.m); ``k`` is symmetric, so correlation is
    convolution."""
    r = k.shape[-1] // 2
    xp = pad_symmetric(x, r)
    return F.conv2d(xp[:, None], k[None, None])[:, 0]
