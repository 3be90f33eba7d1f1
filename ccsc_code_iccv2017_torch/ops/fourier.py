"""Fourier-domain convolution operators, dimension-generic (torch).

The port of ``ccsc_code_iccv2017_tpu.ops.fourier``: real FFTs over the
trailing ``ndim_s`` axes (torch.fft, the JAX package's ``xla`` impl),
padding/cropping of the spatial domain, the MATLAB ``psf2otf``
embedding, and the frequency-domain dictionary product.

Layout convention: FFT axes are ALWAYS the trailing ``ndim_s`` axes.
Frequency-flat forms put the flattened frequency axis last: dhat
[k, W, F], zhat [n, k, F], bhat [n, W, F] with W = prod(reduce_shape).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def spatial_axes(x: torch.Tensor, ndim_s: int) -> Tuple[int, ...]:
    return tuple(range(x.ndim - ndim_s, x.ndim))


def _check_impl(impl: str) -> None:
    if impl != "xla":
        raise NotImplementedError(
            f"fft impl {impl!r}: the matmul-DFT tiers are not ported yet "
            "(ROADMAP.md Queue 1 item 9)"
        )


def rfftn_spatial(
    x: torch.Tensor, ndim_s: int, impl: str = "xla"
) -> torch.Tensor:
    _check_impl(impl)
    return torch.fft.rfftn(x, dim=spatial_axes(x, ndim_s))


def irfftn_spatial(
    xh: torch.Tensor, spatial_shape: Sequence[int], impl: str = "xla"
) -> torch.Tensor:
    _check_impl(impl)
    ndim_s = len(spatial_shape)
    return torch.fft.irfftn(
        xh, s=tuple(spatial_shape), dim=spatial_axes(xh, ndim_s)
    )


def next_fast_size(n: int, mode: str = "none") -> int:
    """Round an FFT length up: 'none' keeps it, 'pow2' -> next power of
    two, 'fast' -> smallest 5-smooth (2^a 3^b 5^c) size >= n."""
    if mode == "none":
        return n
    pow2 = 1 << max(n - 1, 1).bit_length()
    if mode == "pow2":
        return pow2
    if mode == "fast":
        best = pow2
        p5 = 1
        while p5 <= best:
            p35 = p5
            while p35 <= best:
                x = p35
                while x < n:
                    x *= 2
                best = min(best, x)
                p35 *= 3
            p5 *= 5
        return best
    raise ValueError(f"unknown fft pad mode {mode!r}")


def _pad_symmetric_axis(
    x: torch.Tensor, axis: int, before: int, after: int
) -> torch.Tensor:
    """numpy's ``mode="symmetric"`` along one axis: the signal mirrored
    WITH its edge sample (``[c b a | a b c | c b a]``) — torch's
    ``reflect`` skips the edge, so the padding is built from ``flip``
    and ``cat``. The mirrored period ``[x, flip(x)]`` is tiled as often
    as the widths need, so pads wider than the axis repeat the
    reflection exactly as numpy does."""
    n = x.shape[axis]
    period = torch.cat([x, x.flip(axis)], dim=axis)  # length 2n
    start = (-before) % (2 * n)
    total = before + n + after
    reps = -(-(start + total) // (2 * n))
    tiled = torch.cat([period] * reps, dim=axis) if reps > 1 else period
    return tiled.narrow(axis, start, total)


def pad_spatial(
    x: torch.Tensor,
    radius: Sequence[int],
    mode: str = "zero",
    target: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Pad the trailing len(radius) spatial axes by radius on both sides.

    ``zero`` matches padarray(b, psf_radius, 0, 'both'); ``symmetric``
    matches padarray(smooth_init, psf_radius, 'symmetric', 'both').
    ``target`` places any EXTRA padding beyond radius after the trailing
    edge: [radius | data | radius | extra]. The data always sits at
    offset ``radius``.
    """
    ndim_s = len(radius)
    data = x.shape[x.ndim - ndim_s:]
    if target is None:
        widths = [(r, r) for r in radius]
    else:
        for r, d, t in zip(radius, data, target):
            if t - d - r < r:
                # a trailing pad narrower than radius would wrap filter
                # tails into the data under circular convolution
                raise ValueError(
                    f"target {t} leaves <radius trailing pad for data "
                    f"size {d}, radius {r}"
                )
        widths = [(r, t - d - r) for r, d, t in zip(radius, data, target)]
    if mode == "zero":
        # F.pad lists (before, after) pairs from the LAST axis backwards
        flat = [w for pair in reversed(widths) for w in pair]
        return F.pad(x, flat)
    if mode == "symmetric":
        for i, (lo, hi) in enumerate(widths):
            x = _pad_symmetric_axis(x, x.ndim - ndim_s + i, lo, hi)
        return x
    raise ValueError(f"unknown pad mode {mode!r}")


def crop_spatial(
    x: torch.Tensor,
    radius: Sequence[int],
    out_spatial: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Undo pad_spatial: the data region starts at ``radius``.
    ``out_spatial`` gives the data's spatial shape explicitly (needed
    when the domain carries extra fast-size padding)."""
    ndim_s = len(radius)
    if out_spatial is None:
        sl = [slice(None)] * (x.ndim - ndim_s) + [
            slice(r, d - r) for r, d in zip(radius, x.shape[-ndim_s:])
        ]
    else:
        sl = [slice(None)] * (x.ndim - ndim_s) + [
            slice(r, r + o) for r, o in zip(radius, out_spatial)
        ]
    return x[tuple(sl)]


def circ_embed(
    psf: torch.Tensor, spatial_shape: Sequence[int]
) -> torch.Tensor:
    """Zero-pad a centered filter to ``spatial_shape`` and roll its
    center to the origin — the spatial-domain half of MATLAB psf2otf.
    The filter support occupies the trailing len(spatial_shape) axes."""
    ndim_s = len(spatial_shape)
    support = psf.shape[psf.ndim - ndim_s:]
    flat = [
        w
        for full, s in reversed(list(zip(spatial_shape, support)))
        for w in (0, full - s)
    ]
    x = F.pad(psf, flat)
    shift = tuple(-(s // 2) for s in support)
    return torch.roll(x, shift, dims=spatial_axes(x, ndim_s))


def circ_extract(
    x: torch.Tensor, support: Sequence[int]
) -> torch.Tensor:
    """Inverse of circ_embed: roll the origin back to the filter center
    and crop the support."""
    ndim_s = len(support)
    shift = tuple(s // 2 for s in support)
    rolled = torch.roll(x, shift, dims=spatial_axes(x, ndim_s))
    sl = [slice(None)] * (x.ndim - ndim_s) + [slice(0, s) for s in support]
    return rolled[tuple(sl)]


def psf2otf(
    psf: torch.Tensor, spatial_shape: Sequence[int], impl: str = "xla"
) -> torch.Tensor:
    """rfftn of the origin-centered embedding of ``psf`` (MATLAB
    psf2otf up to the half-spectrum)."""
    return rfftn_spatial(
        circ_embed(psf, spatial_shape), len(spatial_shape), impl=impl
    )


def rfreq_shape(spatial_shape: Sequence[int]) -> Tuple[int, ...]:
    s = tuple(spatial_shape)
    return (*s[:-1], s[-1] // 2 + 1)


def apply_dictionary(
    dhat: torch.Tensor, zhat: torch.Tensor
) -> torch.Tensor:
    """Dz in the frequency domain: dhat [k, W, F], zhat [n, k, F] ->
    [n, W, F] (``sum(dhat .* z_hat, 3)`` of the reference)."""
    return torch.einsum("kwf,nkf->nwf", dhat, zhat)


def apply_dictionary_adjoint(
    dhat: torch.Tensor, rhat: torch.Tensor
) -> torch.Tensor:
    """D^H r: dhat [k, W, F], rhat [n, W, F] -> [n, k, F]."""
    return torch.einsum("kwf,nwf->nkf", dhat.conj(), rhat)
