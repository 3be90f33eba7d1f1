"""Fourier-domain convolution operators, dimension-generic (torch).

The port of ``ccsc_code_iccv2017_tpu.ops.fourier``: real FFTs over the
trailing ``ndim_s`` axes (torch.fft, the JAX package's ``xla`` impl, or
the matmul-DFT tiers ``matmul`` / ``matmul_high`` / ``matmul_bf16``),
padding/cropping of the spatial domain, the MATLAB ``psf2otf``
embedding, and the frequency-domain dictionary product.

Layout convention: FFT axes are ALWAYS the trailing ``ndim_s`` axes.
Frequency-flat forms put the flattened frequency axis last: dhat
[k, W, F], zhat [n, k, F], bhat [n, W, F] with W = prod(reduce_shape).
"""
from __future__ import annotations

import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def spatial_axes(x: torch.Tensor, ndim_s: int) -> Tuple[int, ...]:
    return tuple(range(x.ndim - ndim_s, x.ndim))


_MATMUL_IMPLS = ("matmul", "matmul_high", "matmul_bf16")


def rfftn_spatial(
    x: torch.Tensor, ndim_s: int, impl: str = "xla"
) -> torch.Tensor:
    if impl in _MATMUL_IMPLS:
        return _matmul_rfftn(x, ndim_s, impl)
    if impl != "xla":
        raise ValueError(f"unknown fft impl {impl!r}")
    return torch.fft.rfftn(x, dim=spatial_axes(x, ndim_s))


def irfftn_spatial(
    xh: torch.Tensor, spatial_shape: Sequence[int], impl: str = "xla"
) -> torch.Tensor:
    if impl in _MATMUL_IMPLS:
        return _matmul_irfftn(xh, tuple(spatial_shape), impl)
    if impl != "xla":
        raise ValueError(f"unknown fft impl {impl!r}")
    ndim_s = len(spatial_shape)
    return torch.fft.irfftn(
        xh, s=tuple(spatial_shape), dim=spatial_axes(xh, ndim_s)
    )


# --------------------------- matmul DFT ------------------------------
#
# The JAX package's DFT-as-matmul tiers (ops/fourier.py:79-224 there):
# one product with an explicit DFT matrix per transformed axis, the
# half-spectrum transform first on the (real) last axis. JAX runs them
# outside any Pallas kernel, as XLA dots; the port runs them as torch
# matrix products. Its three precisions map to three accuracy classes,
# computed the same way on the CPU and on the card and without any
# process-wide flag (allow_tf32 / set_float32_matmul_precision would
# change the numbers of every other thread):
#
# - 'matmul' (JAX HIGHEST): float32 products (complex64 matmul).
# - 'matmul_high' (JAX HIGH, 3-pass bf16): each real operand split as
#   hi + lo with hi = bf16(x), lo = bf16(x - hi); hi*hi + hi*lo + lo*hi
#   accumulated in float32.
# - 'matmul_bf16' (JAX DEFAULT): operands rounded to bf16, products
#   accumulated in float32, float32 out. (A bf16 ``@`` would round its
#   output to bf16 too: another class.)
#
# The bf16 classes multiply the bf16-rounded values in float32 matrix
# products (a product of two bf16 values is exact in float32), which
# gives the class's rounding exactly, on either device.

@functools.lru_cache(maxsize=None)
def _rdft_np(n: int) -> np.ndarray:
    """[n, n//2+1] forward half-spectrum DFT matrix (rfft)."""
    k = np.arange(n // 2 + 1)
    t = np.arange(n)[:, None] * k[None, :]
    return np.exp(-2j * np.pi * t / n).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _irdft_np(n: int) -> np.ndarray:
    """[n//2+1, n] inverse: x = Re(H @ W), W[k, t] = c_k/n exp(2j pi k
    t / n), c_k = 2 for interior bins (their conjugate halves are
    implicit), 1 for DC and (even n) Nyquist."""
    m = n // 2 + 1
    k = np.arange(m)
    c = np.full(m, 2.0)
    c[0] = 1.0
    if n % 2 == 0:
        c[-1] = 1.0
    t = k[:, None] * np.arange(n)[None, :]
    return (c[:, None] / n * np.exp(2j * np.pi * t / n)).astype(
        np.complex64)


@functools.lru_cache(maxsize=None)
def _dft_np(n: int, inverse: bool) -> np.ndarray:
    """[n, n] full complex DFT (or 1/n-scaled inverse) matrix."""
    t = np.arange(n)[:, None] * np.arange(n)[None, :]
    if inverse:
        return (np.exp(2j * np.pi * t / n) / n).astype(np.complex64)
    return np.exp(-2j * np.pi * t / n).astype(np.complex64)


_MAT_CACHE: dict = {}
_MAT_LOCK = threading.Lock()


def _mat(kind: str, n: int, device: torch.device) -> torch.Tensor:
    """A DFT matrix as a complex64 tensor on ``device``, built once per
    (kind, n, device)."""
    key = (kind, n, str(device))
    m = _MAT_CACHE.get(key)
    if m is None:
        src = {"rdft": lambda: _rdft_np(n), "irdft": lambda: _irdft_np(n),
               "dft": lambda: _dft_np(n, False),
               "idft": lambda: _dft_np(n, True)}[kind]()
        m = torch.from_numpy(src).to(device)
        with _MAT_LOCK:
            _MAT_CACHE[key] = m
    return m


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _rmm(a: torch.Tensor, m: torch.Tensor, impl: str) -> torch.Tensor:
    """Real float32 product a @ m in the accuracy class of ``impl``."""
    if impl == "matmul":
        return a @ m
    a_hi, m_hi = _bf16(a), _bf16(m)
    if impl == "matmul_bf16":
        return a_hi @ m_hi
    a_lo, m_lo = _bf16(a - a_hi), _bf16(m - m_hi)
    return a_hi @ m_hi + (a_hi @ m_lo + a_lo @ m_hi)


def _cmm(x: torch.Tensor, m: torch.Tensor, impl: str) -> torch.Tensor:
    """x @ m for a real or complex x and a complex m, in ``impl``'s
    class ('matmul': one complex64 product; the bf16 classes: the real
    products of the real and imaginary parts)."""
    if impl == "matmul":
        return (x.to(torch.complex64) if not x.is_complex() else x) @ m
    mr, mi = m.real.contiguous(), m.imag.contiguous()
    if not x.is_complex():
        return torch.complex(_rmm(x, mr, impl), _rmm(x, mi, impl))
    xr, xi = x.real, x.imag
    return torch.complex(_rmm(xr, mr, impl) - _rmm(xi, mi, impl),
                         _rmm(xr, mi, impl) + _rmm(xi, mr, impl))


def _apply_axis(x: torch.Tensor, m: torch.Tensor, axis: int,
                impl: str) -> torch.Tensor:
    """Contract ``m`` [n, k] against axis ``axis`` of x (the axis keeps
    its place in the order)."""
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        return _cmm(x, m, impl)
    return _cmm(x.movedim(axis, -1), m, impl).movedim(-1, axis)


def _matmul_rfftn(x: torch.Tensor, ndim_s: int, impl: str) -> torch.Tensor:
    """rfftn over the trailing ndim_s axes, one matrix product per axis:
    the half-spectrum transform of the last (real) axis first, then full
    complex DFTs of the narrowed spectrum."""
    if x.dtype == torch.float64:
        # the xla path would run a true f64 transform; truncating here
        # would make the two impls non-interchangeable
        raise ValueError(
            "fft_impl='matmul' computes in float32; use fft_impl='xla' "
            "for float64 inputs"
        )
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    xh = _apply_axis(x, _mat("rdft", x.shape[-1], x.device), -1, impl)
    for ax in range(x.ndim - ndim_s, x.ndim - 1):
        xh = _apply_axis(xh, _mat("dft", x.shape[ax], x.device), ax, impl)
    return xh


def _matmul_irfftn(xh: torch.Tensor, spatial_shape: Tuple[int, ...],
                   impl: str) -> torch.Tensor:
    ndim_s = len(spatial_shape)
    # unlike torch.fft.irfftn(s=...), the matmul path neither crops nor
    # pads a mismatched spectrum: demand the exact half-spectrum shape
    expect = tuple(spatial_shape[:-1]) + (spatial_shape[-1] // 2 + 1,)
    got = tuple(xh.shape[-ndim_s:])
    if got != expect:
        raise ValueError(
            f"fft_impl='matmul' inverse expects the exact half-spectrum "
            f"shape {expect} for spatial_shape={tuple(spatial_shape)}, "
            f"got {got}; crop/pad semantics are only available via "
            f"fft_impl='xla'"
        )
    if xh.dtype == torch.complex128:
        raise ValueError(
            "fft_impl='matmul' computes in float32; use fft_impl='xla' "
            "for complex128 spectra"
        )
    for i, ax in enumerate(range(xh.ndim - ndim_s, xh.ndim - 1)):
        xh = _apply_axis(xh, _mat("idft", spatial_shape[i], xh.device), ax,
                         impl)
    w = _mat("irdft", spatial_shape[-1], xh.device)
    wr, wi = w.real.contiguous(), w.imag.contiguous()
    xh = xh.to(torch.complex64)
    # only the real part survives: two real products instead of four
    return _rmm(xh.real, wr, impl) - _rmm(xh.imag, wi, impl)


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
