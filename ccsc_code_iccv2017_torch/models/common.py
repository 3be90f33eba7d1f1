"""Shared model-level plumbing: frequency geometry, spectra, objectives
(torch port of ``ccsc_code_iccv2017_tpu.models.common``). The ``mesh`` /
axis arguments reduce across the ranks of a parallel.mesh.Mesh and are
the identity without one.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import ProblemGeom
from ..ops import fourier
from ..parallel import mesh as mesh_lib


class FreqGeom(NamedTuple):
    """Static frequency-domain geometry for one problem instance."""

    spatial_shape: Tuple[int, ...]  # padded spatial shape
    freq_shape: Tuple[int, ...]  # rfft spectrum shape
    num_freq: int  # F = prod(freq_shape)
    reduce_shape: Tuple[int, ...]
    reduce_size: int  # W
    fft_impl: str = "xla"

    @classmethod
    def create(
        cls,
        geom: ProblemGeom,
        data_spatial: Sequence[int],
        pad: bool = True,
        fft_pad: str = "none",
        fft_impl: str = "xla",
    ) -> "FreqGeom":
        """``fft_pad`` ('none' | 'pow2' | 'fast') rounds the padded FFT
        domain up (fourier.next_fast_size); the data sits at offset
        psf_radius, extra zeros trail. Requires ``pad``."""
        if fft_pad != "none" and not pad:
            raise ValueError("fft_pad requires a padded problem domain")
        sp = (
            geom.padded_shape(tuple(data_spatial))
            if pad
            else tuple(data_spatial)
        )
        sp = tuple(fourier.next_fast_size(int(s), fft_pad) for s in sp)
        fs = fourier.rfreq_shape(sp)
        return cls(
            sp, fs, math.prod(fs), tuple(geom.reduce_shape),
            geom.reduce_size, fft_impl,
        )


def filters_to_freq(d: torch.Tensor, fg: FreqGeom) -> torch.Tensor:
    """Support-domain filters [k, *reduce, *support] -> dhat [k, W, F]."""
    dh = fourier.psf2otf(d, fg.spatial_shape, impl=fg.fft_impl)
    return dh.reshape(d.shape[0], fg.reduce_size, fg.num_freq)


def full_filters_to_freq(d_full: torch.Tensor, fg: FreqGeom) -> torch.Tensor:
    """Full-domain (origin-centered) filters [..., k, *reduce, *spatial]
    -> dhat [..., k, W, F]; leading axes (the learner's blocks) pass
    through."""
    ndim_s = len(fg.spatial_shape)
    dh = fourier.rfftn_spatial(d_full, ndim_s, impl=fg.fft_impl)
    lead = d_full.shape[: d_full.ndim - ndim_s - len(fg.reduce_shape)]
    return dh.reshape(*lead, fg.reduce_size, fg.num_freq)


def data_to_freq(b_pad: torch.Tensor, fg: FreqGeom) -> torch.Tensor:
    """Padded data [n, *reduce, *spatial] -> bhat [n, W, F]."""
    ndim_s = len(fg.spatial_shape)
    bh = fourier.rfftn_spatial(b_pad, ndim_s, impl=fg.fft_impl)
    return bh.reshape(b_pad.shape[0], fg.reduce_size, fg.num_freq)


def codes_to_freq(z: torch.Tensor, fg: FreqGeom) -> torch.Tensor:
    """Codes [n, k, *spatial] -> zhat [n, k, F]."""
    zh = fourier.rfftn_spatial(z, len(fg.spatial_shape), impl=fg.fft_impl)
    return zh.reshape(z.shape[0], z.shape[1], fg.num_freq)


def codes_from_freq(zhat: torch.Tensor, fg: FreqGeom) -> torch.Tensor:
    zh = zhat.reshape(*zhat.shape[:-1], *fg.freq_shape)
    return fourier.irfftn_spatial(zh, fg.spatial_shape, impl=fg.fft_impl)


def recon_from_freq(
    dhat: torch.Tensor, zhat: torch.Tensor, fg: FreqGeom,
    mesh=None, filter_axis: Optional[str] = None,
) -> torch.Tensor:
    """Dz in real space: [n, *reduce, *spatial] (reduce axes restored).
    ``filter_axis``: dhat/zhat hold this rank's k shard; the filter sum
    is completed by one psum over that mesh axis before the inverse
    FFT."""
    Dzh = mesh_lib.psum(
        fourier.apply_dictionary(dhat, zhat), mesh, filter_axis
    )  # [n, W, F]
    Dzh = Dzh.reshape(Dzh.shape[0], *fg.reduce_shape, *fg.freq_shape)
    return fourier.irfftn_spatial(Dzh, fg.spatial_shape, impl=fg.fft_impl)


def data_fidelity(
    Dz: torch.Tensor,
    b: torch.Tensor,
    radius: Sequence[int],
    lambda_residual: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """lambda_res/2 * || mask .* (crop(Dz) - b) ||^2."""
    r = fourier.crop_spatial(Dz, radius, b.shape[-len(radius):]) - b
    if mask is not None:
        r = mask * r
    return 0.5 * lambda_residual * torch.sum(r * r)


def l1_penalty(z: torch.Tensor, lambda_prior: float) -> torch.Tensor:
    return lambda_prior * torch.sum(torch.abs(z))


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the leading (slot) one: [n, ...] -> [n].
    For n == 1 the same bits as ``torch.sum``."""
    return x.reshape(x.shape[0], -1).sum(1)


def rel_change(
    new: torch.Tensor, old: torch.Tensor, per_slot: bool = False,
    mesh=None, axis=None,
) -> torch.Tensor:
    """||new - old|| / ||new|| — the reference's termination metric.
    bf16-stored iterates accumulate in f32. ``per_slot``: one value per
    leading index ([n]), each slot's own metric. ``axis``: the arrays
    are shards over that mesh axis; both norms are reduced across it, so
    every rank reads the global metric (and takes the same decision)."""
    total = slot_sum if per_slot else torch.sum
    new = new.to(torch.float32)
    old = old.to(torch.float32)
    num = mesh_lib.psum(total((new - old) ** 2), mesh, axis)
    den = mesh_lib.psum(total(new**2), mesh, axis)
    return torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-30)


def psnr(
    x: torch.Tensor, ref: torch.Tensor, crop: Sequence[int] = (),
    per_slot: bool = False, mesh=None, axis: Optional[str] = None,
) -> torch.Tensor:
    """PSNR against a [0,1] reference, optionally cropping a border.
    ``per_slot``: one value per leading index ([n]). ``axis``: a mesh
    axis of equal-sized batch shards; the mse is averaged over it,
    which is the global mse."""
    if crop:
        x = fourier.crop_spatial(x, crop)
        ref = fourier.crop_spatial(ref, crop)
    sq = (x - ref) ** 2
    mse = sq.reshape(sq.shape[0], -1).mean(1) if per_slot else torch.mean(sq)
    if mesh is not None and axis is not None:
        mse = mesh_lib.psum(mse, mesh, axis) / mesh.shape[axis]
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
