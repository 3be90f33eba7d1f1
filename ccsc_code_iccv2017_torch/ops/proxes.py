"""Proximal operators of the CCSC objective (torch port of
``ccsc_code_iccv2017_tpu.ops.proxes``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import fourier


def soft_threshold(u: torch.Tensor, theta) -> torch.Tensor:
    """l1 prox: max(0, 1 - theta/|u|) .* u, written multiplication-free
    in |u| to avoid the 0/0 at u == 0."""
    return torch.sign(u) * torch.clamp(torch.abs(u) - theta, min=0.0)


def kernel_constraint_proj(
    d_full: torch.Tensor,
    support: Sequence[int],
    spatial_shape: Sequence[int],
    norm_over_reduce: bool = False,
) -> torch.Tensor:
    """Project full-domain filters onto {supp(d) in support, ||d|| <= 1}
    (KernelConstraintProj, admm_learn_conv2D_large_dParallel.m:201-219):
    extract the centered support, scale each filter onto the unit l2
    ball if outside it, re-embed at the origin.

    d_full: [k, *reduce, *spatial_padded]. Each (filter, reduce-slice)
    is normed over the spatial dims; ``norm_over_reduce=True`` norms
    jointly over reduce+spatial (one ball per filter)."""
    ndim_s = len(support)
    d_sup = fourier.circ_extract(d_full, support)
    if norm_over_reduce:
        axes = tuple(range(1, d_sup.ndim))
    else:
        axes = tuple(range(d_sup.ndim - ndim_s, d_sup.ndim))
    sq = torch.sum(d_sup * d_sup, dim=axes, keepdim=True)
    scale = torch.where(
        sq >= 1.0, 1.0 / torch.sqrt(torch.clamp(sq, min=1e-30)),
        torch.ones_like(sq),
    )
    return fourier.circ_embed(d_sup * scale, spatial_shape)


def masked_quadratic_prox(
    u: torch.Tensor, theta, MtM: torch.Tensor, Mtb: torch.Tensor
) -> torch.Tensor:
    """Weighted data prox (Mtb + u/theta) ./ (MtM + 1/theta). MtM is the
    padded squared mask, Mtb the padded masked data (with any
    smooth-init offset already subtracted)."""
    return (Mtb + u / theta) / (MtM + 1.0 / theta)


def poisson_prox(
    u: torch.Tensor, theta, mask: torch.Tensor, I_padded: torch.Tensor
) -> torch.Tensor:
    """Exact Poisson negative-log-likelihood prox on observed pixels,
    identity elsewhere:
    p = 0.5 * (u - theta + sqrt((u - theta)^2 + 4 theta I))."""
    p = 0.5 * (
        u - theta + torch.sqrt((u - theta) ** 2 + 4.0 * theta * I_padded)
    )
    return torch.where(mask > 0, p, u)


def skip_channels(
    u_proxed: torch.Tensor,
    u_raw: torch.Tensor,
    channel_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Pass selected filter channels through un-proxed. channel_mask is
    a [k] bool tensor, True = apply prox; u_* are [n, k, *spatial]."""
    if channel_mask is None:
        return u_proxed
    shape = (1, -1) + (1,) * (u_proxed.ndim - 2)
    return torch.where(channel_mask.reshape(shape), u_proxed, u_raw)
