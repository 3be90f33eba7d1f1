"""Proximal operators of the CCSC objective (torch port of
``ccsc_code_iccv2017_tpu.ops.proxes``). ``kernel_constraint_proj``
comes with the learner (ROADMAP.md Queue 1 item 5)."""
from __future__ import annotations

from typing import Optional

import torch


def soft_threshold(u: torch.Tensor, theta) -> torch.Tensor:
    """l1 prox: max(0, 1 - theta/|u|) .* u, written multiplication-free
    in |u| to avoid the 0/0 at u == 0."""
    return torch.sign(u) * torch.clamp(torch.abs(u) - theta, min=0.0)


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
