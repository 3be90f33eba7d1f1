"""The consensus learner's outer step of :mod:`.consensus`, sharded over
the ranks of a ``torch.distributed`` process group: each rank holds its
own blocks of the data and of the block-local state, dbar and udbar are
replicated, and every sum over blocks is one all-reduce, as the
consensus averages of ``admm_learn_conv2D_large_dzParallel.m:115-121``
are on a mesh. The math is :func:`.consensus.outer_step`'s, line for
line; what crosses ranks:

- each d-iteration's consensus sums of the new local filters and of the
  duals (``d_new.sum(0)``, ``dual.sum(0)``), in one all-reduce;
- the objective's terms after each pass;
- the two squared norms behind the codes' relative change.

Plain ``torch`` and ``torch.distributed`` in the state's dtype (float64
by default): gloo on the CPU, NCCL on the card.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from . import fourier
from .consensus import State, _rel


def _sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the group's ranks (a fresh tensor)."""
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def objective(z, dhat, b, p: Dict, group=None) -> float:
    """lambda_res/2 ||crop(D z) - b||^2 + lambda ||z||_1 over every
    rank's blocks."""
    S = z.shape[-1]
    r = (S - b.shape[-1]) // 2
    fid = torch.zeros((), dtype=z.dtype, device=z.device)
    l1 = torch.zeros((), dtype=z.dtype, device=z.device)
    for zl, bl in zip(z, b):
        Dz = torch.fft.irfft2((dhat[None] * torch.fft.rfft2(zl)).sum(1),
                              s=(S, S))
        res = fourier.crop(Dz, r, *bl.shape[-2:]) - bl
        fid = fid + (res * res).sum()
        l1 = l1 + zl.abs().sum()
    terms = _sum(torch.stack([fid, l1]), group)
    return float(0.5 * p["lambda_residual"] * terms[0]
                 + p["lambda_prior"] * terms[1])


def outer_step(st: State, b: torch.Tensor, p: Dict, num_blocks: int,
               group=None):
    """One outer step from this rank's shard ``st`` on its data b
    [L, ni, H, W] (the state's dtype); ``num_blocks`` is the global
    block count. -> (new shard, {obj_d, obj_z, d_diff, z_diff}), the
    metrics the same on every rank."""
    L = b.shape[0]
    S = st.z.shape[-1]
    r = (S - b.shape[-1]) // 2
    s = 2 * r + 1
    rho_d, rho_z = p["rho_d"], p["rho_z"]
    bhat = torch.fft.rfft2(fourier.pad_zero(b, r, (S, S)))

    # ---- d-pass ---------------------------------------------------
    Z, Ginv, Zb = [], [], []
    for l in range(L):
        zh = torch.fft.rfft2(st.z[l])
        G = torch.einsum("nkyx,mkyx->yxnm", zh, zh.conj())
        eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
        Ginv.append(torch.linalg.inv(G + rho_d * eye))
        Zb.append(torch.einsum("nkyx,nyx->kyx", zh.conj(), bhat[l]))
        Z.append(zh)
    d_local, dual_d, dbar, udbar = st.d_local, st.dual_d, st.dbar, st.udbar
    for _ in range(p["max_it_d"]):
        u = fourier.project_filters(dbar + udbar, s)
        dual = dual_d + (d_local - u)
        xi = torch.fft.rfft2(u - dual)
        d_new = torch.empty_like(d_local)
        for l in range(L):
            rr = Zb[l] + rho_d * xi[l]
            t = torch.einsum("nkyx,kyx->nyx", Z[l], rr)
            sv = torch.einsum("yxnm,myx->nyx", Ginv[l], t)
            dh = (rr - torch.einsum("nkyx,nyx->kyx", Z[l].conj(), sv)) / rho_d
            d_new[l] = torch.fft.irfft2(dh, s=(S, S))
        sums = _sum(torch.stack([d_new.sum(0), dual.sum(0)]), group)
        dbar, udbar = sums[0] / num_blocks, sums[1] / num_blocks
        d_local, dual_d = d_new, dual
    del Z, Ginv, Zb
    d_diff = _rel(dbar, st.dbar)
    dhat = torch.fft.rfft2(fourier.project_filters(dbar + udbar, s))
    obj_d = objective(st.z, dhat, b, p, group)

    # ---- z-pass ---------------------------------------------------
    theta = p["lambda_prior"] / rho_z
    den = 1.0 + (dhat.abs() ** 2).sum(0) / rho_z
    z_out = torch.empty_like(st.z)
    dual_out = torch.empty_like(st.dual_z)
    for l in range(L):
        z, dual = st.z[l], st.dual_z[l]
        for _ in range(p["max_it_z"]):
            u2 = torch.sign(z + dual) * torch.clamp((z + dual).abs() - theta,
                                                    min=0)
            dual = dual + (z - u2)
            xi2 = torch.fft.rfft2(u2 - dual)
            g = (dhat.conj() * bhat[l][:, None] + rho_z * xi2) / rho_z
            t = (dhat * g).sum(1, keepdim=True)
            zh = g - dhat.conj() * (t / den) / rho_z
            z = torch.fft.irfft2(zh, s=(S, S))
        z_out[l], dual_out[l] = z, dual
    norms = _sum(torch.stack([torch.linalg.vector_norm(z_out - st.z),
                              torch.linalg.vector_norm(z_out)]) ** 2, group)
    z_diff = float(torch.sqrt(norms[0])
                   / torch.clamp(torch.sqrt(norms[1]), min=1e-30))
    obj_z = objective(z_out, dhat, b, p, group)
    new = State(d_local, dual_d, dbar, udbar, z_out, dual_out)
    return new, {"obj_d": obj_d, "obj_z": obj_z, "d_diff": d_diff,
                 "z_diff": z_diff}
