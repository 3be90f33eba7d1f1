"""The consensus learner's outer step, plain:
``admm_learn_conv2D_large_dzParallel.m``, block-local codes, at
learn_kernels_2D_large.m's operating point.

The data is split into L blocks of ni images. One outer step is

- the d-pass (dzParallel.m:96-121): each block's code spectra Z, the
  Woodbury inverse (rho_d I + Z Z^H)^-1 per frequency and the hoisted
  Z^H b; then ``max_it_d`` times: the global prox u = proj(dbar + udbar),
  each block's dual step and solve (rho_d I + Z^H Z) d = Z^H b +
  rho_d (u - dual), and the consensus averages dbar, udbar;
- the coding dictionary proj(dbar + udbar) and its spectra;
- the z-pass (each block's, :150-158): ``max_it_z`` times soft
  threshold, dual step and the rank-one solve (I + D^H D / rho_z) per
  frequency;
- the objective lambda_res/2 ||crop(D z) - b||^2 + lambda ||z||_1 after
  each pass, and the relative changes of dbar and of z.

State tensors follow the program's layout: d_local, dual_d [L, K, S, S]
(full-domain filters), dbar, udbar [K, S, S], z, dual_z
[L, ni, K, S, S], S the image side plus twice the filter radius.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import fourier


class State(NamedTuple):
    d_local: torch.Tensor
    dual_d: torch.Tensor
    dbar: torch.Tensor
    udbar: torch.Tensor
    z: torch.Tensor
    dual_z: torch.Tensor


def _rel(new: torch.Tensor, old: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(new - old)
                 / torch.clamp(torch.linalg.vector_norm(new), min=1e-30))


def objective(z, dhat, b, p: Dict) -> float:
    """lambda_res/2 ||crop(D z) - b||^2 + lambda ||z||_1, block by block."""
    S = z.shape[-1]
    r = (S - b.shape[-1]) // 2
    total = 0.0
    for zl, bl in zip(z, b):
        Dz = torch.fft.irfft2((dhat[None] * torch.fft.rfft2(zl)).sum(1),
                              s=(S, S))
        res = fourier.crop(Dz, r, *bl.shape[-2:]) - bl
        total += float(0.5 * p["lambda_residual"] * (res * res).sum()
                       + p["lambda_prior"] * zl.abs().sum())
    return total


def outer_step(st: State, b: torch.Tensor, p: Dict):
    """One outer step from ``st`` on the data b [L, ni, H, W] (the dtype
    of the state) -> (new state, {obj_d, obj_z, d_diff, z_diff})."""
    L = b.shape[0]
    S = st.z.shape[-1]
    r = (S - b.shape[-1]) // 2
    s = 2 * r + 1
    rho_d, rho_z = p["rho_d"], p["rho_z"]
    bhat = torch.fft.rfft2(fourier.pad_zero(b, r, (S, S)))  # [L, ni, Fy, Fx]

    # ---- d-pass ---------------------------------------------------
    Z, Ginv, Zb = [], [], []
    for l in range(L):
        zh = torch.fft.rfft2(st.z[l])  # [ni, K, Fy, Fx]
        G = torch.einsum("nkyx,mkyx->yxnm", zh, zh.conj())
        eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
        Ginv.append(torch.linalg.inv(G + rho_d * eye))
        Zb.append(torch.einsum("nkyx,nyx->kyx", zh.conj(), bhat[l]))
        Z.append(zh)
    d_local, dual_d, dbar, udbar = st.d_local, st.dual_d, st.dbar, st.udbar
    for _ in range(p["max_it_d"]):
        u = fourier.project_filters(dbar + udbar, s)
        dual = dual_d + (d_local - u)
        xi = torch.fft.rfft2(u - dual)  # [L, K, Fy, Fx]
        d_new = torch.empty_like(d_local)
        for l in range(L):
            rr = Zb[l] + rho_d * xi[l]
            t = torch.einsum("nkyx,kyx->nyx", Z[l], rr)
            sv = torch.einsum("yxnm,myx->nyx", Ginv[l], t)
            dh = (rr - torch.einsum("nkyx,nyx->kyx", Z[l].conj(), sv)) / rho_d
            d_new[l] = torch.fft.irfft2(dh, s=(S, S))
        dbar, udbar = d_new.sum(0) / L, dual.sum(0) / L
        d_local, dual_d = d_new, dual
    del Z, Ginv, Zb
    d_diff = _rel(dbar, st.dbar)
    dhat = torch.fft.rfft2(fourier.project_filters(dbar + udbar, s))
    obj_d = objective(st.z, dhat, b, p)

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
    z_diff = _rel(z_out, st.z)
    obj_z = objective(z_out, dhat, b, p)
    new = State(d_local, dual_d, dbar, udbar, z_out, dual_out)
    return new, {"obj_d": obj_d, "obj_z": obj_z, "d_diff": d_diff,
                 "z_diff": z_diff}
