"""The 2D inpainting solve, plain: ``2D/Inpainting/reconstruct_2D_subsampling.m``
with ``admm_solve_conv2D_weighted_sparse_reconstruction.m``.

Minimises lambda_res/2 ||M (crop(D z) + s) - b||^2 + lambda ||z||_1 by
ADMM over the two splits v1 = D z (data side) and v2 = z (sparsity
side), with scaled duals and one exact per-frequency z-solve an
iteration (Sherman-Morrison: rank one, since the data has one channel).
The domain is the image padded by the filter radius; ``s`` is the
smooth-fill warm start the client sends. The stop test is the
reference's: the relative change of z below ``tol``, or ``max_it``
iterations.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import fourier


def solve(b, mask, smooth, d, params: Dict, dtype=torch.float64
          ) -> Tuple[torch.Tensor, int]:
    """One request: b, mask, smooth [H, W] and the bank d [K, s, s]
    (tensors on one device) -> (the reconstruction [H, W] in ``dtype``,
    the iterations run). ``params``: lambda_residual, lambda_prior,
    max_it, tol, gamma_factor, gamma_ratio."""
    b, mask, smooth, d = (t.to(dtype) for t in (b, mask, smooth, d))
    H, W = b.shape
    s = d.shape[-1]
    r = s // 2
    size = (H + 2 * r, W + 2 * r)
    lam_res, lam = params["lambda_residual"], params["lambda_prior"]

    B = fourier.pad_zero(b, r, size)
    M = fourier.pad_zero(mask, r, size)
    S = fourier.pad_symmetric(smooth, r)
    MtM = M * M
    Mtb = B * M - S * M

    # the gamma heuristic on the observed data
    g = params["gamma_factor"] * lam / torch.clamp((mask * b).max(), min=1e-30)
    gamma1, gamma2 = g / params["gamma_ratio"], g
    rho = gamma2 / gamma1
    theta1, theta2 = lam_res / gamma1, lam / gamma2

    dhat = fourier.otf(d, size)  # [K, Fy, Fx]
    den = 1.0 + (dhat.abs() ** 2).sum(0) / rho  # the rank-one system

    def z_solve(xi1, xi2):
        rhs = dhat.conj() * xi1 + rho * xi2
        gz = rhs / rho
        t = (dhat * gz).sum(0)
        return gz - dhat.conj() * (t / den) / rho

    def Dz(zhat):
        return torch.fft.irfft2((dhat * zhat).sum(0), s=size)

    K = d.shape[0]
    z = b.new_zeros((K, *size))
    zhat = torch.fft.rfft2(z)
    v1 = Dz(zhat)
    d1 = torch.zeros_like(v1)
    d2 = torch.zeros_like(z)
    it, diff = 0, float("inf")
    while it < params["max_it"] and diff >= params["tol"]:
        u1 = (Mtb + (v1 - d1) / theta1) / (MtM + 1.0 / theta1)
        u2_raw = z - d2
        u2 = torch.sign(u2_raw) * torch.clamp(u2_raw.abs() - theta2, min=0)
        d1 = d1 - (v1 - u1)
        d2 = d2 - (z - u2)
        zhat = z_solve(torch.fft.rfft2(u1 + d1), torch.fft.rfft2(u2 + d2))
        z_new = torch.fft.irfft2(zhat, s=size)
        v1 = Dz(zhat)
        diff = float(torch.linalg.vector_norm(z_new - z)
                     / torch.clamp(torch.linalg.vector_norm(z_new),
                                   min=1e-30))
        z = z_new
        it += 1
    return fourier.crop(Dz(zhat) + S, r, H, W), it
