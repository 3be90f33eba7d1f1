"""Per-frequency linear solvers — the hot path of CCSC (torch port of
``ccsc_code_iccv2017_tpu.ops.freq_solvers``).

After FFT diagonalization both ADMM subproblems decouple into one tiny
linear system per frequency:

- z-subproblem: (Gamma + A_f^H A_f) x_f = rhs_f, A_f the W x K matrix of
  filter spectra. For W == 1 (every 2D problem) the system is rank-1
  and the Sherman-Morrison closed form is exact; the port carries it in
  the hand-written kernel K1 (ops.kernels). For W > 1 (hyperspectral
  bands, lightfield views) the Woodbury identity reduces it to a W x W
  Hermitian system per frequency, whose inverse is precomputed once;
  the JAX package runs that solve as XLA einsums outside any Pallas
  kernel, and the port runs it as torch einsums (cuBLAS) and a batched
  complex Cholesky (cuSOLVER).
- d-subproblem: (rho I_K + Z_f^H Z_f) x_f = rhs_f, Z_f the Ni x K matrix
  of code spectra, inverted by the Woodbury identity through an
  Ni x Ni Hermitian system (precompute_d_kernel / solve_d).

The ``mesh`` / ``axis_name`` arguments are the JAX package's
filter-axis sharding: the inputs hold this rank's K/nk shard of the
filters and every k-reduction is one psum over that mesh axis
(``_ksum``). A filter-sharded W == 1 solve takes the plain body, not K1,
as JAX does: K1 needs the whole k-sum inside one launch. The d-side
functions take leading batch axes (the learner's consensus blocks)
where JAX vmaps.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import mesh as mesh_lib
from . import kernels


def _ksum(x: torch.Tensor, mesh, axis_name: Optional[str]) -> torch.Tensor:
    """Sum a k-reduced partial across filter-axis shards (the identity
    without a filter axis)."""
    return mesh_lib.psum(x, mesh, axis_name)


def hermitian_inverse(
    G: torch.Tensor, method: Optional[str] = None
) -> torch.Tensor:
    """Inverse of a batch of Hermitian positive-definite complex
    matrices, G [..., m, m] -> G^{-1}, by a batched Cholesky factor and
    its inverse. ``torch.linalg`` takes complex64 directly, so the JAX
    package's real 2m x 2m block embedding (a TPU workaround) does not
    carry over. ``method`` None / 'auto' / 'cholesky' run this; 'schur'
    and 'newton' are not ported yet."""
    if method not in (None, "auto", "cholesky"):
        raise NotImplementedError(
            f"hermitian_inverse method {method!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 9); the port runs 'cholesky'"
        )
    return torch.cholesky_inverse(torch.linalg.cholesky(G))


class ZSolveKernel(NamedTuple):
    """Precomputed spectra for the z-subproblem solve.

    dhat:      [K, W, F] filter spectra (complex64).
    dinv:      [K, F] float32 — 1/diag(Gamma), Gamma_k(f) = rho + extra_k(f).
    minv:      [F, W, W] complex64 — (I_W + A Gamma^{-1} A^H)^{-1}, the
               Woodbury inner inverse; None when W == 1.
    minv_diag: [F] float32 — the W == 1 scalar
               1/(1 + sum_k |d_k|^2/Gamma_k); None when W > 1.
    """

    dhat: torch.Tensor
    dinv: torch.Tensor
    minv: Optional[torch.Tensor]
    minv_diag: Optional[torch.Tensor]


def precompute_z_kernel(
    dhat: torch.Tensor,
    rho: float,
    extra_diag: Optional[torch.Tensor] = None,
    herm_inv: Optional[str] = None,
    mesh=None,
    axis_name: Optional[str] = None,
) -> ZSolveKernel:
    """The per-frequency inverse factors of the z-solve. dhat: [K, W, F];
    extra_diag: optional [K, F] real, added to rho on the diagonal (the
    dirac channel's gradient regularization). ``herm_inv`` selects the
    W > 1 Gram inverse (``hermitian_inverse``) and is not read for
    W == 1. ``axis_name``: dhat holds this rank's filter shard; the
    k-sums are psummed over that axis of ``mesh``, so the inner inverse
    factors come out replicated."""
    K, W, F = dhat.shape
    dhat = dhat.contiguous()  # K1 reads it as one dense [K, F] array
    gamma = torch.full((K, F), float(rho), dtype=torch.float32,
                       device=dhat.device)
    if extra_diag is not None:
        gamma = gamma + extra_diag.to(torch.float32)
    dinv = 1.0 / gamma
    if W == 1:
        # scalar inner system: 1 + sum_k |d_k|^2 / Gamma_k
        m = 1.0 + _ksum(
            torch.sum(torch.abs(dhat[:, 0, :]) ** 2 * dinv, dim=0),
            mesh, axis_name,
        )
        return ZSolveKernel(dhat, dinv, None, 1.0 / m)
    # M_f = I_W + A Gamma^{-1} A^H, A = dhat[:, :, f].T (W x K)
    M = _ksum(
        torch.einsum("kvf,kwf->fvw", dhat * dinv[:, None, :], dhat.conj()),
        mesh, axis_name,
    )
    M = M + torch.eye(W, dtype=M.dtype, device=M.device)
    return ZSolveKernel(dhat, dinv, hermitian_inverse(M, herm_inv), None)


def solve_z(
    kernel: ZSolveKernel,
    xi1_hat: torch.Tensor,
    xi2_hat: torch.Tensor,
    rho: float,
    use_pallas: bool = False,
    mesh=None,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Solve (Gamma + A^H A) x = A^H xi1 + rho * xi2 per frequency.

    xi1_hat: [N, W, F] data-side target spectra; xi2_hat: [N, K, F]
    sparsity-side target spectra -> [N, K, F] code spectra.

    W == 1 runs K1 (ops.kernels.solve_z_rank1): on a CUDA tensor the
    hand-written kernel, on a CPU tensor its plain version. W > 1 runs
    the Woodbury body through the precomputed W x W inverse, as torch
    einsums on either device (no TPU kernel covers it). ``use_pallas``
    is accepted for signature parity with the JAX package and not read.
    ``axis_name``: filter-axis sharding (K is this rank's shard): the
    plain body with its one k-sum psummed over that axis of ``mesh``.
    """
    if kernel.minv is not None or axis_name is not None:
        return solve_z_reference(kernel, xi1_hat, xi2_hat, rho,
                                 mesh=mesh, axis_name=axis_name)
    # K1 reads dense arrays; a spectrum of a strided input may be strided
    return kernels.solve_z_rank1(
        kernel.dhat[:, 0, :],
        xi1_hat[:, 0, :].contiguous(),
        xi2_hat.contiguous(),
        float(rho),
        dinv=kernel.dinv,
    )


def solve_z_reference(
    kernel: ZSolveKernel,
    xi1_hat: torch.Tensor,
    xi2_hat: torch.Tensor,
    rho: float,
    mesh=None,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """The JAX package's einsum body of solve_z (freq_solvers.py:491-501)
    for any W, never launching K1: g = Gamma^{-1}(A^H xi1 + rho xi2),
    t = A g, s = Minv t, z = g - Gamma^{-1} A^H s, Minv the W x W
    inverse ``minv`` or, for W == 1, the scalar ``minv_diag``. The one
    k-sum, t, is psummed over ``axis_name`` (filter sharding)."""
    dhat, dinv = kernel.dhat, kernel.dinv
    dconj = dhat.conj()
    rhs = torch.einsum("kwf,nwf->nkf", dconj, xi1_hat) + rho * xi2_hat
    g = dinv[None] * rhs  # Gamma^{-1} rhs, [N, K, F]
    t = _ksum(torch.einsum("kwf,nkf->nwf", dhat, g), mesh,
              axis_name)  # A Ginv rhs, [N, W, F]
    if kernel.minv is None:
        s = kernel.minv_diag[None, None, :] * t
    else:
        s = torch.einsum("fvw,nwf->nvf", kernel.minv, t)
    return g - dinv[None] * torch.einsum("kwf,nwf->nkf", dconj, s)


class DSolveKernel(NamedTuple):
    """Precomputed factors for the d-subproblem (dictionary update).

    zhat: [..., Ni, K, F] code spectra of a consensus block.
    ginv: [..., F, Ni, Ni] complex — (rho I_Ni + Z Z^H)^{-1}, the Woodbury
          inner inverse.
    zb:   optional [..., K, W, F] — Z^H b, hoisted when the data-side
          target is constant across the inner d-iterations (the
          consensus learner). None when the target varies.
    """

    zhat: torch.Tensor
    ginv: torch.Tensor
    zb: Optional[torch.Tensor] = None


def precompute_d_kernel(
    zhat: torch.Tensor,
    rho: float,
    b_hat: Optional[torch.Tensor] = None,
    mesh=None,
    axis_name: Optional[str] = None,
) -> DSolveKernel:
    """zhat: [..., Ni, K, F]. ``b_hat`` [..., Ni, W, F]: pass the data
    spectra to hoist the constant Z^H b out of the d-iterations (k-local).
    ``axis_name``: K is this rank's filter shard; the code Gram's k-sum
    is psummed over that axis of ``mesh`` before the complex Cholesky,
    so the Ni x Ni inverse is replicated across filter shards."""
    Ni = zhat.shape[-3]
    G = _ksum(torch.einsum("...nkf,...mkf->...fnm", zhat, zhat.conj()),
              mesh, axis_name)
    G = G + rho * torch.eye(Ni, dtype=G.dtype, device=G.device)
    zb = None
    if b_hat is not None:
        zb = torch.einsum("...nkf,...nwf->...kwf", zhat.conj(), b_hat)
    return DSolveKernel(zhat, hermitian_inverse(G), zb)


def solve_d(
    kernel: DSolveKernel,
    b_hat: Optional[torch.Tensor],
    xi_hat: torch.Tensor,
    rho: float,
    mesh=None,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Solve (rho I_K + Z^H Z) x = Z^H b + rho * xi per frequency.

    b_hat: [..., Ni, W, F] data spectra (None with a hoisted kernel);
    xi_hat: [..., K, W, F] target filter spectra -> [..., K, W, F] new
    filter spectra. Woodbury: x = (r - Z^H (rho I + Z Z^H)^{-1} Z r) / rho
    with r = Z^H b + rho * xi (solve_conv_term_D, dParallel.m:252-276).
    ``axis_name``: filter sharding; the k-sum Z r is psummed over it.
    """
    zhat, ginv = kernel.zhat, kernel.ginv
    if kernel.zb is not None:
        if b_hat is not None:
            # a hoisted kernel bakes in its own data target
            raise ValueError(
                "kernel was built with a hoisted b_hat; pass b_hat=None"
            )
        zb = kernel.zb
    else:
        zb = torch.einsum("...nkf,...nwf->...kwf", zhat.conj(), b_hat)
    r = zb + rho * xi_hat
    t = _ksum(torch.einsum("...nkf,...kwf->...nwf", zhat, r), mesh,
              axis_name)
    s = torch.einsum("...fnm,...mwf->...nwf", ginv, t)
    return (r - torch.einsum("...nkf,...nwf->...kwf", zhat.conj(), s)) / rho
