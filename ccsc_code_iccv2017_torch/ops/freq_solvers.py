"""Per-frequency z-solve — the hot path of the reconstruction solve
(torch port of ``ccsc_code_iccv2017_tpu.ops.freq_solvers``).

After FFT diagonalization the z-subproblem decouples into one tiny
linear system per frequency, (Gamma + A_f^H A_f) x_f = rhs_f, with A_f
the W x K matrix of filter spectra. For W == 1 (every 2D problem) the
system is rank-1 and the Sherman-Morrison closed form is exact; the
port carries it in the hand-written kernel K1 (ops.kernels). The W > 1
Woodbury path and the d-side solve come with later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import kernels


class ZSolveKernel(NamedTuple):
    """Precomputed spectra for the z-subproblem solve.

    dhat:      [K, W, F] filter spectra (complex64).
    dinv:      [K, F] float32 — 1/diag(Gamma), Gamma_k(f) = rho + extra_k(f).
    minv:      [F, W, W] complex — None when W == 1 (always, in this
               slice).
    minv_diag: [F] float32 — the W == 1 scalar
               1/(1 + sum_k |d_k|^2/Gamma_k).
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
) -> ZSolveKernel:
    """The per-frequency inverse factors of the z-solve. dhat: [K, W, F];
    extra_diag: optional [K, F] real, added to rho on the diagonal (the
    dirac channel's gradient regularization). ``herm_inv`` only selects
    the W > 1 Gram inverse and is not read for W == 1."""
    K, W, F = dhat.shape
    if W != 1:
        raise NotImplementedError(
            f"W={W}: the W > 1 Woodbury z-solve is not ported yet "
            "(ROADMAP.md Queue 1 item 7)"
        )
    gamma = torch.full((K, F), float(rho), dtype=torch.float32,
                       device=dhat.device)
    if extra_diag is not None:
        gamma = gamma + extra_diag.to(torch.float32)
    dinv = 1.0 / gamma
    # scalar inner system: 1 + sum_k |d_k|^2 / Gamma_k
    m = 1.0 + torch.sum(torch.abs(dhat[:, 0, :]) ** 2 * dinv, dim=0)
    return ZSolveKernel(dhat, dinv, None, 1.0 / m)


def solve_z(
    kernel: ZSolveKernel,
    xi1_hat: torch.Tensor,
    xi2_hat: torch.Tensor,
    rho: float,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Solve (Gamma + A^H A) x = A^H xi1 + rho * xi2 per frequency.

    xi1_hat: [N, W, F] data-side target spectra; xi2_hat: [N, K, F]
    sparsity-side target spectra -> [N, K, F] code spectra.

    Runs K1 (ops.kernels.solve_z_rank1): on a CUDA tensor the
    hand-written kernel, on a CPU tensor its plain version.
    ``use_pallas`` is accepted for signature parity with the JAX
    package and not read.
    """
    if kernel.minv is not None:
        raise NotImplementedError(
            "the W > 1 Woodbury z-solve is not ported yet "
            "(ROADMAP.md Queue 1 item 7)"
        )
    return kernels.solve_z_rank1(
        kernel.dhat[:, 0, :],
        xi1_hat[:, 0, :],
        xi2_hat,
        float(rho),
        dinv=kernel.dinv,
    )


def solve_z_reference(
    kernel: ZSolveKernel,
    xi1_hat: torch.Tensor,
    xi2_hat: torch.Tensor,
    rho: float,
) -> torch.Tensor:
    """The JAX package's einsum body of solve_z (freq_solvers.py:491-501),
    W == 1: Sherman-Morrison through the precomputed ``minv_diag``."""
    dhat, dinv = kernel.dhat, kernel.dinv
    rhs = torch.einsum("kwf,nwf->nkf", dhat.conj(), xi1_hat) + rho * xi2_hat
    g = dinv[None] * rhs  # Gamma^{-1} rhs, [N, K, F]
    t = torch.einsum("kwf,nkf->nwf", dhat, g)  # A Ginv rhs
    s = kernel.minv_diag[None, None, :] * t
    return g - dinv[None] * torch.einsum("kwf,nwf->nkf", dhat.conj(), s)
