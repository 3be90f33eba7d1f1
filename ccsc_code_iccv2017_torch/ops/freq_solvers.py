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
  Gram inverse: Cholesky by default (on the card the hand-written kernel
  of ops.herm_inv, elsewhere the library's), or the Schur recursion or
  the Newton-Schulz iteration (batched products, as in JAX), chosen by
  ``herm_inv`` / ``CCSC_HERM_INV``.
- d-subproblem: (rho I_K + Z_f^H Z_f) x_f = rhs_f, Z_f the Ni x K matrix
  of code spectra, inverted by the Woodbury identity through an
  Ni x Ni Hermitian system (precompute_d_kernel / solve_d); on the card
  the consensus learner's solve is the hand-written kernel of
  ops.d_solve, over code spectra kept frequency-major.

The ``mesh`` / ``axis_name`` arguments are the JAX package's
filter-axis sharding: the inputs hold this rank's K/nk shard of the
filters and every k-reduction is one psum over that mesh axis
(``_ksum``). A filter-sharded W == 1 solve takes the plain body, not K1,
as JAX does: K1 needs the whole k-sum inside one launch. The d-side
functions take leading batch axes (the learner's consensus blocks)
where JAX vmaps.
"""
from __future__ import annotations

import threading
import warnings
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..parallel import mesh as mesh_lib
from ..utils import env
from . import d_solve as d_solve_kernel
from . import herm_inv as herm_inv_kernel
from . import kernels


def _ksum(x: torch.Tensor, mesh, axis_name: Optional[str]) -> torch.Tensor:
    """Sum a k-reduced partial across filter-axis shards (the identity
    without a filter axis)."""
    return mesh_lib.psum(x, mesh, axis_name)


def resolve_herm_method(m: int, method: Optional[str] = None) -> str:
    """The concrete Gram-inverse method that will run for an m x m
    system: explicit ``method`` > ``CCSC_HERM_INV`` > 'auto'. The JAX
    package resolves 'auto' to its Schur recursion for some m on the TPU
    only; on the CPU and the card 'auto' is the batched Cholesky, so
    every default path runs what it ran before the other methods were
    ported."""
    if method is None:
        method = env.env_str("CCSC_HERM_INV") or "auto"
    if method == "auto":
        return "cholesky"
    if method not in ("cholesky", "schur", "newton"):
        raise ValueError(
            f"hermitian_inverse method must be 'auto' | 'cholesky' | "
            f"'schur' | 'newton', got {method!r}"
        )
    return method


def _on_kernel_route(G: torch.Tensor) -> bool:
    return herm_inv_kernel.route(G.device.type, G.dtype,
                                 G.shape[-1]) == "kernel"


def _adj(x: torch.Tensor) -> torch.Tensor:
    return x.conj().transpose(-1, -2)


def _hermitian_inverse_schur(G: torch.Tensor) -> torch.Tensor:
    """Exact batched Hermitian-PD inverse by Schur-complement block
    recursion, batched matrix products all the way down:

    inv([[A, B], [B^H, D]]) = [[Ai + T Si T^H, -T Si], [-Si T^H, Si]],
    T = Ai B, S = D - B^H T, recursing on A and S (block Cholesky in
    disguise, valid for Hermitian PD input). The products run in
    float32 (complex64 cuBLAS; the port sets no TF32 flag), the
    accuracy class of JAX's HIGHEST precision."""
    m = G.shape[-1]
    if m == 1:
        return 1.0 / G
    if m == 2:
        a = G[..., 0:1, 0:1]
        b = G[..., 0:1, 1:2]
        d = G[..., 1:2, 1:2]
        det = a * d - b * b.conj()
        top = torch.cat([d, -b], dim=-1)
        bot = torch.cat([-b.conj(), a], dim=-1)
        return torch.cat([top, bot], dim=-2) / det
    h = m // 2
    A = G[..., :h, :h]
    B = G[..., :h, h:]
    D = G[..., h:, h:]
    Ai = _hermitian_inverse_schur(A)
    T = Ai @ B
    S = D - _adj(B) @ T
    Si = _hermitian_inverse_schur(S)
    TSi = T @ Si
    TL = Ai + TSi @ _adj(T)
    top = torch.cat([TL, -TSi], dim=-1)
    # bottom-left = -Si T^H, the top-right's conjugate transpose
    bot = torch.cat([-_adj(TSi), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def resolve_newton_iters(iters: Optional[int] = None) -> int:
    """Iteration count of the Newton-Schulz inverse: explicit arg >
    ``CCSC_HERM_INV_ITERS`` > 30. The default reaches the float32 floor
    for condition numbers up to ~3e4 (the JAX package's measured
    window); the iteration needs about 4 + log2(cond * m) steps, so
    past that window raise the count or keep the condition guard on."""
    if iters is not None:
        return iters
    return env.env_int("CCSC_HERM_INV_ITERS")


def _hermitian_inverse_newton(
    G: torch.Tensor, iters: Optional[int] = None
) -> torch.Tensor:
    """Batched Hermitian-PD inverse by Newton-Schulz iteration,
    X_{k+1} = X_k (2 I - G X_k), from X_0 = I / ||G||_inf (every
    eigenvalue of G lies in (0, ||G||_inf], so the residual starts
    below 1 and converges quadratically). Two batched complex products
    a step; one Hermitian symmetrization at the end."""
    iters = resolve_newton_iters(iters)
    m = G.shape[-1]
    # ||G||_inf = max_i sum_j |G_ij| (equals ||G||_1 for Hermitian G)
    norm = torch.amax(torch.sum(torch.abs(G), dim=-1), dim=-1)
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    x = eye / norm[..., None, None].to(G.dtype)
    two_eye = 2.0 * eye
    for _ in range(iters):
        x = x @ (two_eye - G @ x)
    return 0.5 * (x + _adj(x))


def _newton_cond_window() -> float:
    """The condition-number window of the default Newton iteration
    count (``CCSC_NEWTON_COND_MAX``, default 3e4)."""
    return env.env_float("CCSC_NEWTON_COND_MAX")


def _power_lam_max(A: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Largest-eigenvalue estimate of a batch of Hermitian PD matrices
    [..., m, m] by ``iters`` deterministic power-iteration steps from an
    all-ones start."""
    v = torch.ones((*A.shape[:-2], A.shape[-1], 1), dtype=A.dtype,
                   device=A.device)
    for _ in range(iters):
        w = A @ v
        nrm = torch.linalg.vector_norm(w, dim=-2, keepdim=True)
        v = w / torch.clamp(nrm, min=1e-30)
    return torch.linalg.vector_norm(A @ v, dim=(-2, -1))


# Guard verdicts not reported yet: (event or None, [bad, cond]); on the
# card the pair is copied into pinned host memory behind the event, see
# _newton_with_cond_guard.
_pending_guard: List[Tuple[object, torch.Tensor]] = []
_pending_lock = threading.Lock()


def _warn_newton_cond(cond: float) -> None:
    warnings.warn(
        f"Newton-Schulz Gram inverse: estimated condition number "
        f"{cond:.3g} exceeds the ~{_newton_cond_window():.0e} validity "
        "window of the default iteration count — falling back to the "
        "direct (Cholesky) inverse for this kernel. Raise "
        "CCSC_HERM_INV_ITERS to stay on the matmul path."
    )


def report_newton_guard(wait: bool = False) -> int:
    """Warn for every Newton guard verdict whose device work has
    finished (all of them with ``wait``, which synchronizes on their
    events); returns how many fell back to Cholesky. A verdict from the
    card lands in pinned host memory behind a CUDA event and is read
    only once ``Event.query`` says it has arrived, so the guard adds no
    host read to a learner step: its warning comes at a later call."""
    fell = 0
    with _pending_lock:
        keep = []
        for ev, verdict in _pending_guard:
            if ev is not None:
                if not wait and not ev.query():
                    keep.append((ev, verdict))
                    continue
                ev.synchronize()
            bad, cond = verdict.tolist()
            if bad:
                fell += 1
                _warn_newton_cond(cond)
        _pending_guard[:] = keep
    return fell


def _newton_with_cond_guard(
    G: torch.Tensor, newton_iters: Optional[int]
) -> torch.Tensor:
    """Newton-Schulz inverse with a condition estimate and a fallback to
    the direct inverse.

    cond(G) is estimated as lam_max(G) * lam_max(X) by two power
    iterations (X, the Newton inverse, tracks G^-1 well enough that its
    top eigenvalue tracks 1/lam_min(G)); when the batch-max estimate is
    past the window, or not finite, the Cholesky inverse replaces X.

    The guard's form differs from JAX's ``lax.cond``, which runs one
    branch: deciding on the host would read the device inside a
    learner step, which has one read (one a chunk under the chunked
    driver). So the select is on the device: ``torch.where`` over both
    branches, the Cholesky one by ``cholesky_ex`` (which, unlike
    ``cholesky``, checks nothing on the host). The guard thus costs a
    Cholesky besides the Newton iteration; ``CCSC_NEWTON_COND_GUARD=0``
    drops both it and the estimate (trust the iteration count). The
    warning is reported without a fence (:func:`report_newton_guard`)."""
    X = _hermitian_inverse_newton(G, newton_iters)
    if not env.env_flag("CCSC_NEWTON_COND_GUARD"):
        return X
    cond = torch.amax(_power_lam_max(G) * _power_lam_max(X))
    # fail closed on a non-finite estimate: the iterate itself blew up
    bad = torch.logical_not(cond <= _newton_cond_window())
    L, _info = torch.linalg.cholesky_ex(G)
    out = torch.where(bad, torch.cholesky_inverse(L), X)
    verdict = torch.stack([bad.to(torch.float64), cond.to(torch.float64)])
    ev = None
    if G.is_cuda:
        host = torch.empty(2, dtype=torch.float64, pin_memory=True)
        host.copy_(verdict, non_blocking=True)
        verdict = host
        ev = torch.cuda.Event()
        ev.record()
    with _pending_lock:
        _pending_guard.append((ev, verdict))
    report_newton_guard(wait=not G.is_cuda)
    return out


def hermitian_inverse(
    G: torch.Tensor,
    method: Optional[str] = None,
    newton_iters: Optional[int] = None,
) -> torch.Tensor:
    """Inverse of a batch of Hermitian positive-definite complex
    matrices, G [..., m, m] -> G^{-1}.

    ``method`` (resolve_herm_method; None reads ``CCSC_HERM_INV``):
    'cholesky' (the default on every device of the port) a batched
    Cholesky factor and its inverse, on the card by the hand-written
    kernel (ops.herm_inv: complex64, m <= its MAX_M), elsewhere by the
    library; 'schur' the all-matmul block
    recursion; 'newton' the Newton-Schulz iteration with its condition
    guard (``newton_iters`` > ``CCSC_HERM_INV_ITERS`` > 30). All three
    are exact to float32 rounding on well-conditioned input (the JAX
    package's tests/test_ops.py tolerances)."""
    method = resolve_herm_method(G.shape[-1], method)
    if method == "schur":
        return _hermitian_inverse_schur(G)
    if method == "newton":
        return _newton_with_cond_guard(G, newton_iters)
    if _on_kernel_route(G):
        return herm_inv_kernel.invert(G.contiguous())
    return herm_inv_kernel.plain(G)


def shifted_hermitian_inverse(G: torch.Tensor, shift: float,
                              method: Optional[str] = None) -> torch.Tensor:
    """(G + shift I)^{-1} (:func:`hermitian_inverse`), G consumed: on the
    Cholesky kernel's route the kernel adds the shift as it loads each
    matrix and writes the inverse over G's storage (no shifted copy, no
    second [..., m, m] buffer); on every other route G + shift I is
    formed first, as before."""
    m = G.shape[-1]
    if resolve_herm_method(m, method) == "cholesky" and _on_kernel_route(G):
        G = G.contiguous()
        return herm_inv_kernel.invert(G, shift, out=G)
    return hermitian_inverse(
        G + shift * torch.eye(m, dtype=G.dtype, device=G.device), method)


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
    return ZSolveKernel(dhat, dinv, shifted_hermitian_inverse(M, 1.0,
                                                              herm_inv),
                        None)


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

    zhat: [..., F, Ni, K] code spectra of a consensus block, frequency-
          major: contiguous where the d-solve kernel reads them
          (ops.d_solve; solve_d reads the route from the layout), else a
          view of the k-major [..., Ni, K, F] spectra, which the einsum
          body reads back as they were.
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
    on_phase: Optional[Callable[[str], None]] = None,
) -> DSolveKernel:
    """zhat: [..., Ni, K, F]. ``b_hat`` [..., Ni, W, F]: pass the data
    spectra to hoist the constant Z^H b out of the d-iterations (k-local).
    ``axis_name``: K is this rank's filter shard; the code Gram's k-sum
    is psummed over that axis of ``mesh`` before the complex Cholesky,
    so the Ni x Ni inverse is replicated across filter shards.
    ``on_phase`` (optional) is called with "inv_start" and "inv_end"
    around the Gram's inverse (the learner's PhaseTimer).

    Where :func:`solve_d` will take the d-solve kernel (a hoisted target,
    no filter axis, ops.d_solve's route), the spectra are transposed
    once to frequency-major and the Gram Z Z^H and Z^H b are batched
    products over that copy, the conjugate read as a conjugate-transpose
    operand; everywhere else the kernel holds the einsums' results of
    the k-major spectra, as before."""
    mark = on_phase or (lambda _name: None)
    zt = zhat.movedim(-1, -3)  # [..., F, Ni, K]
    fmajor = b_hat is not None and axis_name is None and \
        d_solve_kernel.route(zhat.device.type, zhat.dtype, *zt.shape[-2:],
                             b_hat.shape[-2]) == "kernel"
    if fmajor:
        zt = zt.contiguous()
        G = zt @ zt.mH
        # Z^H b as the conjugate of b^H Z: the conjugate taken of the
        # small product, not of the codes
        zb = (b_hat.movedim(-1, -3).mH @ zt).conj_physical()  # [.., F, W, K]
        zb = zb.permute(*range(zb.ndim - 3), -1, -2, -3).contiguous()
    else:
        G = _ksum(torch.einsum("...nkf,...mkf->...fnm", zhat, zhat.conj()),
                  mesh, axis_name)
        zb = None
        if b_hat is not None:
            zb = torch.einsum("...nkf,...nwf->...kwf", zhat.conj(), b_hat)
    mark("inv_start")
    ginv = shifted_hermitian_inverse(G, rho)
    mark("inv_end")
    if fmajor:
        ginv = ginv.contiguous()  # as the Cholesky kernel writes it
    return DSolveKernel(zt, ginv, zb)


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

    A hoisted kernel without a filter axis whose spectra
    :func:`precompute_d_kernel` made frequency-major (contiguous
    complex64: the layout carries its route) runs the d-solve kernel;
    every other call runs the einsum body, :func:`solve_d_reference`.
    """
    zhat = kernel.zhat
    if kernel.zb is not None and b_hat is None and axis_name is None \
            and zhat.dtype == torch.complex64 and zhat.is_contiguous():
        return d_solve_kernel.solve(zhat, kernel.ginv, kernel.zb,
                                    xi_hat.contiguous(), float(rho))
    return solve_d_reference(kernel, b_hat, xi_hat, rho, mesh=mesh,
                             axis_name=axis_name)


def solve_d_reference(
    kernel: DSolveKernel,
    b_hat: Optional[torch.Tensor],
    xi_hat: torch.Tensor,
    rho: float,
    mesh=None,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """The JAX package's einsum body of solve_d for any caller, never
    launching the d-solve kernel: r = Z^H b + rho xi (Z^H b hoisted in
    the kernel, or from ``b_hat``), t = Z r (psummed over
    ``axis_name``), s = ginv t, x = (r - Z^H s) / rho, over the code
    spectra's k-major view."""
    zhat, ginv = kernel.zhat.movedim(-3, -1), kernel.ginv  # [..., Ni, K, F]
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
