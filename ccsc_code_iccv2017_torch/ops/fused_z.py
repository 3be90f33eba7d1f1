"""K2: one fused z-ADMM inner iteration of the 2D consensus learner, as
two hand-written Hopper kernels (K2a, K2b), with its plain version.

Counterpart of ``ccsc_code_iccv2017_tpu/ops/pallas_fused_z.py``:
``fused_z_iter`` replaces ``kernel_a`` (``pallas_call`` at :262) and
``kernel_b`` (``pallas_call`` at :311). Per image n and filter k, on one
[Sy, Sx] plane (Fx = Sx // 2 + 1)::

    pass A  s = z + du, u2 = soft(s, theta), dual' = s - u2,
            xihat = rfft2(2 u2 - s), g = conj(d_k) bhat_n / rho + xihat,
            t_n = sum_k d_k g_k
    pass B  zhat = g - conj(d_k) (minv .* t_n) / rho,  z' = irfft2(zhat)

(``models/learn.py``'s z_iter composition, dzParallel.m:150-158, to
float tolerance). The CUDA source is ``csrc/fused_z.cu`` (sm_90a; its
header says what bounds it and how it is laid out): full f32 arithmetic
on the CUDA cores, the JAX kernel's ``"highest"`` tier. The state loads
and stores honour the storage dtype (float32 or bfloat16); all math is
f32. The k-sum of pass A runs in a fixed order per image, so two
launches on the same inputs give the same bits.

A block holds one whole plane in shared memory, so K2 takes planes up
to :data:`_MAX_SMEM` bytes (:func:`smem_bytes`, square planes up to
168²); :func:`fits` is the shape test the learner's gate reads before
it routes a z-pass here (``models/learn.py::fused_z_ok``).

``fused_z_iter`` takes the plain version ``fused_z_iter_reference`` only
for tensors on the CPU; for CUDA tensors it launches both kernels or
raises. ``fused_z_iter.launches_a`` / ``.launches_b`` count launches
(``kernels.count_launch``, under a lock).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernels, proxes

# the card's per-block shared-memory limit (H100: 227 KB)
_MAX_SMEM = 232448
STORAGE_DTYPES = (torch.float32, torch.bfloat16)
# csrc/fused_z.cu's kMaxFactor: the longest sub-DFT of a split axis
_MAX_FACTOR = 16


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ccsc_fused_z_pass_a.argtypes = [p, p, p, p, p, p, i, i, i, i, f, f,
                                        i, p]
    lib.ccsc_fused_z_pass_a.restype = ctypes.c_int
    lib.ccsc_fused_z_pass_b.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f,
                                        f, i, p]
    lib.ccsc_fused_z_pass_b.restype = ctypes.c_int
    lib.ccsc_fused_z_smem_bytes.argtypes = [i, i, i]
    lib.ccsc_fused_z_smem_bytes.restype = ctypes.c_size_t
    return lib


def _library() -> ctypes.CDLL:
    return kernels.bound_library("fused_z", _bind)


def plan_axis(S: int) -> Tuple[int, int]:
    """``csrc/fused_z.cu::plan_axis``: an axis S = P * Q, P the largest
    divisor with P <= sqrt(S); (1, S), the dense routines, where none
    exists or Q would exceed the longest sub-DFT."""
    P = 1
    p = 2
    while p * p <= S:
        if S % p == 0:
            P = p
        p += 1
    if P == 1 or S // P > _MAX_FACTOR:
        return 1, S
    return P, S // P


def _odd_pitch(n: int) -> int:
    return n | 1


def smem_bytes(Sy: int, Sx: int, pass_b: bool) -> int:
    """Shared memory one block of a pass takes for an Sy x Sx plane: the
    twin of ``csrc/fused_z.cu::smem_bytes`` (held to the library's
    ``ccsc_fused_z_smem_bytes`` on the card)."""
    Fx = Sx // 2 + 1
    tw = 8 * (Sx + Sy)
    a = 8 * Sy * _odd_pitch(Fx)
    if plan_axis(Sx)[0] > 1:
        r = 8 * ((Sy + 1) // 2) * _odd_pitch(Sx)
    else:
        r = 4 * Sy * Sx
    if pass_b and plan_axis(Sy)[0] == 1 and a > r:
        r = a
    return tw + a + r + 4 * (Sx + Sy)


def fits(Sy: int, Sx: int) -> bool:
    """Whether both passes take an Sy x Sx plane within the card's
    per-block shared memory."""
    return all(smem_bytes(Sy, Sx, b) <= _MAX_SMEM for b in (False, True))


def reference_pass_a(
    z: torch.Tensor,
    dual: torch.Tensor,
    bhat: torch.Tensor,
    dhat: torch.Tensor,
    rho: float,
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of pass A -> (dual' in the storage dtype, t
    [N, Sy, Fx] complex64, or complex128 for float64 state)."""
    s = _widen(z) + _widen(dual)
    u2 = proxes.soft_threshold(s, theta)
    dual_new = s - u2
    g = _g(s, u2, bhat, dhat, rho)
    t = torch.sum(dhat[None] * g, dim=1)
    return dual_new.to(z.dtype), t


def reference_pass_b(
    z: torch.Tensor,
    dual: torch.Tensor,
    bhat: torch.Tensor,
    dhat: torch.Tensor,
    minv_diag: torch.Tensor,
    t: torch.Tensor,
    rho: float,
    theta: float,
) -> torch.Tensor:
    """Plain version of pass B (with the between-pass s = minv .* t) ->
    z' in the storage dtype."""
    s = _widen(z) + _widen(dual)
    g = _g(s, proxes.soft_threshold(s, theta), bhat, dhat, rho)
    s_f = minv_diag[None] * t
    zhat = g - dhat.conj()[None] * s_f[:, None] / rho
    z_new = torch.fft.irfft2(zhat, s=tuple(z.shape[-2:]))
    return z_new.to(z.dtype)


def _widen(x):
    """The plain version's math dtype: float32 for float32 or bfloat16
    state, float64 for float64 state (an accuracy yardstick only; the
    kernels take float32 or bfloat16)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _g(s, u2, bhat, dhat, rho):
    xihat = torch.fft.rfft2(2.0 * u2 - s)
    return dhat.conj()[None] * bhat[:, None] / rho + xihat


def fused_z_iter_reference(
    z: torch.Tensor,
    dual: torch.Tensor,
    bhat: torch.Tensor,
    dhat: torch.Tensor,
    minv_diag: torch.Tensor,
    rho: float,
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the fused iteration (the JAX package's
    ``fused_z_iter_reference``, pallas_fused_z.py:327): pass A, then
    pass B. -> (z', dual'), both in the storage dtype. Given float64
    state and complex128 spectra it computes in float64 throughout."""
    dual_new, t = reference_pass_a(z, dual, bhat, dhat, rho, theta)
    z_new = reference_pass_b(z, dual, bhat, dhat, minv_diag, t, rho, theta)
    return z_new, dual_new


def _check_inputs(z, dual, bhat, dhat, minv_diag, rho, theta):
    for name, v in (("rho", rho), ("theta", theta)):
        if not isinstance(v, (int, float)):
            raise TypeError(f"{name} must be a python number, got {type(v)}")
    if z.ndim != 4:
        raise ValueError(f"z must be [N, K, Sy, Sx], got {tuple(z.shape)}")
    N, K, Sy, Sx = z.shape
    Fx = Sx // 2 + 1
    dev = z.device
    if z.dtype not in STORAGE_DTYPES:
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    kernels._check("z", z, (N, K, Sy, Sx), z.dtype, dev)
    kernels._check("dual", dual, (N, K, Sy, Sx), z.dtype, dev)
    kernels._check("bhat", bhat, (N, Sy, Fx), torch.complex64, dev)
    kernels._check("dhat", dhat, (K, Sy, Fx), torch.complex64, dev)
    if minv_diag is not None:
        kernels._check("minv_diag", minv_diag, (Sy, Fx), torch.float32, dev)
    return N, K, Sy, Sx, Fx


def _launch_args(z, N, K, Sy, Sx, rho, theta):
    if not (1 <= N and 1 <= K and N * K < 2**31):
        raise ValueError(f"K2 takes 1 <= N*K < 2^31 planes, got {N}x{K}")
    lib = _library()
    for pass_b in (0, 1):
        need = lib.ccsc_fused_z_smem_bytes(Sy, Sx, pass_b)
        if need > _MAX_SMEM:
            raise ValueError(
                f"a {Sy}x{Sx} plane needs {need} bytes of shared memory "
                f"per block, above the card's {_MAX_SMEM}: K2 holds a "
                "whole plane a block. The learner's gate "
                "(models/learn.py::fused_z_ok) routes such planes to the "
                "composition z-iteration (K1); call that, or tile the "
                "plane first (ROADMAP.md Queue 2 item 2)"
            )
    return (N, K, Sy, Sx, 1.0 / float(rho), float(theta),
            int(z.dtype == torch.bfloat16),
            torch.cuda.current_stream(z.device).cuda_stream)


def _route(z) -> bool:
    """True for CUDA tensors (launch the kernels), False for CPU tensors
    (the plain version); any other device raises."""
    if z.device.type == "cpu":
        return False
    if z.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu, not {z.device}")
    return True


def pass_a(z, dual, bhat, dhat, rho, theta):
    """K2a alone -> (dual', t): launched for CUDA tensors, the plain
    version for CPU ones."""
    N, K, Sy, Sx, Fx = _check_inputs(z, dual, bhat, dhat, None, rho, theta)
    if not _route(z):
        return reference_pass_a(z, dual, bhat, dhat, float(rho), float(theta))
    args = _launch_args(z, N, K, Sy, Sx, rho, theta)
    dual_new = torch.empty_like(z)
    t = torch.empty((N, Sy, Fx), dtype=torch.complex64, device=z.device)
    with torch.cuda.device(z.device):
        rc = _library().ccsc_fused_z_pass_a(
            z.data_ptr(), dual.data_ptr(), dhat.data_ptr(), bhat.data_ptr(),
            dual_new.data_ptr(), t.data_ptr(), *args,
        )
    if rc != 0:
        raise RuntimeError(f"K2a launch failed: cudaError {rc}")
    kernels.count_launch(fused_z_iter, "launches_a")
    return dual_new, t


def pass_b(z, dual, bhat, dhat, minv_diag, t, rho, theta):
    """K2b alone -> z': launched for CUDA tensors, the plain version for
    CPU ones. ``t`` is pass A's [N, Sy, Fx] complex64 output."""
    N, K, Sy, Sx, Fx = _check_inputs(z, dual, bhat, dhat, minv_diag, rho,
                                     theta)
    kernels._check("t", t, (N, Sy, Fx), torch.complex64, z.device)
    if not _route(z):
        return reference_pass_b(z, dual, bhat, dhat, minv_diag, t,
                                float(rho), float(theta))
    args = _launch_args(z, N, K, Sy, Sx, rho, theta)
    z_new = torch.empty_like(z)
    with torch.cuda.device(z.device):
        rc = _library().ccsc_fused_z_pass_b(
            z.data_ptr(), dual.data_ptr(), dhat.data_ptr(), bhat.data_ptr(),
            t.data_ptr(), minv_diag.data_ptr(), z_new.data_ptr(), *args,
        )
    if rc != 0:
        raise RuntimeError(f"K2b launch failed: cudaError {rc}")
    kernels.count_launch(fused_z_iter, "launches_b")
    return z_new


def fused_z_iter(
    z: torch.Tensor,
    dual: torch.Tensor,
    bhat: torch.Tensor,
    dhat: torch.Tensor,
    minv_diag: torch.Tensor,
    rho: float,
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused z iteration -> (z', dual').

    z, dual: [N, K, Sy, Sx] float32 or bfloat16 state (returned in the
    same dtype). bhat: [N, Sy, Fx] complex64 data spectra. dhat:
    [K, Sy, Fx] complex64 filter spectra. minv_diag: [Sy, Fx] float32,
    1 / (1 + sum_k |d_k|^2 / rho). rho, theta: python numbers.

    CUDA tensors launch K2a then K2b on the current stream; CPU tensors
    run :func:`fused_z_iter_reference`. Any other device raises."""
    _check_inputs(z, dual, bhat, dhat, minv_diag, rho, theta)
    if not _route(z):
        return fused_z_iter_reference(
            z, dual, bhat, dhat, minv_diag, float(rho), float(theta)
        )
    dual_new, t = pass_a(z, dual, bhat, dhat, rho, theta)
    return pass_b(z, dual, bhat, dhat, minv_diag, t, rho, theta), dual_new


fused_z_iter.launches_a = 0
fused_z_iter.launches_b = 0
