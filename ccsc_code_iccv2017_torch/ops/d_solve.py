"""The d-iteration's Woodbury solve on the card: one hand-written kernel
over frequency-major code spectra, with its plain version and its route.

Per consensus block and frequency, with Z the ni x K code matrix and
ginv = (rho I + Z Z^H)^{-1} its Woodbury inner inverse::

    r = zb + rho xi,  t = Z r,  s = ginv t,  x = (r - Z^H s) / rho

(``freq_solvers.solve_d``'s einsum body; dParallel.m:252-276). The CUDA
source is ``csrc/d_solve.cu`` (sm_90a); its header says what bounds it
(bytes: each code matrix and one triangle of each Hermitian inverse read
once, 6.05 GB a call at the north star) and how it is laid out; for
W = 1 it reads ``ginv``'s lower triangle alone. It replaces no TPU
kernel: the
JAX package leaves this solve to XLA einsums, whose cuBLAS form on the
card materialised the code spectra's conjugate and a permuted copy of
them on every call.

The spectra are frequency-major, ``zhat`` [..., F, ni, K] contiguous
(``freq_solvers.precompute_d_kernel`` transposes them once a step), with
``ginv`` [..., F, ni, ni]; ``zb``, ``xi`` and the result keep the
callers' [..., K, W, F].

:func:`route` picks the kernel on the card for complex64 when one
block-frequency's working set :func:`fits` a block's shared memory
(:func:`smem_bytes`, the twin of the source's). :func:`solve` takes
:func:`plain` only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises. ``solve.launches`` counts launches
(``kernels.count_launch``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import kernels

# csrc/d_solve.cu: the block's threads and the card's per-block
# shared-memory limit (H100: 227 KB)
THREADS = 256
MAX_SMEM = 232448
_INT_MAX = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccsc_d_solve.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                 ctypes.c_float, p]
    lib.ccsc_d_solve.restype = i
    lib.ccsc_d_solve_smem_bytes.argtypes = [i, i, i]
    lib.ccsc_d_solve_smem_bytes.restype = ctypes.c_size_t
    return lib


def _library() -> ctypes.CDLL:
    return kernels.bound_library("d_solve", _bind)


def _wtile(W: int) -> int:
    return 1 if W <= 1 else 2 if W <= 2 else 4 if W <= 4 else 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(ni: int, K: int, W: int) -> int:
    """Shared memory one block takes: the twin of
    ``csrc/d_solve.cu::smem_bytes`` (Z, r, t padded to a warp's rows, s
    and the parts: of x, and for W = 1 the warps' column sums of s; W
    rounded up to whole tiles)."""
    wt = _wtile(W)
    wp = _round_up(W, wt)
    parts = THREADS * wt
    if wt == 1:
        parts = max(parts, THREADS // 32 * _round_up(ni, 32))
    return 8 * (ni * K + wp * K + wp * _round_up(ni, 32) + wp * ni + parts)


def fits(ni: int, K: int, W: int) -> bool:
    """Whether the kernel takes ni x K codes with W data channels."""
    return min(ni, K, W) >= 1 and smem_bytes(ni, K, W) <= MAX_SMEM


def route(device_type: str, dtype: torch.dtype, ni: int, K: int,
          W: int) -> str:
    """'kernel' for complex64 on the card when :func:`fits`, else
    'torch' (``freq_solvers.solve_d``'s einsum body)."""
    if device_type == "cuda" and dtype == torch.complex64 \
            and fits(ni, K, W):
        return "kernel"
    return "torch"


def plain(zhat: torch.Tensor, ginv: torch.Tensor, zb: torch.Tensor,
          xi: torch.Tensor, rho: float) -> torch.Tensor:
    """The plain version, batched products over the frequency-major
    spectra: zhat [..., F, ni, K], ginv [..., F, ni, ni], zb and xi
    [..., K, W, F] -> x [..., K, W, F]."""
    r = (zb + rho * xi).movedim(-1, -3)  # [..., F, K, W]
    s = ginv @ (zhat @ r)
    return ((r - zhat.mH @ s) / rho).movedim(-3, -1).contiguous()


def _check(zhat, ginv, zb, xi) -> None:
    for name, x in (("zhat", zhat), ("ginv", ginv), ("zb", zb), ("xi", xi)):
        if x.dtype != torch.complex64:
            raise TypeError(f"{name} must be complex64, got {x.dtype}")
        if x.device != zhat.device:
            raise ValueError(f"{name} is on {x.device}, zhat on "
                             f"{zhat.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if zhat.ndim < 3:
        raise ValueError(f"zhat must be [..., F, ni, K], got "
                         f"{tuple(zhat.shape)}")
    *lead, F, ni, K = zhat.shape
    if tuple(ginv.shape) != (*lead, F, ni, ni):
        raise ValueError(f"ginv must be {(*lead, F, ni, ni)}, got "
                         f"{tuple(ginv.shape)}")
    if xi.ndim != zhat.ndim or tuple(xi.shape[:-3]) != tuple(lead) \
            or xi.shape[-3] != K or xi.shape[-1] != F:
        raise ValueError(f"xi must be {(*lead, K, 'W', F)}, got "
                         f"{tuple(xi.shape)}")
    if zb.shape != xi.shape:
        raise ValueError(f"zb must be xi's shape {tuple(xi.shape)}, got "
                         f"{tuple(zb.shape)}")


def solve(zhat: torch.Tensor, ginv: torch.Tensor, zb: torch.Tensor,
          xi: torch.Tensor, rho: float) -> torch.Tensor:
    """x [..., K, W, F] = (r - Z^H ginv Z r) / rho, r = zb + rho xi, for
    contiguous complex64 zhat [..., F, ni, K], ginv [..., F, ni, ni], zb
    and xi [..., K, W, F].

    CUDA tensors launch the kernel on the current stream (a shape that
    does not :func:`fits` raises: :func:`route` keeps it off); CPU
    tensors run :func:`plain`. Any other device raises."""
    if not isinstance(rho, (int, float)):
        raise TypeError(f"rho must be a python number, got {type(rho)}")
    _check(zhat, ginv, zb, xi)
    dev = zhat.device
    if dev.type == "cpu":
        return plain(zhat, ginv, zb, xi, float(rho))
    if dev.type != "cuda":
        raise ValueError(f"the d-solve runs on cuda or cpu, not {dev}")
    *lead, F, ni, K = zhat.shape
    W = xi.shape[-2]
    if not fits(ni, K, W):
        raise ValueError(f"the d-solve kernel does not take ni={ni}, K={K}, "
                         f"W={W}: {smem_bytes(ni, K, W)} bytes of shared "
                         f"memory, past {MAX_SMEM}")
    batch = math.prod(lead)
    out = torch.empty_like(xi)
    if batch == 0 or F == 0:
        return out
    if batch * F > _INT_MAX:
        raise ValueError(f"the d-solve kernel takes batch * F <= {_INT_MAX},"
                         f" got {batch} * {F}")
    with torch.cuda.device(dev):
        rc = _library().ccsc_d_solve(
            zhat.data_ptr(), ginv.data_ptr(), zb.data_ptr(), xi.data_ptr(),
            out.data_ptr(), batch, F, ni, K, W, float(rho),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"d-solve launch failed: cudaError {rc} (batch="
                           f"{batch}, F={F}, ni={ni}, K={K}, W={W})")
    kernels.count_launch(solve)
    return out


solve.launches = 0
