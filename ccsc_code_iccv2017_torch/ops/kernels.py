"""Hand-written Hopper kernels of the port, with their plain versions.

K1, ``solve_z_rank1``: the W == 1 rank-1 (Sherman-Morrison) z-solve,
replacing the TPU kernel
``ccsc_code_iccv2017_tpu/ops/pallas_kernels.py::solve_z_rank1_pallas``
(``pallas_call`` at :118). Per image n and frequency f::

    g_k = dinv_k (conj(d_k) xi1 + rho xi2_k)
    t   = sum_k d_k g_k
    den = 1 + sum_k |d_k|^2 dinv_k
    z_k = g_k - dinv_k conj(d_k) t / den

The CUDA source is ``csrc/solve_z_rank1.cu`` (sm_90a). It is bound by
bytes: per frequency, ~35 K N real flops against K (12 + 16 N) + 8 N bytes.
One thread per (n, f) with f fastest across the warp, so loads coalesce;
a first k-loop accumulates t and den, a second recomputes g and writes
z. The second pass re-reads dhat, dinv and xi2; caching them in shared
memory is left to a later change.

Build: every source ``csrc/<name>.cu`` is compiled by ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into
``ccsc_code_iccv2017_torch/build/`` at first use (the file name carries
the source's hash, so an edited source rebuilds), loaded with ctypes.
``build_all()`` starts one nvcc per source at once. The wrappers launch
on ``torch.cuda.current_stream()`` and never synchronise.

``solve_z_rank1`` takes the plain version ``solve_z_rank1_reference``
only for tensors on the CPU; for CUDA tensors it launches K1 or raises.
``solve_z_rank1.launches`` counts kernel launches. K2 (the fused
learner z-iteration) lives in ``ops/fused_z.py`` and is built here too.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCE = os.path.join(CSRC_DIR, "solve_z_rank1.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# gridDim.y bound: the kernel puts the image index on the grid's y axis
_MAX_N = 65535


def sources() -> Dict[str, str]:
    """Every kernel source of the port: name -> path of csrc/<name>.cu."""
    return {
        f[:-3]: os.path.join(CSRC_DIR, f)
        for f in sorted(os.listdir(CSRC_DIR))
        if f.endswith(".cu")
    }


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin) — the port's "
            "kernels are built from csrc/*.cu on the machine with the card"
        )
    return path


def _lib_path(name: str) -> str:
    with open(sources()[name], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: every source under csrc/)
    into the build directory, one nvcc process per source, all started
    together; a library that exists for the exact source is not rebuilt.
    Returns, per name, the library path, whether it compiled, the build
    seconds and the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills). Raises if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out, running = {}, {}
    for name in names:
        lib_path = _lib_path(name)
        if os.path.exists(lib_path):
            out[name] = {"path": lib_path, "compiled": False,
                         "seconds": 0.0, "log": ""}
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, srcs[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, lib_path, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib_path, t0) in running.items():
        log, _ = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{srcs[name]}:\n{log}")
            continue
        os.replace(tmp, lib_path)
        out[name] = {"path": lib_path, "compiled": True,
                     "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str = "solve_z_rank1") -> dict:
    """Compile one kernel (``csrc/<name>.cu``); see :func:`build_all`."""
    return build_all([name])[name]


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first
    use."""
    return ctypes.CDLL(build(name)["path"])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("solve_z_rank1")
    fn = lib.ccsc_solve_z_rank1
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def solve_z_rank1_reference(
    dhat: torch.Tensor,
    xi1: torch.Tensor,
    xi2: torch.Tensor,
    rho: float,
    dinv: torch.Tensor,
) -> torch.Tensor:
    """Plain torch version of K1 (same math, same order of the two
    k-reductions as the TPU kernel's body, pallas_kernels.py:94-107)."""
    d = dhat[None]  # [1, K, F]
    gi = dinv[None]
    g = gi * (d.conj() * xi1[:, None, :] + rho * xi2)
    t = (d * g).sum(dim=1, keepdim=True)  # [N, 1, F]
    den = 1.0 + ((d.real * d.real + d.imag * d.imag) * gi).sum(
        dim=1, keepdim=True
    )
    return g - gi * d.conj() * (t / den)


def _check(name, x, shape, dtype, device):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}"
        )
    if x.device != device:
        raise ValueError(
            f"{name} is on {x.device} but dhat is on {device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def solve_z_rank1(
    dhat: torch.Tensor,
    xi1: torch.Tensor,
    xi2: torch.Tensor,
    rho: float,
    dinv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rank-1 z-solve: dhat [K, F] c64, xi1 [N, F] c64, xi2 [N, K, F]
    c64, dinv [K, F] f32 (1/diag(Gamma); None = 1/rho) -> [N, K, F] c64.

    CUDA tensors launch K1 on the current stream; CPU tensors run
    :func:`solve_z_rank1_reference`. Any other device raises."""
    if not isinstance(rho, (int, float)):
        raise TypeError(f"rho must be a python number, got {type(rho)}")
    K, F = dhat.shape
    N = xi1.shape[0]
    dev = dhat.device
    if dinv is None:
        dinv = torch.full((K, F), 1.0 / rho, dtype=torch.float32, device=dev)
    _check("dhat", dhat, (K, F), torch.complex64, dev)
    _check("xi1", xi1, (N, F), torch.complex64, dev)
    _check("xi2", xi2, (N, K, F), torch.complex64, dev)
    _check("dinv", dinv, (K, F), torch.float32, dev)
    if dev.type == "cpu":
        return solve_z_rank1_reference(dhat, xi1, xi2, float(rho), dinv)
    if dev.type != "cuda":
        raise ValueError(f"solve_z_rank1 runs on cuda or cpu, not {dev}")
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"K1 takes 1 <= N <= {_MAX_N} images, got {N}")
    lib = _library()
    z = torch.empty((N, K, F), dtype=torch.complex64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ccsc_solve_z_rank1(
            dhat.data_ptr(), xi1.data_ptr(), xi2.data_ptr(),
            dinv.data_ptr(), z.data_ptr(), float(rho), K, F, N,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    solve_z_rank1.launches += 1
    return z


solve_z_rank1.launches = 0
