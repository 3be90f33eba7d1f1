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
bytes: per frequency, ~35 K N real flops against K (12 + 16 N) + 8 N bytes,
so it has to keep many loads in flight and move each byte once. A block
covers ``K1_TF`` = 32 consecutive frequencies (a warp's lanes, so loads
coalesce) times ``K1_G`` = 8 k-groups (one warp each); thread (f, g)
keeps its KPT values of d, dinv and xi2 in registers (KPT a template
instantiation with ``K1_G * KPT >= K``; a generic loop beyond
``K1_G * 16``), issues all its loads before using any, and the groups'
partial t and den meet in shared memory in a fixed order (no atomics:
bitwise repeatable). A block loops over a chunk of NC images with d,
dinv and den held in registers, so dhat/dinv are read once per chunk
where they do not stay in L2 from one image to the next.
:func:`k1_launch_plan` picks KPT, NC and the grid; the kernel's C entry
point takes them and refuses a plan it was not built for.

Build: every source ``csrc/<name>.cu`` is compiled by ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into
``ccsc_code_iccv2017_torch/build/`` at first use (the file name carries
the source's hash, so an edited source rebuilds), loaded with ctypes.
``build_all()`` starts one nvcc per source at once. The wrappers launch
on ``torch.cuda.current_stream()`` and never synchronise. Each nvcc
build and each load of a built library is reported to the open
telemetry runs (``utils.obs.report_compile``: a ``compile`` record of
kind ``build`` or ``load``).

``solve_z_rank1`` takes the plain version ``solve_z_rank1_reference``
only for tensors on the CPU; for CUDA tensors it launches K1 or raises.
``solve_z_rank1.launches`` counts kernel launches. The serving engine's
mesh launches from one thread per position, so the libraries load once
under a lock and every count is bumped under one. K2 (the fused
learner z-iteration) lives in ``ops/fused_z.py`` and is built here too.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

import torch

from ..utils import obs

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCE = os.path.join(CSRC_DIR, "solve_z_rank1.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# K1's launch geometry (csrc/solve_z_rank1.cu): blocks of K1_TF
# frequencies x K1_G k-groups; the register instantiations of KPT, the
# values of k each thread keeps (0 = the generic loop for larger K)
K1_TF, K1_G = 32, 8
K1_KPT = (1, 2, 4, 8, 13, 16)
# where dhat/dinv do not stay in L2, a block takes up to K1_NC_MAX
# images, while the grid keeps at least K1_BLOCKS_PER_SM blocks for each
# SM (provisional: only N=4 backs them so far)
K1_NC_MAX = 8
K1_BLOCKS_PER_SM = 8
_GRID_Y_MAX = 65535
_INT_MAX = 2**31 - 1


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
        obs.report_compile("build", name, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str = "solve_z_rank1") -> dict:
    """Compile one kernel (``csrc/<name>.cu``); see :func:`build_all`."""
    return build_all([name])[name]


_LOAD_LOCK = threading.Lock()
_LIBRARIES: Dict[str, ctypes.CDLL] = {}


def bound_library(name: str, bind) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built and loaded on
    first use and passed once through ``bind`` (which declares its entry
    points' types). One lock covers the build and the load, so threads
    that reach a kernel together build it once."""
    with _LOAD_LOCK:
        lib = _LIBRARIES.get(name)
        if lib is None:
            path = build(name)["path"]
            t0 = time.perf_counter()
            lib = _LIBRARIES[name] = bind(ctypes.CDLL(path))
            obs.report_compile("load", name, time.perf_counter() - t0)
        return lib


def _bind_k1(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.ccsc_solve_z_rank1
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        *[ctypes.c_int] * 9, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    return bound_library("solve_z_rank1", _bind_k1)


@functools.cache
def _card(index: int) -> tuple:
    """(SM count, L2 bytes) of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.L2_cache_size


def k1_launch_plan(N: int, K: int, F: int, sm_count: int,
                   l2_bytes: int) -> dict:
    """K1's launch plan for N images, K filters and F frequencies on a
    card with ``sm_count`` SMs and ``l2_bytes`` of L2: the tile (``tf``
    frequencies x ``g`` k-groups, the block's threads), ``kpt`` (the
    smallest register instantiation with g * kpt >= K, or 0 for the
    generic loop), ``nc`` (images per block) and the ``grid``
    (ceil(F / tf), ceil(N / nc)).

    A block takes more than one image only where dhat and dinv (12 K F
    bytes) take more than half the L2: below that they stay in L2 from
    one image to the next, and nc moved K1's time by no trend (N=800,
    F=6160: 7.4 MB); above it each image more per block saves a read of
    them (N=4, F=35644: 42.8 MB, nc=4 a third faster than nc=1). The
    threshold lies between those two points; half was not measured
    finer. There nc grows with the work, up to K1_NC_MAX, while the
    grid keeps K1_BLOCKS_PER_SM blocks per SM; both are provisional
    until an A/B at the serving engine's slot counts. Past 65535 chunks
    (the grid's y limit) nc grows further. Raises on what the kernel
    cannot take."""
    for name, v in (("N", N), ("K", K), ("F", F), ("sm_count", sm_count),
                    ("l2_bytes", l2_bytes)):
        if not isinstance(v, int) or not 1 <= v <= _INT_MAX:
            raise ValueError(f"K1 needs 1 <= {name} <= {_INT_MAX}, got {v!r}")
    tiles = -(-F // K1_TF)
    if tiles * K1_TF > _INT_MAX:
        raise ValueError(f"K1 takes F <= {_INT_MAX - K1_TF + 1}, got {F}")
    kpt = next((p for p in K1_KPT if K1_G * p >= K), 0)
    nc = 1
    if 12 * K * F > l2_bytes // 2:
        nc = min(K1_NC_MAX, N,
                 max(1, N * tiles // (K1_BLOCKS_PER_SM * sm_count)))
    nc = max(nc, -(-N // _GRID_Y_MAX))
    return {"tf": K1_TF, "g": K1_G, "kpt": kpt, "nc": nc,
            "grid": (tiles, -(-N // nc))}


def solve_z_rank1_reference(
    dhat: torch.Tensor,
    xi1: torch.Tensor,
    xi2: torch.Tensor,
    rho: float,
    dinv: torch.Tensor,
) -> torch.Tensor:
    """Plain torch version of K1 (same math as the TPU kernel's body,
    pallas_kernels.py:94-107), in real arithmetic on the real and
    imaginary parts, with its two k-sums run k innermost (a row
    reduction per image and frequency). Each bin's bits then do not
    depend on how many bins the call holds, so a solve split over a
    'freq' mesh axis gives the whole-spectrum solve's bits, as K1 does
    on the card; torch's CPU complex product and middle-axis sums round
    a vector body and its tail differently."""
    dr, di = dhat.real[None], dhat.imag[None]  # [1, K, F]
    gi = dinv[None]
    x1r, x1i = xi1.real[:, None, :], xi1.imag[:, None, :]
    # g = dinv (conj(d) xi1 + rho xi2)
    gr = gi * (dr * x1r + di * x1i + rho * xi2.real)
    gj = gi * (dr * x1i - di * x1r + rho * xi2.imag)
    # t = sum_k d_k g_k, den = 1 + sum_k |d_k|^2 dinv_k
    tr = _ksum(dr * gr - di * gj)
    tj = _ksum(dr * gj + di * gr)
    den = 1.0 + _ksum((dr * dr + di * di) * gi)
    qr, qj = tr / den, tj / den
    # z = g - dinv conj(d) t / den
    return torch.complex(gr - gi * (dr * qr + di * qj),
                         gj - gi * (dr * qj - di * qr))


def _ksum(x: torch.Tensor) -> torch.Tensor:
    """[N, K, F] -> [N, 1, F], summed over k with k innermost."""
    return x.transpose(1, 2).contiguous().sum(-1).unsqueeze(1)


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
    plan = k1_launch_plan(N, K, F, *_card(dev.index))
    z = torch.empty((N, K, F), dtype=torch.complex64, device=dev)
    with torch.cuda.device(dev):
        rc = _library().ccsc_solve_z_rank1(
            dhat.data_ptr(), xi1.data_ptr(), xi2.data_ptr(),
            dinv.data_ptr(), z.data_ptr(), float(rho), K, F, N,
            plan["tf"], plan["g"], plan["kpt"], plan["nc"], *plan["grid"],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc} (plan {plan})")
    count_launch(solve_z_rank1)
    return z


solve_z_rank1.launches = 0
_COUNT_LOCK = threading.Lock()


def count_launch(fn, attr: str = "launches") -> None:
    """One more launch on ``fn.<attr>``: a read-modify-write under a
    lock, so concurrent launching threads lose no count."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
