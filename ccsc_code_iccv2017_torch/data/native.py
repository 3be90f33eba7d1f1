"""ctypes binding to the native data-preprocessing library
``native/ccsc_data.cpp`` (the port's counterpart of
``ccsc_code_iccv2017_tpu.data.native``).

The library runs local contrast normalization as two separable Gaussian
passes with reflected edges, the smooth-fill warm start and per-image
zero-mean in double precision over a std::thread pool across images.
The port compiles the source as it stands in the repository with
``g++`` on first use into the process's build directory
(:func:`build_dir`: the compile cache set by :func:`set_build_dir`, else
``ccsc_code_iccv2017_torch/build/``, gitignored); it never writes into
``native/``. The file name carries a digest of the library's
fingerprint (:func:`library_fingerprint`: the source's sha256, the
flags, g++'s version and the host CPU's identity, since ``-march=native``
makes the binary one CPU's), so a library built otherwise or for
another CPU is never loaded. :func:`build` and :func:`load` take a
library store (``serve.artifacts``): a library missing from the build
directory is fetched from it before g++ runs, and one built is
published. Where the compiler or the library is unavailable each
function falls back to its numpy version, as the JAX package's binding
does (:func:`available` says which runs); :func:`load` itself raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np

from ..utils import obs

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "ccsc_data.cpp")
# the default build directory (see set_build_dir)
BUILD_DIR = os.path.join(_PKG_DIR, "build")
LIBRARY = "ccsc_data"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-pthread")

_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "ccsc_local_cn": [_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_double, ctypes.c_int],
    "ccsc_zero_mean": [_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int],
    "ccsc_smooth_fill": [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_int64, ctypes.c_int, ctypes.c_double,
                         ctypes.c_int],
}


_BUILD_DIR: Optional[str] = None


def set_build_dir(path: Optional[str]) -> None:
    """Build and keep the library in ``path`` (None: back to
    ``BUILD_DIR``); see ``ops.kernels.set_build_dir``."""
    global _BUILD_DIR
    _BUILD_DIR = path


def build_dir() -> str:
    """The directory this process builds the library into."""
    return _BUILD_DIR or BUILD_DIR


def _cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    return cxx


@functools.cache
def _compiler(cxx: str) -> str:
    """The first line of ``<cxx> --version``."""
    proc = subprocess.run([cxx, "--version"], capture_output=True,
                          text=True, timeout=60)
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{cxx} --version failed ({proc.returncode})")
    return lines[0]


@functools.cache
def cpu_identity(cxx: Optional[str] = None) -> str:
    """``<machine>-<12 hex>``: what ``-march=native`` means on this
    host, as the compiler resolves it (``-march=native -Q
    --help=target``), else the model and flags lines of
    ``/proc/cpuinfo``. Two hosts whose libraries could differ read
    differently."""
    text = ""
    try:
        proc = subprocess.run(
            [cxx or _cxx(), "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, timeout=60)
        if proc.returncode == 0:
            text = proc.stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        pass
    if not text:
        try:
            with open("/proc/cpuinfo") as f:
                keep = [ln for ln in f
                        if ln.startswith(("model name", "flags"))]
            text = "".join(dict.fromkeys(keep))
        except OSError:
            text = platform.processor()
    return (f"{platform.machine()}-"
            f"{hashlib.sha256(text.encode()).hexdigest()[:12]}")


def library_fingerprint() -> dict:
    """Everything the build depends on: the source's sha256,
    ``CXX_FLAGS``, the compiler's version and the host CPU's identity
    (:func:`cpu_identity`), which stands as the store's chip."""
    cxx = _cxx()
    with open(SOURCE, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    return {"library": LIBRARY, "source_sha256": sha,
            "flags": list(CXX_FLAGS), "compiler": _compiler(cxx),
            "chip": cpu_identity(cxx)}


def lib_path(fp: Optional[dict] = None) -> str:
    """Where the library of this source, flags, compiler and CPU is
    built."""
    from ..ops.kernels import library_file

    fp = library_fingerprint() if fp is None else fp
    return library_file(fp, build_dir(), LIBRARY)


def build(store=None) -> dict:
    """Make the library present in the build directory
    (:func:`build_dir`): already there (``source`` ``cache-hit``),
    fetched from ``store`` (``fetched``), else compiled by g++
    (``compiled``) and published into ``store``.
    Returns the library path, its source, whether it compiled, the
    build seconds, the compiler's output, and the store's key, fetch
    status and seconds and publish status (None without a store);
    raises when the compiler is missing or fails."""
    from ..ops import kernels as _kernels

    fp = library_fingerprint()
    path = lib_path(fp)
    out = {"path": path, "source": "cache-hit", "compiled": False,
           "seconds": 0.0, "compile_s": None, "log": "", "key": None,
           "fetch_status": None, "fetch_s": None, "publish_status": None,
           "fingerprint": fp}
    if not os.path.exists(path) and store is not None:
        out.update(_kernels.fetch_library(store, fp, path))
        if out["fetch_status"] == "hit":
            out["source"] = "fetched"
    if os.path.exists(path):
        return out
    cxx = _cxx()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    obs.report_compile("build", LIBRARY, seconds)
    out.update(source="compiled", compiled=True, seconds=seconds,
               compile_s=seconds, log=proc.stdout + proc.stderr)
    if store is not None:
        out["publish_status"] = _kernels.publish_library(store, fp, path)
    return out


_LOAD_LOCK = threading.Lock()
_STATE: dict = {}


def load(store=None):
    """(the loaded library, :func:`build`'s dict) — resolved through
    ``store`` and loaded on the first call of the process; later calls
    return the loaded library as a ``cache-hit``. Raises when the
    library cannot be built, fetched or loaded."""
    with _LOAD_LOCK:
        if "lib" in _STATE:
            return _STATE["lib"], {"path": _STATE["info"]["path"],
                                   "source": "cache-hit", "fetch_status":
                                   None, "fetch_s": None, "compile_s": None,
                                   "publish_status": None, "key": None}
        info = build(store=store)
        t0 = time.perf_counter()
        lib = ctypes.CDLL(info["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        obs.report_compile("load", LIBRARY, time.perf_counter() - t0)
        _STATE.update(lib=lib, info=info)
        return lib, info


@functools.cache
def _loaded():
    """(the loaded library, what :func:`build` returned), built on
    first use, or (None, None) — the numpy fallback — when it cannot be
    built or loaded; tried once a process."""
    try:
        return load()
    except (OSError, RuntimeError, AttributeError,
            subprocess.SubprocessError):
        return None, None


def _load() -> Optional[ctypes.CDLL]:
    return _loaded()[0]


def available() -> bool:
    """True when the native library runs (built and loaded here)."""
    return _load() is not None


def build_info() -> Optional[dict]:
    """What :func:`build` returned when the library was loaded, or
    None when it is not available."""
    return _loaded()[1]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc}")


def local_cn_batch(imgs: np.ndarray, ksize: int = 13,
                   sigma: float = 3 * 1.591, nthreads: int = 0) -> np.ndarray:
    """Local contrast normalization of [n, H, W] (or one [H, W] as
    [1, H, W]) float32 images, as a new array; the input is not
    written."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    if imgs.ndim == 2:
        imgs = imgs[None]
    lib = _load()
    if lib is None:
        from .images import local_contrast_normalize

        return np.stack([local_contrast_normalize(i) for i in imgs])
    out = imgs.copy()
    _check(lib.ccsc_local_cn(_ptr(out), *out.shape, ksize, sigma, nthreads),
           "ccsc_local_cn")
    return out


def smooth_fill_batch(imgs: np.ndarray, mask: np.ndarray, ksize: int = 13,
                      sigma: float = 3 * 1.591,
                      nthreads: int = 0) -> np.ndarray:
    """Normalized-convolution Gaussian fill G*(b.m)/max(G*m, 1e-6) of
    [n, H, W] (or one [H, W]) masked images — the reconstruction apps'
    smooth_init warm start — as a new array; the inputs are not
    written."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    mask = np.ascontiguousarray(mask, np.float32)
    if imgs.shape != mask.shape:
        raise ValueError(f"shape mismatch {imgs.shape} vs {mask.shape}")
    if imgs.ndim == 2:
        return smooth_fill_batch(imgs[None], mask[None], ksize, sigma,
                                 nthreads)[0]
    lib = _load()
    if lib is None:
        from .images import smooth_fill_batch as numpy_fill

        return numpy_fill(imgs, mask, ksize, sigma)
    out = imgs.copy()
    _check(lib.ccsc_smooth_fill(_ptr(out), _ptr(mask), *out.shape, ksize,
                                sigma, nthreads), "ccsc_smooth_fill")
    return out


def zero_mean_batch(imgs: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """Each image of [n, ...] float32 minus its own mean, as a new
    array; the input is not written."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    lib = _load()
    if lib is None:
        return imgs - imgs.mean(axis=tuple(range(1, imgs.ndim)),
                                keepdims=True)
    out = imgs.copy()
    _check(lib.ccsc_zero_mean(_ptr(out), out.shape[0],
                              int(np.prod(out.shape[1:])), nthreads),
           "ccsc_zero_mean")
    return out
