"""ctypes binding to the native data-preprocessing library
``native/ccsc_data.cpp`` (the port's counterpart of
``ccsc_code_iccv2017_tpu.data.native``).

The library runs local contrast normalization as two separable Gaussian
passes with reflected edges, the smooth-fill warm start and per-image
zero-mean in double precision over a std::thread pool across images.
The port compiles the source as it stands in the repository with
``g++`` into ``ccsc_code_iccv2017_torch/build/`` (gitignored; the file
name carries the source's hash, so an edited source rebuilds) on first
use; it never writes into ``native/``. Where the compiler or the library
is unavailable each function falls back to its numpy version, as the
JAX package's binding does (:func:`available` says which runs).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "ccsc_data.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
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


def lib_path() -> str:
    """Where the library of the current source is built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libccsc_data_{digest}.so")


def build() -> dict:
    """Compile ``native/ccsc_data.cpp`` into the build directory unless
    the library of this exact source exists. Returns the library path,
    whether it compiled, the build seconds and the compiler's output;
    raises when the compiler is missing or fails."""
    path = lib_path()
    if os.path.exists(path):
        return {"path": path, "compiled": False, "seconds": 0.0, "log": ""}
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return {"path": path, "compiled": True, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


@functools.cache
def _loaded():
    """(the loaded library, what :func:`build` returned), built on
    first use, or (None, None) — the numpy fallback — when it cannot be
    built or loaded; tried once a process."""
    try:
        info = build()
        lib = ctypes.CDLL(info["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    except (OSError, RuntimeError, AttributeError,
            subprocess.SubprocessError):
        return None, None
    return lib, info


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
