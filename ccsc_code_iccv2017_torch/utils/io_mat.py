"""Interop with the reference's .mat filter banks (jax-free copy of the
loaders and writers in ``ccsc_code_iccv2017_tpu.utils.io_mat``: the 2D,
hyperspectral, 3D and lightfield banks, ``infer_layout``,
``save_filters`` and ``load_dz``).

MATLAB lays filters out spatial-first, filter-index last; the canonical
layout is [k, *reduce, *spatial] (config.ProblemGeom).
"""
from __future__ import annotations

import os

import numpy as np

from .validate import CCSCInputError


def _loadmat(path: str) -> dict:
    """scipy.io.loadmat with hardened failure modes: a missing,
    truncated or corrupt .mat raises a CCSCInputError naming the file."""
    import scipy.io

    if not os.path.exists(path):
        raise CCSCInputError(f"no such .mat file: {path}")
    try:
        return scipy.io.loadmat(path)
    except NotImplementedError:  # v7.3 (HDF5) files
        try:
            import h5py

            out = {}
            with h5py.File(path, "r") as f:
                for k in f.keys():
                    if isinstance(f[k], h5py.Dataset):
                        # h5py is C-order transpose
                        out[k] = np.array(f[k]).T
            return out
        except Exception as e:
            raise CCSCInputError(
                f"cannot read {path} as a v7.3 (HDF5) .mat file — the "
                f"file is truncated or corrupt ({type(e).__name__}: "
                f"{e}). Re-export or re-download it."
            ) from e
    except Exception as e:
        size = os.path.getsize(path)
        raise CCSCInputError(
            f"cannot read {path} as a .mat file ({size} bytes) — the "
            f"file is truncated, corrupt, or not a .mat at all "
            f"({type(e).__name__}: {e}). Re-export or re-download it."
        ) from e


def _mat_var(path: str, name: str) -> np.ndarray:
    data = _loadmat(path)
    if name not in data:
        have = sorted(k for k in data if not k.startswith("__"))
        raise CCSCInputError(
            f"{path} holds no variable {name!r} (found: {have}) — "
            "this loader expects the reference's filter-bank layout"
        )
    return data[name]


def load_filters_2d(path: str) -> np.ndarray:
    """[s, s, k] -> [k, s, s] float32."""
    d = _mat_var(path, "d")
    return np.ascontiguousarray(np.transpose(d, (2, 0, 1))).astype(np.float32)


def load_filters_hyperspectral(path: str) -> np.ndarray:
    """[s, s, w, k] -> [k, w, s, s] float32."""
    d = _mat_var(path, "d")
    return np.ascontiguousarray(np.transpose(d, (3, 2, 0, 1))).astype(
        np.float32
    )


def load_filters_3d(path: str) -> np.ndarray:
    """[s, s, t, k] -> [k, s, s, t] float32 (all three dims spatial)."""
    d = _mat_var(path, "d")
    return np.ascontiguousarray(np.transpose(d, (3, 0, 1, 2))).astype(
        np.float32
    )


def load_filters_lightfield(path: str) -> np.ndarray:
    """[s, s, a1, a2, k] -> [k, a1, a2, s, s] float32."""
    d = _mat_var(path, "d")
    return np.ascontiguousarray(np.transpose(d, (4, 2, 3, 0, 1))).astype(
        np.float32
    )


# the canonical layout [k, *reduce, *spatial] <-> MATLAB's (spatial
# first, filter index last), per family
_TO_MATLAB = {
    "2d": (1, 2, 0),  # [k,s,s] -> [s,s,k]
    "hyperspectral": (2, 3, 1, 0),  # [k,w,s,s] -> [s,s,w,k]
    "3d": (1, 2, 3, 0),  # [k,x,y,t] -> [x,y,t,k]
    "lightfield": (3, 4, 1, 2, 0),  # [k,a1,a2,x,y] -> [x,y,a1,a2,k]
}


def infer_layout(d) -> str:
    """Best-effort family inference from filter shape. 4-D is ambiguous
    (hyperspectral [k,w,s,s] vs video [k,x,y,t]); prefer hyperspectral
    when the reduce dim differs from the trailing square support."""
    if d.ndim == 3:
        return "2d"
    if d.ndim == 5:
        return "lightfield"
    if d.ndim == 4:
        k, a, b, c = d.shape
        return "3d" if a == b == c else "hyperspectral"
    raise ValueError(f"cannot infer filter family from shape {d.shape}")


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save_filters(
    path: str,
    d,
    trace: dict | None = None,
    layout: str | None = None,
    Dz=None,
) -> None:
    """Save learned filters (+ optional trace and Dz reconstructions) in
    the reference's .mat layout (spatial first, index last) — the
    terminal ``save('...','d','Dz','iterations')`` of
    2D/learn_kernels_2D_large.m:45 — so files round-trip through the
    load_filters_* loaders and :func:`load_dz` and are interchangeable
    with the MATLAB and JAX artifacts. d: [k, *reduce, *support] (numpy
    or tensor); ``layout`` one of "2d", "hyperspectral", "3d",
    "lightfield" (None infers it from d's shape). Dz: [n, *reduce,
    *spatial], stored with the family's permutation, n in the k role
    (2D [n, x, y] -> [x, y, n])."""
    import scipy.io

    d = _host(d)
    layout = layout or infer_layout(d)
    payload = {"d": np.transpose(d, _TO_MATLAB[layout])}
    if Dz is not None:
        payload["Dz"] = np.transpose(_host(Dz), _TO_MATLAB[layout])
    if trace is not None:
        payload["iterations"] = {k: np.asarray(v) for k, v in trace.items()}
    scipy.io.savemat(path, payload)


def load_dz(path: str, layout: str = "2d") -> np.ndarray:
    """The Dz reconstructions of a saved file as [n, *reduce, *spatial]
    float32."""
    Dz = _mat_var(path, "Dz")
    inv = np.argsort(_TO_MATLAB[layout])
    return np.ascontiguousarray(np.transpose(Dz, inv)).astype(np.float32)
