"""Interop with the reference's .mat filter banks (jax-free copy of the
loaders in ``ccsc_code_iccv2017_tpu.utils.io_mat``: the 2D, hyperspectral,
3D and lightfield banks, and ``infer_layout``).

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
    the reference's .mat layout — the terminal
    ``save('...','d','Dz','iterations')`` of 2D/learn_kernels_2D_large.m:45
    — so files round-trip through load_filters_2d and are
    interchangeable with the MATLAB and JAX artifacts. d: [k, s, s]
    (numpy or tensor) -> stored [s, s, k]; Dz: [n, H, W] -> [H, W, n].
    Only the "2d" layout is ported; the other families come with their
    learners (ROADMAP.md Queue 1 item 8)."""
    import scipy.io

    d = _host(d)
    layout = layout or ("2d" if d.ndim == 3 else None)
    if layout != "2d":
        raise NotImplementedError(
            f"filter layout {layout!r} for shape {d.shape}: only '2d' is "
            "ported (ROADMAP.md Queue 1 item 8)"
        )
    payload = {"d": np.transpose(d, (1, 2, 0))}
    if Dz is not None:
        payload["Dz"] = np.transpose(_host(Dz), (1, 2, 0))
    if trace is not None:
        payload["iterations"] = {k: np.asarray(v) for k, v in trace.items()}
    scipy.io.savemat(path, payload)
