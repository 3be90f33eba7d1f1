"""Carry weights and state across from the JAX package: a filter bank, a
JAX ``ReconPlan``'s spectra and solve factors, or a learner's
``LearnState`` / ``MaskedLearnState``, as the port's objects on a torch
device.

The inputs are plain numpy arrays and plain metadata values, so this
module imports nothing of the JAX package; a caller holding a JAX plan
passes ``np.asarray`` of its leaves and ``dataclasses.asdict(plan.prob)``
/ ``plan.fg._asdict()`` for its metadata, and a caller holding a JAX
LearnState or MaskedLearnState passes ``{f: np.asarray(getattr(state,
f)) for f in state._fields}``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import ProblemGeom
from .models import common
from .models.learn import LearnState
from .models.learn_masked import MaskedLearnState
from .models.reconstruct import ReconPlan, ReconstructionProblem
from .ops import freq_solvers
from .utils import validate
from .utils.device import resolve_device

PLAN_ARRAYS = ("dhat_clean", "dhat_solve", "kern.dhat", "kern.dinv")
# and one of these: the W == 1 scalar or the W > 1 Woodbury inverse
PLAN_INNER = ("kern.minv_diag", "kern.minv")


def bank_from_numpy(d, device="cuda") -> torch.Tensor:
    """A filter bank [k, *reduce, *support] as a float32 tensor on
    ``device``."""
    d = np.asarray(d, np.float32)
    validate.check_filters(d)
    return torch.from_numpy(np.ascontiguousarray(d)).to(resolve_device(device))


def _problem(p: Mapping) -> ReconstructionProblem:
    p = dict(p)
    g = p.pop("geom")
    geom = ProblemGeom(
        tuple(g["spatial_support"]), int(g["num_filters"]),
        tuple(g.get("reduce_shape", ())),
    )
    return ReconstructionProblem(geom=geom, **p)


def _freq_geom(fg: Mapping) -> common.FreqGeom:
    return common.FreqGeom(
        spatial_shape=tuple(fg["spatial_shape"]),
        freq_shape=tuple(fg["freq_shape"]),
        num_freq=int(fg["num_freq"]),
        reduce_shape=tuple(fg["reduce_shape"]),
        reduce_size=int(fg["reduce_size"]),
        fft_impl=fg.get("fft_impl", "xla"),
    )


def plan_from_jax(
    arrays: Mapping[str, np.ndarray], meta: Mapping, device="cuda"
) -> ReconPlan:
    """The port's :class:`ReconPlan` from a JAX plan's leaves.

    ``arrays``: ``dhat_clean``, ``dhat_solve``, ``kern.dhat``,
    ``kern.dinv`` as numpy arrays, and the inner factor the JAX plan
    holds: ``kern.minv_diag`` [F] for W == 1, or ``kern.minv`` [F, W, W]
    for W > 1 (the other is None there and may be left out). ``meta``:
    ``prob`` (a mapping of the ReconstructionProblem fields, ``geom`` a
    mapping of ProblemGeom's),
    ``fg`` (a mapping of FreqGeom's fields), ``rho``, ``has_blur``,
    ``d_digest``, ``lambda_smooth`` and optionally ``herm_inv``.
    """
    missing = [k for k in PLAN_ARRAYS if k not in arrays]
    inner = [k for k in PLAN_INNER if arrays.get(k) is not None]
    if missing or len(inner) != 1:
        raise KeyError(
            f"plan arrays missing {missing}, with inner factors {inner}: "
            f"need {list(PLAN_ARRAYS)} and exactly one of "
            f"{list(PLAN_INNER)}"
        )
    dev = resolve_device(device)

    def t(name, dtype):
        a = np.ascontiguousarray(np.asarray(arrays[name]).astype(dtype))
        return torch.from_numpy(a).to(dev)

    fg = _freq_geom(meta["fg"])
    dhat_clean = t("dhat_clean", np.complex64)
    dhat_solve = t("dhat_solve", np.complex64)
    woodbury = inner[0] == "kern.minv"
    kern = freq_solvers.ZSolveKernel(
        dhat=t("kern.dhat", np.complex64),
        dinv=t("kern.dinv", np.float32),
        minv=t("kern.minv", np.complex64) if woodbury else None,
        minv_diag=None if woodbury else t("kern.minv_diag", np.float32),
    )
    K, W, F = kern.dhat.shape
    inner_shape = (F, W, W) if woodbury else (F,)
    inner_t = kern.minv if woodbury else kern.minv_diag
    if (
        (W > 1) != woodbury
        or W != fg.reduce_size
        or F != fg.num_freq
        or tuple(dhat_clean.shape) != (K, W, F)
        or tuple(dhat_solve.shape) != (K, W, F)
        or tuple(kern.dinv.shape) != (K, F)
        or tuple(inner_t.shape) != inner_shape
    ):
        raise ValueError(
            f"plan arrays of shape {tuple(kern.dhat.shape)} with "
            f"{inner[0]} {tuple(inner_t.shape)} do not form a plan over "
            f"W={fg.reduce_size} and {fg.num_freq} frequencies"
        )
    return ReconPlan(
        dhat_clean=dhat_clean,
        dhat_solve=dhat_solve,
        kern=kern,
        prob=_problem(meta["prob"]),
        fg=fg,
        rho=float(meta["rho"]),
        has_blur=bool(meta["has_blur"]),
        d_digest=str(meta["d_digest"]),
        lambda_smooth=float(meta["lambda_smooth"]),
        herm_inv=meta.get("herm_inv"),
    )


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; a bfloat16 array (ml_dtypes, as JAX returns
    it) keeps its bits as torch.bfloat16."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _state_from_numpy(cls, fields: Mapping[str, np.ndarray], device):
    missing = [f for f in cls._fields if f not in fields]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing {missing}")
    dev = resolve_device(device)
    return cls(
        **{f: _tensor_from_numpy(fields[f]).to(dev) for f in cls._fields}
    )


def _state_to_numpy(state) -> Dict[str, np.ndarray]:
    out = {}
    for f in state._fields:
        t = getattr(state, f).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[f] = t.numpy()
    return out


def learn_state_from_jax(
    fields: Mapping[str, np.ndarray], device="cuda"
) -> LearnState:
    """The port's :class:`LearnState` from a JAX LearnState's fields
    (numpy arrays keyed by field name; bfloat16 storage kept bit for
    bit) on ``device``."""
    return _state_from_numpy(LearnState, fields, device)


def learn_state_to_numpy(state: LearnState) -> Dict[str, np.ndarray]:
    """The fields of a port LearnState as numpy arrays on the host;
    bfloat16 fields widen to float32 (exactly), since numpy has no
    bfloat16 of its own."""
    return _state_to_numpy(state)


def masked_state_from_jax(
    fields: Mapping[str, np.ndarray], device="cuda"
) -> MaskedLearnState:
    """The port's :class:`MaskedLearnState` from a JAX MaskedLearnState's
    fields, as :func:`learn_state_from_jax`."""
    return _state_from_numpy(MaskedLearnState, fields, device)


def masked_state_to_numpy(state: MaskedLearnState) -> Dict[str, np.ndarray]:
    """The fields of a port MaskedLearnState as numpy arrays on the host,
    as :func:`learn_state_to_numpy`."""
    return _state_to_numpy(state)
