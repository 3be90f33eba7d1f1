"""Strict input validation at the port's entry points (torch port of the
checks ``ccsc_code_iccv2017_tpu.utils.validate`` runs for
``reconstruct``/``build_plan``, the consensus learner and the serving
engine's per-request boundary).

Every failure raises :class:`CCSCInputError`, a ``ValueError`` subclass
whose message says what was wrong and what to change. The checks take
numpy arrays or tensors; a tensor is scanned where it lives (one
``isfinite().all()`` reduction on the device and a single scalar read
back), never copied whole to the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class CCSCInputError(ValueError):
    """An input failed validation at a public entry point."""


def _shape(x) -> Tuple[int, ...]:
    try:
        return tuple(int(s) for s in x.shape)
    except AttributeError:
        raise CCSCInputError(
            f"expected an array, got {type(x).__name__} — load data "
            "through data.images or pass a numpy array / torch tensor"
        )


def _tensor(x) -> torch.Tensor:
    # a view of a contiguous numpy array (copied only when strided);
    # tensors pass through
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def check_finite(name: str, arr) -> None:
    """Reject NaN/Inf data up front: non-finite inputs silently diverge
    the ADMM iterate instead of erroring."""
    if not torch.is_tensor(arr):
        dtype = np.asarray(arr).dtype
        if dtype.kind in ("O", "U", "S"):
            raise CCSCInputError(
                f"{name} has non-numeric dtype {dtype} — convert to "
                "float32 before solving"
            )
    t = _tensor(arr)
    if not (t.is_floating_point() or t.is_complex()):
        return  # integral / bool data is trivially finite
    if not bool(torch.isfinite(t).all()):
        raise CCSCInputError(
            f"{name} contains non-finite values (NaN/Inf) — clean or "
            "mask the input before solving; non-finite data silently "
            "diverges the ADMM iterate instead of erroring"
        )


def _check_geometry(name: str, shape, geom, what: str) -> None:
    """Batch-leading data layout [n, *reduce, *spatial] vs a
    ProblemGeom."""
    want_ndim = 1 + geom.ndim_reduce + geom.ndim_spatial
    if len(shape) != want_ndim:
        layout = (
            "[n"
            + "".join(f", {r}" for r in geom.reduce_shape)
            + ", *spatial]"
        )
        raise CCSCInputError(
            f"{name} has shape {shape} ({len(shape)} axes) but this "
            f"{what} expects {layout} with {geom.ndim_spatial} spatial "
            f"axes ({want_ndim} axes total) — check the data layout "
            "(batch leading, FFT axes trailing; config.ProblemGeom "
            "docstring)"
        )
    if shape[0] < 1:
        raise CCSCInputError(f"{name} is empty (shape {shape})")
    reduce_got = shape[1 : 1 + geom.ndim_reduce]
    if tuple(reduce_got) != tuple(geom.reduce_shape):
        raise CCSCInputError(
            f"{name} reduce axes {tuple(reduce_got)} do not match the "
            f"problem's reduce_shape {tuple(geom.reduce_shape)} "
            "(wavelengths/views axes right after the batch axis)"
        )
    spatial = shape[1 + geom.ndim_reduce :]
    if any(s < k for s, k in zip(spatial, geom.spatial_support)):
        raise CCSCInputError(
            f"kernel support {tuple(geom.spatial_support)} exceeds the "
            f"{name} signal size {tuple(spatial)} — a filter cannot be "
            "larger than the signal it codes; reduce the support or "
            "use larger inputs"
        )


def check_filters(d, geom=None, *, name: str = "filters") -> None:
    """Dictionary [k, *reduce, *support]; with a geometry, the shape
    must match it exactly."""
    shape = _shape(d)
    if len(shape) < 3:
        raise CCSCInputError(
            f"{name} has shape {shape} — expected "
            "[k, *reduce, *support] with at least 2 spatial axes "
            "(load through utils.io_mat.load_filters_*)"
        )
    if geom is not None and tuple(shape) != tuple(geom.filter_shape):
        raise CCSCInputError(
            f"{name} shape {shape} does not match the problem's "
            f"filter shape {tuple(geom.filter_shape)}"
        )
    check_finite(name, d)


def check_mask(mask, b, *, name: str = "mask") -> None:
    """Observation mask: same shape as the data, finite, and with a
    non-empty support. Reduced where it lives (one scalar read)."""
    mshape, bshape = _shape(mask), _shape(b)
    if mshape != bshape:
        raise CCSCInputError(
            f"{name} shape {mshape} does not match data shape {bshape}"
            " — the mask must weight every data entry"
        )
    check_finite(name, mask)
    t = _tensor(mask)
    if t.numel() > 0 and not bool((t != 0).any()):
        raise CCSCInputError(
            f"{name} is identically zero — it observes no pixels, so "
            "the reconstruction is unconstrained"
        )


def check_same_shape(name: str, arr, b) -> None:
    ashape, bshape = _shape(arr), _shape(b)
    if ashape != bshape:
        raise CCSCInputError(
            f"{name} shape {ashape} does not match data shape {bshape}"
        )


def check_positive(what: str, **vals) -> None:
    for k, v in vals.items():
        if v is None:
            continue
        if not np.isfinite(v) or v <= 0:
            raise CCSCInputError(
                f"{what}.{k} must be a finite positive number, got "
                f"{v!r}"
            )


def as_float32(x, device, name: str = "data") -> torch.Tensor:
    """An entry-point array (numpy or tensor) as a float32 tensor on
    ``device``."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        if x.dtype.kind in ("O", "U", "S"):
            raise CCSCInputError(
                f"{name} has non-numeric dtype {x.dtype} — convert to "
                "float32 before solving"
            )
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.float32)


def check_learn_data(
    b, geom, *, num_blocks: Optional[int] = None, name: str = "data"
) -> None:
    """Learner data [n, *reduce, *spatial]: layout vs geometry,
    finiteness, and (when given) consensus-block divisibility."""
    shape = _shape(b)
    _check_geometry(name, shape, geom, "learner")
    if num_blocks is not None:
        if num_blocks < 1:
            raise CCSCInputError(
                f"num_blocks must be >= 1, got {num_blocks}"
            )
        if shape[0] % num_blocks:
            raise CCSCInputError(
                f"n={shape[0]} not divisible by num_blocks={num_blocks}"
                " — pick a block count that divides the batch (or trim "
                "the batch)"
            )
    check_finite(name, b)


def check_learn_config(cfg) -> None:
    """Positivity / sanity of the LearnConfig fields that the solver
    would otherwise divide by or diverge on, and the storage dtypes the
    port implements."""
    check_positive(
        "LearnConfig",
        lambda_residual=cfg.lambda_residual,
        lambda_prior=cfg.lambda_prior,
        rho_d=cfg.rho_d,
        rho_z=cfg.rho_z,
    )
    # max_it=0 is legitimate (a zero-iteration run returns the seeded
    # dictionary)
    if cfg.max_it < 0 or cfg.max_it_d < 1 or cfg.max_it_z < 1:
        raise CCSCInputError(
            "LearnConfig.max_it must be >= 0 and max_it_d/max_it_z "
            f">= 1, got {cfg.max_it}/{cfg.max_it_d}/{cfg.max_it_z}"
        )
    if not np.isfinite(cfg.tol) or cfg.tol < 0:
        raise CCSCInputError(
            f"LearnConfig.tol must be a finite value >= 0, got {cfg.tol}"
        )
    for name in ("storage_dtype", "d_storage_dtype"):
        if getattr(cfg, name) not in ("float32", "bfloat16"):
            raise CCSCInputError(
                f"LearnConfig.{name} must be 'float32' | 'bfloat16' in the "
                f"port, got {getattr(cfg, name)!r}"
            )


def check_learn_inputs(
    b, geom, cfg, *, init_d=None, smooth_init=None, blocks=True
) -> None:
    """Everything the learner entry point needs checked before its
    first step. ``blocks=False`` for solvers that do not consensus-split
    the batch."""
    check_learn_config(cfg)
    check_learn_data(
        b, geom, num_blocks=cfg.num_blocks if blocks else None
    )
    if init_d is not None:
        check_filters(init_d, geom, name="init_d")
    if smooth_init is not None:
        check_same_shape("smooth_init", smooth_init, b)
        check_finite("smooth_init", smooth_init)


def check_solve_config(cfg) -> None:
    """Positivity / sanity of the SolveConfig fields."""
    check_positive(
        "SolveConfig",
        lambda_residual=cfg.lambda_residual,
        lambda_prior=cfg.lambda_prior,
        gamma_factor=cfg.gamma_factor,
        gamma_ratio=cfg.gamma_ratio,
    )
    if cfg.max_it < 1:
        raise CCSCInputError(
            f"SolveConfig.max_it must be >= 1, got {cfg.max_it}"
        )
    if not np.isfinite(cfg.tol) or cfg.tol < 0:
        raise CCSCInputError(
            f"SolveConfig.tol must be a finite value >= 0, got {cfg.tol}"
        )


def check_solve_data(
    b, d, geom, *, mask=None, smooth_init=None, name: str = "data"
) -> None:
    """Reconstruction inputs (no config): observations vs geometry,
    dictionary vs geometry, mask/offset shapes."""
    _check_geometry(name, _shape(b), geom, "reconstruction")
    check_finite(name, b)
    check_filters(d, geom)
    if mask is not None:
        check_mask(mask, b)
    if smooth_init is not None:
        check_same_shape("smooth_init", smooth_init, b)
        check_finite("smooth_init", smooth_init)


def check_solve_inputs(
    b, d, geom, cfg, *, mask=None, smooth_init=None,
    x_orig: Optional[object] = None,
) -> None:
    """Everything models.reconstruct needs checked before the solve."""
    check_solve_config(cfg)
    check_solve_data(b, d, geom, mask=mask, smooth_init=smooth_init)
    if x_orig is not None:
        check_same_shape("x_orig", x_orig, b)


def check_serve_request(
    b, geom, *, mask=None, smooth_init=None, x_orig=None,
    name: str = "request",
) -> None:
    """The cheap per-request subset of the solve checks, for the serving
    hot path (serve.CodecEngine): one observation [*reduce, *spatial]
    (no batch axis) — layout vs the pinned geometry, non-finite data,
    mask/offset shape agreement and a mask that observes something. The
    once-per-operator checks (dictionary vs geometry, config
    positivity) run at engine construction, not here."""
    shape = _shape(b)
    want_ndim = geom.ndim_reduce + geom.ndim_spatial
    if len(shape) != want_ndim:
        layout = (
            "["
            + "".join(f"{r}, " for r in geom.reduce_shape)
            + "*spatial]"
        )
        raise CCSCInputError(
            f"{name} has shape {shape} ({len(shape)} axes) but the "
            f"engine serves single observations {layout} with "
            f"{geom.ndim_spatial} spatial axes ({want_ndim} axes total"
            ", no batch axis — submit one request per observation)"
        )
    reduce_got = shape[: geom.ndim_reduce]
    if tuple(reduce_got) != tuple(geom.reduce_shape):
        raise CCSCInputError(
            f"{name} reduce axes {tuple(reduce_got)} do not match the "
            f"pinned problem's reduce_shape {tuple(geom.reduce_shape)}"
        )
    spatial = shape[geom.ndim_reduce:]
    if any(s < k for s, k in zip(spatial, geom.spatial_support)):
        raise CCSCInputError(
            f"kernel support {tuple(geom.spatial_support)} exceeds the "
            f"{name} spatial size {tuple(spatial)}"
        )
    check_finite(name, b)
    for other_name, other in (
        ("mask", mask), ("smooth_init", smooth_init), ("x_orig", x_orig)
    ):
        if other is None:
            continue
        if _shape(other) != shape:
            raise CCSCInputError(
                f"{other_name} shape {_shape(other)} does not match "
                f"{name} shape {shape}"
            )
        check_finite(other_name, other)
    if mask is not None:
        # the direct reconstruct() path refuses an all-zero mask, and so
        # does the serving boundary
        t = _tensor(mask)
        if t.numel() > 0 and not bool((t != 0).any()):
            raise CCSCInputError(
                "mask is identically zero — it observes no pixels, so "
                "the reconstruction is unconstrained"
            )
