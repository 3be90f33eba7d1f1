"""Generic CCSC reconstruction (sparse coding with a fixed dictionary) —
the torch port of ``ccsc_code_iccv2017_tpu.models.reconstruct``.

One solver covers the reference's reconstruction apps as configuration:
inpainting (gaussian data term + mask), Poisson deconvolution (poisson
data term + appended dirac with gradient regularization), and blurred
problems (blur OTF composed into the solve operator), on any geometry:
2D and 3D spatial supports, and reduce axes (hyperspectral bands,
lightfield views: W > 1, the Woodbury z-solve), on one device or on a
mesh of ranks (``mesh=``: the batch split over the first axis, the
per-frequency solves optionally over a second 'freq' axis). With
``cfg.metrics_dir`` a call writes its telemetry stream (utils.obs,
``algorithm="reconstruct"``). Tuning comes with a later slice
(ROADMAP.md Queue 1 item 9).

The ADMM skeleton is the reference's 2-function consensus form: v1 = Dz
(data side), v2 = z (sparsity side), scaled duals, and one exact
per-frequency solve per iteration (ops.freq_solvers.solve_z, which on a
CUDA tensor runs the hand-written kernel K1). The iteration is a Python
``while`` over the same body, update order, traces and stop test as the
JAX ``while_loop``; reading the rel-change for the stop test costs one
host synchronisation per iteration. The serving engine's slot-wise mode
solves a bucket of independent requests in one such loop, each stopping
where its own n=1 solve would (``_reconstruct_impl``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ProblemGeom, SolveConfig
from ..ops import fourier, freq_solvers, proxes
from ..parallel import mesh as mesh_lib
from ..utils import validate
from ..utils.device import resolve_device
from . import common


@dataclasses.dataclass(frozen=True)
class ReconstructionProblem:
    """Static structure of a reconstruction app."""

    geom: ProblemGeom
    data_term: str = "gaussian"  # 'gaussian' | 'poisson'
    dirac: str = "none"  # 'none' | 'append' | 'prepend'
    grad_reg_dirac: bool = False
    sparsify_dirac: bool = True
    pad: bool = True
    clamp_nonneg: bool = False

    def __post_init__(self):
        if self.grad_reg_dirac and self.dirac == "none":
            raise ValueError("grad_reg_dirac requires a dirac channel")
        if not self.sparsify_dirac and self.dirac == "none":
            raise ValueError("sparsify_dirac=False requires a dirac channel")


class SolveExtras(NamedTuple):
    """Diagnostics of the FINAL iterate (SolveConfig.track_diagnostics):
    the objective split into data residual and L1 prior, plus the
    non-finite count of the code tensor. The residual reuses the
    carried ``v1``, so tracking adds no extra Dz pass."""

    obj_fid: torch.Tensor  # scalar: 0.5*lambda_residual*||M(Dz-b)||^2
    obj_l1: torch.Tensor  # scalar: lambda_prior*||z||_1
    nonfinite: torch.Tensor  # scalar int32: non-finite entries of z


class ReconTrace(NamedTuple):
    # the slot-wise solve (_reconstruct_impl) carries one row per slot:
    # [n, max_it + 1] traces and an [n] int32 tensor of iterations
    obj_vals: torch.Tensor  # [max_it + 1], index 0 = pre-iteration state
    psnr_vals: torch.Tensor  # [max_it + 1] (0 when x_orig is None)
    diff_vals: torch.Tensor  # [max_it + 1]
    num_iters: int
    extras: Optional[SolveExtras] = None


class ReconResult(NamedTuple):
    z: torch.Tensor  # [n, k, *spatial_padded]
    recon: torch.Tensor  # [n, *reduce, *data_spatial]
    trace: ReconTrace


def _solve_rho(cfg: SolveConfig, fg: common.FreqGeom) -> float:
    """The static quadratic-coupling constant of the z-solve (gamma
    cancels in gamma2/gamma1, so rho is a python float)."""
    return cfg.gamma_ratio * (
        fg.reduce_size if cfg.scale_rho_by_reduce else 1.0
    )


def _bank_digest(d) -> str:
    """Content fingerprint of a dictionary bank (shape + dtype + bytes),
    the same sha256 as the JAX package's, so both give one digest for
    one bank. Refuses a plan built from a different bank with the same
    filter count."""
    a = d.detach().cpu().numpy() if torch.is_tensor(d) else np.asarray(d)
    h = hashlib.sha256()
    h.update(str((a.shape, str(a.dtype))).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class ReconPlan:
    """Everything a reconstruction solve derives from the DICTIONARY
    alone (filter spectra, the per-frequency solve factors, the dirac
    gradient diagonal, the blur-OTF composition), computed once by
    :func:`build_plan` and reused across requests with
    ``reconstruct(plan=...)``. The inline path runs the same
    ``_plan_arrays``, so plan and inline solves are equal.

    ``prob``/``fg``/``rho``/``has_blur``/``d_digest``/``lambda_smooth``/
    ``herm_inv`` let ``reconstruct`` refuse a plan built for another
    problem, domain, coupling constant or bank.
    """

    dhat_clean: torch.Tensor  # [K, W, F] clean filter spectra
    dhat_solve: torch.Tensor  # [K, W, F] solve-side (blur-composed)
    kern: freq_solvers.ZSolveKernel
    prob: ReconstructionProblem
    fg: common.FreqGeom
    rho: float
    has_blur: bool
    d_digest: str
    lambda_smooth: float
    herm_inv: Optional[str] = None

    @property
    def num_filters(self) -> int:
        """K including any dirac channel."""
        return self.dhat_clean.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dhat_clean.device


def _add_dirac(d: torch.Tensor, geom: ProblemGeom, where: str) -> torch.Tensor:
    """Append/prepend an identity (dirac) filter channel."""
    shape = (1, *geom.reduce_shape, *geom.spatial_support)
    center = tuple([0] * (1 + geom.ndim_reduce)) + tuple(
        s // 2 for s in geom.spatial_support
    )
    dirac = torch.zeros(shape, dtype=d.dtype, device=d.device)
    dirac[center] = 1.0
    return (
        torch.cat([d, dirac], 0)
        if where == "append"
        else torch.cat([dirac, d], 0)
    )


def _grad_diag(fg: common.FreqGeom, lambda_smooth: float,
               device: torch.device) -> torch.Tensor:
    """lambda_smooth * sum_dims |OTF(forward difference)|^2, flat [F]
    (the TG term of the Poisson solver)."""
    ndim_s = len(fg.spatial_shape)
    tg = torch.zeros(fg.freq_shape, dtype=torch.float32, device=device)
    for ax in range(ndim_s):
        shape = [1] * ndim_s
        shape[ax] = 2
        diff = torch.tensor([1.0, -1.0], device=device).reshape(shape)
        otf = fourier.psf2otf(diff, fg.spatial_shape, impl=fg.fft_impl)
        tg = tg + torch.abs(otf) ** 2
    return lambda_smooth * tg.reshape(-1)


def _plan_arrays(d, prob, cfg, fg, blur_psf, fslice=None):
    """The operator-only precompute of one solve: dirac channel, filter
    spectra, blur-OTF composition, dirac gradient diagonal, and the
    per-frequency z-solve factors. Shared by the inline path of
    ``_reconstruct_impl`` and by :func:`build_plan`. ``fslice``: a
    'freq'-sharded solve's slicer; the z-solve factors are built on this
    rank's contiguous frequency slice, once per solve."""
    if fslice is None:
        fslice = lambda x: x
    geom = prob.geom
    if prob.dirac != "none":
        d = _add_dirac(d, geom, prob.dirac)
    K = d.shape[0]
    dirac_idx = 0 if prob.dirac == "prepend" else K - 1
    dhat_clean = common.filters_to_freq(d, fg)  # [K, W, F]
    if blur_psf is not None:
        blur_otf = fourier.psf2otf(
            blur_psf, fg.spatial_shape, impl=fg.fft_impl
        ).reshape(-1)
        dhat_solve = dhat_clean * blur_otf[None, None, :]
    else:
        dhat_solve = dhat_clean
    extra_diag = None
    if prob.grad_reg_dirac:
        tg = _grad_diag(fg, cfg.lambda_smooth, d.device)  # [F]
        extra_diag = torch.zeros((K, fg.num_freq), dtype=torch.float32,
                                 device=d.device)
        extra_diag[dirac_idx] = tg
    kern = freq_solvers.precompute_z_kernel(
        fslice(dhat_solve), _solve_rho(cfg, fg),
        fslice(extra_diag) if extra_diag is not None else None,
        herm_inv=cfg.herm_inv,
    )
    return dhat_clean, dhat_solve, kern


def check_mesh_plan(
    mesh_shape: Tuple[int, ...],
    slots: int,
    num_freq: int,
    buckets=None,
) -> None:
    """Refuse a serving mesh that cannot shard this plan's solve: the
    batch axis must divide ``slots`` (the bucket's concurrent request
    count; each position takes slots/batch whole n=1 solves) and the
    optional second axis must divide the FFT domain's frequency count.
    ``buckets`` (the engine's full (slots, spatial) table, when known)
    makes the error actionable at the configuration that caused it.
    The JAX package's checks and messages."""
    mesh_shape = tuple(int(a) for a in mesh_shape)
    blist = (
        list(buckets) if buckets is not None else f"slots={slots}"
    )
    if len(mesh_shape) < 1 or len(mesh_shape) > 2:
        raise ValueError(
            f"serving mesh shape must be (batch,) or (batch, freq), "
            f"got {mesh_shape}"
        )
    if slots % mesh_shape[0]:
        raise ValueError(
            f"mesh batch axis {mesh_shape[0]} does not divide the "
            f"bucket's {slots} slot(s) — every bucket's slots must be "
            f"a multiple of the batch axis (buckets: {blist}); "
            "resize the buckets or the mesh"
        )
    if len(mesh_shape) > 1 and num_freq % mesh_shape[1]:
        raise ValueError(
            f"mesh freq axis {mesh_shape[1]} does not divide the "
            f"plan's {num_freq} frequency bins (buckets: {blist}) — "
            "pick a freq axis that divides the FFT domain (fft_pad "
            "'pow2' helps) or drop the second mesh axis"
        )


def slice_kern(kern: freq_solvers.ZSolveKernel, index: int,
               parts: int) -> freq_solvers.ZSolveKernel:
    """Bins [index * F / parts, (index + 1) * F / parts) of every
    z-solve factor, each contiguous: the frequency axis is trailing for
    ``dhat`` / ``dinv`` / ``minv_diag`` and leading for ``minv`` (the
    JAX package's ``plan_freq_specs`` partition). Every factor is
    per-frequency independent, so the slice holds the same bits the
    unsliced solve uses at those bins."""
    F = kern.dinv.shape[-1]
    if F % parts:
        raise ValueError(f"{F} frequency bins do not split in {parts}")
    m = F // parts

    def cut(x, dim):
        return None if x is None else x.narrow(dim, index * m, m).contiguous()

    return freq_solvers.ZSolveKernel(
        dhat=cut(kern.dhat, -1), dinv=cut(kern.dinv, -1),
        minv=cut(kern.minv, 0), minv_diag=cut(kern.minv_diag, -1),
    )


def place_plan(plan: "ReconPlan", device, freq_index: int = 0,
               num_freq: int = 1) -> "ReconPlan":
    """One serving-mesh position's copy of ``plan`` on ``device``: the
    spectra replicated (the FFT boundary reads the whole spectrum), the
    z-solve factors cut to the position's ``freq_index``-th of
    ``num_freq`` bin slices and kept resident there (the JAX package's
    ``plan_freq_specs`` placement; ``_reconstruct_impl`` takes it with
    ``kern_presliced``). Tensors already on ``device`` are shared, not
    copied."""
    dev = torch.device(device)
    kern = plan.kern if num_freq == 1 else slice_kern(
        plan.kern, freq_index, num_freq)
    to = lambda t: None if t is None else t.to(dev)  # noqa: E731
    clean = to(plan.dhat_clean)
    solve = (clean if plan.dhat_solve is plan.dhat_clean
             else to(plan.dhat_solve))
    return dataclasses.replace(
        plan, dhat_clean=clean, dhat_solve=solve,
        kern=freq_solvers.ZSolveKernel(*(to(t) for t in kern)),
    )


def _as_input(name, x, device):
    """An entry-point array (numpy or tensor) as float32 on ``device``;
    None passes through."""
    return None if x is None else validate.as_float32(x, device, name)


def build_plan(
    d,
    prob: ReconstructionProblem,
    cfg: SolveConfig,
    data_spatial: Tuple[int, ...],
    blur_psf=None,
    device="cuda",
    mesh_shape: Optional[Tuple[int, ...]] = None,
    slots: Optional[int] = None,
    buckets=None,
) -> ReconPlan:
    """Precompute a :class:`ReconPlan` on ``device`` for observations of
    spatial shape ``data_spatial`` (the request shape BEFORE psf
    padding). A plan built with ``blur_psf`` already composes the OTF —
    callers then pass ``blur_psf=None`` to ``reconstruct``.

    ``mesh_shape``/``slots``/``buckets``: the serving-mesh contract
    (serve.CodecEngine with ServeConfig.mesh_shape). The plan's arrays
    are the same either way (:func:`place_plan` puts a copy on each
    position), but an incompatible mesh (batch axis not dividing the
    bucket's slots, freq axis not dividing the FFT domain) is refused
    HERE, before any work, with the bucket table in the error."""
    dev = resolve_device(device)
    d_t = _as_input("filters", d, dev)
    validate.check_filters(d_t, prob.geom)
    data_spatial = tuple(int(s) for s in data_spatial)
    fg = common.FreqGeom.create(
        prob.geom, data_spatial, pad=prob.pad, fft_pad=cfg.fft_pad,
        fft_impl=cfg.fft_impl,
    )
    if mesh_shape is not None:
        check_mesh_plan(
            mesh_shape, slots if slots is not None else 1,
            fg.num_freq, buckets=buckets,
        )
    dhat_clean, dhat_solve, kern = _plan_arrays(
        d_t, prob, cfg, fg, _as_input("blur_psf", blur_psf, dev)
    )
    return ReconPlan(
        dhat_clean=dhat_clean,
        dhat_solve=dhat_solve,
        kern=kern,
        prob=prob,
        fg=fg,
        rho=_solve_rho(cfg, fg),
        has_blur=blur_psf is not None,
        d_digest=_bank_digest(d),
        lambda_smooth=cfg.lambda_smooth,
        herm_inv=cfg.herm_inv,
    )


def reconstruct(
    b,
    d,
    prob: ReconstructionProblem,
    cfg: SolveConfig,
    mask=None,
    smooth_init=None,
    blur_psf=None,
    x_orig=None,
    mesh=None,
    plan: Optional[ReconPlan] = None,
    device="cuda",
) -> ReconResult:
    """Solve the coding problem for a batch of observations on
    ``device`` (default ``"cuda"``; raises when CUDA is absent).

    b: [n, *reduce, *data_spatial] observations (masked entries may hold
    anything). d: [k, *reduce, *support] dictionary. mask: same shape as
    b; None = fully observed. smooth_init: low-frequency offset
    subtracted before coding and added back to the reconstruction.
    blur_psf: spatial PSF composed into the solve operator; the final
    reconstruction uses the clean filters. x_orig: ground truth for the
    PSNR trace. Inputs are numpy arrays or tensors; they are moved to
    ``device`` as float32.

    plan: optional :class:`ReconPlan` (build_plan) pinning the operator
    precompute. It must match (prob, cfg, FFT domain, bank, device) or
    the call refuses; a plan built with a blur PSF already composes it,
    so ``blur_psf`` must be None then.

    mesh: a parallel.mesh.Mesh, called on every rank with the same
    (global) arguments. Its first axis splits the batch (n must divide);
    an optional second axis, 'freq', splits the per-frequency solves.
    Every batch-wide scalar (gamma's max, the objective, PSNR, the
    rel-change of the stop test) is reduced over the batch axis, so every
    rank stops at the same iteration. The traces come back replicated,
    ``z`` and ``recon`` as this rank's requests
    (parallel.mesh.gather_blocks assembles them). The run happens on
    ``mesh.device``. A plan does not combine with a mesh here: the
    plan-backed sharded solve is the mesh serving engine's.

    ``cfg.metrics_dir``: the call writes a ``"reconstruct"`` telemetry
    run (see :func:`_reconstruct_observed`).
    """
    if cfg.metrics_dir is not None:
        return _reconstruct_observed(
            b, d, prob, cfg, mask, smooth_init, blur_psf, x_orig, mesh, plan,
            device,
        )
    if mesh is not None:
        if plan is not None:
            raise ValueError(
                "plan does not combine with mesh on this entry point "
                "— reconstruct() shards by deriving the operator "
                "precompute inside each shard. For a plan-backed "
                "sharded solve, serve through the mesh engine: "
                "ServeConfig(mesh_shape=(batch[, freq])) (or "
                "CCSC_SERVE_MESH / serve.bench --mesh) places this "
                "plan on every mesh position with per-slot results "
                "equal to the single-device engine's"
            )
        axis = mesh.axis_names[0]
        nb = mesh.shape[axis]
        if np.shape(b)[0] % nb:
            raise ValueError(
                f"batch {np.shape(b)[0]} not divisible by mesh axis "
                f"'{axis}' size {nb}"
            )
        if len(mesh.axis_names) > 1 and mesh.axis_names[1:] != ("freq",):
            raise ValueError(
                f"second mesh axis must be 'freq', got {mesh.axis_names}"
            )
        if torch.device(device).type != mesh.device.type:
            raise ValueError(
                f"device={str(device)!r} but this rank's mesh runs on "
                f"{mesh.device}"
            )
    dev = resolve_device(device) if mesh is None else mesh.device
    b = _as_input("data", b, dev)
    d_in = d
    d = _as_input("filters", d, dev)
    mask = _as_input("mask", mask, dev)
    smooth_init = _as_input("smooth_init", smooth_init, dev)
    blur_psf = _as_input("blur_psf", blur_psf, dev)
    x_orig = _as_input("x_orig", x_orig, dev)
    validate.check_solve_inputs(
        b, d, prob.geom, cfg, mask=mask, smooth_init=smooth_init,
        x_orig=x_orig,
    )
    if plan is not None:
        if blur_psf is not None:
            raise ValueError(
                "the plan already composes its blur OTF — build the "
                "plan with blur_psf and pass blur_psf=None here"
            )
        expect_fg = common.FreqGeom.create(
            prob.geom, b.shape[-prob.geom.ndim_spatial:], pad=prob.pad,
            fft_pad=cfg.fft_pad, fft_impl=cfg.fft_impl,
        )
        if (
            plan.prob != prob
            or plan.fg != expect_fg
            or plan.rho != _solve_rho(cfg, expect_fg)
            # every cfg field _plan_arrays consumed must match
            or plan.herm_inv != cfg.herm_inv
            or (
                prob.grad_reg_dirac
                and plan.lambda_smooth != cfg.lambda_smooth
            )
        ):
            raise ValueError(
                f"plan mismatch: built for prob={plan.prob}, "
                f"fg={plan.fg}, rho={plan.rho} but this call needs "
                f"prob={prob}, fg={expect_fg}, "
                f"rho={_solve_rho(cfg, expect_fg)} — rebuild the plan "
                "with build_plan(d, prob, cfg, data_spatial)"
            )
        expect_k = d.shape[0] + (0 if prob.dirac == "none" else 1)
        if plan.num_filters != expect_k:
            raise ValueError(
                f"plan holds {plan.num_filters} filter spectra but the "
                f"dictionary (plus dirac) has {expect_k}"
            )
        if plan.d_digest != _bank_digest(d_in):
            raise ValueError(
                "plan was built from a different dictionary bank "
                f"(content fingerprint {plan.d_digest} != "
                f"{_bank_digest(d_in)}) — rebuild it with build_plan "
                "after any bank update"
            )
        if plan.device != dev:
            raise ValueError(
                f"plan lives on {plan.device} but this call solves on "
                f"{dev} — build the plan with device={str(dev)!r}"
            )
    if mesh is None:
        return _reconstruct_impl(
            b, d, prob, cfg, mask, smooth_init, blur_psf, x_orig, plan=plan
        )
    shard = lambda x: None if x is None else mesh_lib.fslice(
        x, mesh, axis, dim=0)
    return _reconstruct_impl(
        shard(b), d, prob, cfg, shard(mask), shard(smooth_init), blur_psf,
        shard(x_orig), mesh=mesh, axis_name=axis,
        freq_axis_name="freq" if "freq" in mesh.shape else None,
    )


def _reconstruct_observed(
    b, d, prob, cfg, mask, smooth_init, blur_psf, x_orig, mesh, plan, device,
):
    """Telemetry around one :func:`reconstruct` call (its
    ``cfg.metrics_dir``): the run metadata, the 1-based ``step`` records
    of the trace the solve returned, one ``roofline`` record, a
    ``heartbeat`` and the ``summary`` (iterations, wall seconds, initial
    and final objective). The solve itself runs untouched (the same call
    with ``metrics_dir=None``); the stream costs one read of its three
    traces after it, none inside the loop. (The JAX function reads the
    iteration count, its fence, and then the three traces.)"""
    from ..utils import obs

    dev = resolve_device(device) if mesh is None else mesh.device
    run = obs.start_run(
        cfg.metrics_dir, algorithm="reconstruct", verbose=cfg.verbose,
        geom=prob.geom, cfg=cfg, mesh=mesh, device=dev,
        data_shape=list(np.shape(b)),
        problem={"pad": prob.pad, "dirac": prob.dirac,
                 "data_term": prob.data_term},
    )
    try:
        t0 = time.perf_counter()
        res = reconstruct(
            b, d, prob, dataclasses.replace(cfg, metrics_dir=None),
            mask=mask, smooth_init=smooth_init, blur_psf=blur_psf,
            x_orig=x_orig, mesh=mesh, plan=plan, device=device,
        )
        tr = res.trace
        # the traces' one read (also the fence the wall time needs)
        obj, psnr, diff = torch.stack(
            [tr.obj_vals, tr.psnr_vals, tr.diff_vals]).double().cpu().numpy()
        dt = time.perf_counter() - t0
        # the host loop's own counter (a Python int): no read
        n_it = tr.num_iters
        # trace index 0 is the pre-iteration state; step records are
        # 1-based like every learner's
        for it in range(1, min(n_it + 1, obj.shape[0])):
            run.step(it=it, obj=float(obj[it]), psnr=float(psnr[it]),
                     diff=float(diff[it]))
        if n_it > 0:
            run.chunk(0, n_it, n_it, dt)
            run.heartbeat(n_it, dt)
        run.close(
            status="ok", iterations=n_it, wall_s=round(dt, 4),
            initial_obj=float(obj[0]) if obj.shape[0] else None,
            final_obj=float(obj[min(n_it, obj.shape[0] - 1)]),
        )
        return res
    finally:
        run.close(status="error")


def _reconstruct_impl(
    b, d, prob, cfg, mask, smooth_init, blur_psf, x_orig, plan=None,
    slotwise=False, mesh=None, axis_name=None, freq_axis_name=None,
    kern_presliced=False,
) -> ReconResult:
    """The solve on validated float32 tensors, all on one device.

    ``mesh`` / ``axis_name``: the tensors are this rank's batch shard;
    every batch-wide scalar is reduced over ``axis_name`` (gamma's max
    by pmax, the objective, PSNR's mse and the rel-change by psum), so
    the stop test reads the same value on every rank. ``freq_axis_name``:
    each rank solves its F / nf slice of the spectrum (the z-solve
    factors built on it once, contiguous, for K1) and one tiled
    all-gather per iteration reassembles it.

    ``slotwise`` (the serving engine's bucket solve): each leading index
    of ``b`` is a slot holding its own n=1 solve, as the JAX engine's
    vmap of n=1 solves has it: its own gamma heuristic (so its own prox
    weights), its own objective, PSNR and rel-change, its own stop. A
    slot that has stopped is frozen: every carried tensor, trace column
    and its iteration count are committed through ``torch.where(active,
    new, old)`` (the vmapped while_loop's select), so nothing of it
    changes after its stop and its later trace entries stay 0. Nothing
    reduces across slots but the count of active slots, read by the host
    once per iteration: zero ends the loop, and with every slot active
    the select is skipped (it would keep every new value). The z-solve
    runs once per iteration for all slots, one K1 launch on the card.
    The traces are then [n, max_it + 1] and ``num_iters`` an [n] int32
    tensor; with one slot the results are the plain path's, bit for bit
    on the CPU.

    With a ``plan`` and ``freq_axis_name`` (the mesh serving engine on
    a 'freq' axis, with ``axis_name`` None: slots reduce nothing), the
    plan's z-solve factors are cut to this position's bins, or, with
    ``kern_presliced``, already hold only them (``place_plan``)."""
    geom = prob.geom
    ndim_s = geom.ndim_spatial
    data_spatial = tuple(b.shape[-ndim_s:])
    radius = geom.psf_radius if prob.pad else (0,) * ndim_s
    fg = common.FreqGeom.create(
        geom, data_spatial, pad=prob.pad, fft_pad=cfg.fft_pad,
        fft_impl=cfg.fft_impl,
    )
    n = b.shape[0]
    dev = b.device
    # sums of the objective: over everything, or per slot
    total = common.slot_sum if slotwise else torch.sum

    def gsum(x):
        return mesh_lib.psum(x, mesh, axis_name)

    def fslice(x):
        return mesh_lib.fslice(x, mesh, freq_axis_name)

    K = (
        plan.num_filters
        if plan is not None
        else d.shape[0] + (0 if prob.dirac == "none" else 1)
    )
    dirac_idx = 0 if prob.dirac == "prepend" else K - 1
    # with a plan the blur OTF is baked into dhat_solve
    has_blur = plan.has_blur if plan is not None else blur_psf is not None

    # --- data-side constants ---------------------------------------
    M = torch.ones_like(b) if mask is None else mask
    B_pad = fourier.pad_spatial(b, radius, target=fg.spatial_shape)
    M_pad = fourier.pad_spatial(M, radius, target=fg.spatial_shape)
    smoothinit = (
        fourier.pad_spatial(
            smooth_init, radius, mode="symmetric", target=fg.spatial_shape
        )
        if smooth_init is not None
        else torch.zeros_like(B_pad)
    )
    if prob.data_term == "gaussian":
        MtM = M_pad * M_pad
        Mtb = B_pad * M_pad - smoothinit * M_pad
    else:  # poisson keeps raw counts
        MtM = M_pad
        Mtb = B_pad * M_pad

    # --- gamma heuristic: max over OBSERVED data only (a device
    # tensor — no host read); one per slot in the slot-wise mode ------
    b_max = (
        torch.amax((M * b).reshape(n, -1), dim=1)
        if slotwise
        else mesh_lib.pmax(torch.max(M * b), mesh, axis_name)
    )
    g = cfg.gamma_factor * cfg.lambda_prior / torch.clamp(b_max, min=1e-30)
    gamma1 = g / cfg.gamma_ratio
    gamma2 = g
    # gamma cancels in gamma2/gamma1: rho is a static python float
    rho = _solve_rho(cfg, fg)

    # --- operator precompute: from the plan, or derived inline ------
    if plan is not None:
        dhat_clean, dhat_solve, kern = (
            plan.dhat_clean, plan.dhat_solve, plan.kern,
        )
        if freq_axis_name is not None and not kern_presliced:
            kern = slice_kern(kern, mesh.axis_index(freq_axis_name),
                              mesh.shape[freq_axis_name])
    else:
        dhat_clean, dhat_solve, kern = _plan_arrays(
            d, prob, cfg, fg, blur_psf, fslice
        )

    channel_mask = None
    if not prob.sparsify_dirac and prob.dirac != "none":
        channel_mask = torch.ones(K, dtype=torch.bool, device=dev)
        channel_mask[dirac_idx] = False

    theta1 = cfg.lambda_residual / gamma1
    theta2 = cfg.lambda_prior / gamma2
    if slotwise:
        # each slot's weights broadcast over its own data / codes
        theta1 = theta1.reshape(n, *(1,) * (B_pad.ndim - 1))
        theta2 = theta2.reshape(n, *(1,) * (1 + ndim_s))

    # storage dtype of the code-sized carry tensors (z and its sparsity
    # dual); all math stays float32 (cast up at the top of each
    # iteration). With f32 storage the casts are identities.
    if cfg.storage_dtype == "float32":
        to_store = to_compute = lambda x: x
    else:
        store_dt = getattr(torch, cfg.storage_dtype)
        to_store = lambda x: x.to(store_dt)
        to_compute = lambda x: x.to(torch.float32)

    def data_prox(u):
        if prob.data_term == "gaussian":
            return proxes.masked_quadratic_prox(u, theta1, MtM, Mtb)
        return proxes.poisson_prox(u, theta1, MtM, Mtb)

    def Dz_real(zhat, dhat):
        return common.recon_from_freq(dhat, zhat, fg)

    M_crop = fourier.crop_spatial(M_pad, radius, data_spatial)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def objective(z, Dz):
        # Dz is the already computed solve-side reconstruction of the
        # iterate (also next iteration's v1): no extra Dz pass
        if not cfg.with_objective:
            return zero
        r = fourier.crop_spatial(Dz + smoothinit, radius, data_spatial) - b
        r = M_crop * r
        return (
            0.5 * cfg.lambda_residual * gsum(total(r * r))
            + cfg.lambda_prior * gsum(total(torch.abs(z)))
        )

    def psnr_of(zhat, Dz_solve):
        if x_orig is None or not cfg.with_psnr:
            return zero
        # without a blur operator the clean and solve spectra coincide
        Dz = Dz_real(zhat, dhat_clean) if has_blur else Dz_solve
        rec = fourier.crop_spatial(Dz + smoothinit, radius, data_spatial)
        return common.psnr(rec, x_orig, geom.psf_radius, per_slot=slotwise,
                           mesh=mesh, axis=axis_name)

    z_shape = (n, K, *fg.spatial_shape)
    z = torch.zeros(z_shape, dtype=torch.float32, device=dev)
    zhat = common.codes_to_freq(z, fg)
    v1 = Dz_real(zhat, dhat_solve)
    d1 = torch.zeros_like(v1)
    d2_s = to_store(torch.zeros(z_shape, dtype=torch.float32, device=dev))
    z_s = to_store(z)
    trace_shape = ((n,) if slotwise else ()) + (cfg.max_it + 1,)
    obj_t = torch.zeros(trace_shape, dtype=torch.float32, device=dev)
    psnr_t = torch.zeros(trace_shape, dtype=torch.float32, device=dev)
    diff_t = torch.zeros(trace_shape, dtype=torch.float32, device=dev)
    obj_t[..., 0] = objective(z, v1)
    psnr_t[..., 0] = psnr_of(zhat, v1)

    i = 0
    diff = float("inf")
    if slotwise:
        # each slot's while_loop cond, i < max_it and diff >= tol, on
        # the device; every slot enters the first iteration
        iters = torch.zeros(n, dtype=torch.int32, device=dev)
        diffs = torch.full((n,), float("inf"), device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        n_active = n if cfg.max_it > 0 else 0

        def keep(new, old):  # a stopped slot keeps its old value
            return torch.where(
                active.reshape(n, *(1,) * (max(new.ndim, old.ndim) - 1)),
                new, old,
            )

    # the JAX while_loop's cond: one scalar read per iteration (the stop
    # test, or the count of active slots)
    while n_active if slotwise else (i < cfg.max_it and diff >= cfg.tol):
        z = to_compute(z_s)
        d2 = to_compute(d2_s)
        u1 = data_prox(v1 - d1)
        u2_raw = z - d2
        u2 = proxes.skip_channels(
            proxes.soft_threshold(u2_raw, theta2), u2_raw, channel_mask
        )
        d1_new = d1 - (v1 - u1)
        d2 = d2 - (z - u2)
        xi1_hat = fslice(common.data_to_freq(u1 + d1_new, fg))
        xi2_hat = fslice(common.codes_to_freq(u2 + d2, fg))
        zhat_new = mesh_lib.all_gather_tiled(
            freq_solvers.solve_z(
                kern, xi1_hat, xi2_hat, rho, use_pallas=cfg.use_pallas
            ),
            mesh, freq_axis_name,
        )
        z_new = common.codes_from_freq(zhat_new, fg)
        # the iterate's reconstruction: next iteration's v1 AND this
        # iteration's objective/PSNR input — computed exactly once
        v1_new = Dz_real(zhat_new, dhat_solve)
        diff_d = common.rel_change(z_new, z, per_slot=slotwise, mesh=mesh,
                                   axis=axis_name)
        obj_d = objective(z_new, v1_new)
        psnr_d = psnr_of(zhat_new, v1_new)
        z_s_new, d2_s_new = to_store(z_new), to_store(d2)
        if slotwise and n_active < n:
            z_s_new, d2_s_new = keep(z_s_new, z_s), keep(d2_s_new, d2_s)
            zhat_new, v1_new = keep(zhat_new, zhat), keep(v1_new, v1)
            d1_new, diff_d = keep(d1_new, d1), keep(diff_d, diffs)
            obj_d = keep(obj_d, obj_t[:, i + 1])
            psnr_d = keep(psnr_d, psnr_t[:, i + 1])
        obj_t[..., i + 1] = obj_d
        psnr_t[..., i + 1] = psnr_d
        diff_t[..., i + 1] = diff_d
        z_s, d2_s, zhat, v1, d1 = z_s_new, d2_s_new, zhat_new, v1_new, d1_new
        i += 1
        if slotwise:
            iters = iters + active.to(torch.int32)
            diffs = diff_d
            active = (iters < cfg.max_it) & (diffs >= cfg.tol)
            n_active = int(active.sum())
        else:
            diff = float(diff_d)
    z = to_compute(z_s)

    extras = None
    if cfg.track_diagnostics:
        r = fourier.crop_spatial(v1 + smoothinit, radius, data_spatial) - b
        r = M_crop * r
        extras = SolveExtras(
            obj_fid=0.5 * cfg.lambda_residual * gsum(total(r * r)),
            obj_l1=cfg.lambda_prior * gsum(total(torch.abs(z))),
            nonfinite=gsum(
                total(~torch.isfinite(z)).to(torch.float32)
            ).to(torch.int32),
        )

    Dz = Dz_real(zhat, dhat_clean) + smoothinit
    recon = fourier.crop_spatial(Dz, radius, data_spatial)
    if prob.clamp_nonneg:
        recon = torch.clamp(recon, min=0.0)
    return ReconResult(
        z, recon,
        ReconTrace(obj_t, psnr_t, diff_t, iters if slotwise else i, extras),
    )
