"""Masked-boundary dictionary learner, single device (torch port of
``ccsc_code_iccv2017_tpu.models.learn_masked``): the reference's
non-consensus ADMM 2-3D/DictionaryLearning/admm_learn.m.

Differences from the consensus learner (models.learn):

- Both subproblems are 2-function ADMMs with a MASKED data prox: the
  padded border is excluded from the residual by a zero mask
  (admm_learn.m:255-260), and a low-frequency ``smooth_init`` offset is
  subtracted from the data before coding and added back at the end
  (:18-19, :258).
- Coupling weights come from the gamma heuristic g = 60 lambda / max(b):
  gammas_D = [g/5000, g], gammas_Z = [g/500, g] (:36-38); the divisors
  are the per-frequency solves' rho.
- Warm start: ``init_d`` seeds the dictionary (:50-58).
- Rollback: when neither pass improved the best objective, both
  iterates revert and the run stops (:204-213).

Dimension-generic: the hyperspectral learner is reduce_shape=(31,),
whose z-solve is the W = 31 Woodbury solve; reduce_shape=() is the 2D
masked learner (``learn_2d --masked``), whose z-solve is K1. On a 1-D
('freq',) mesh (parallel.mesh.freq_mesh) the state and data stay
replicated on every rank and each rank solves an F / nf slice of the
spectrum, one tiled all-gather per inner iteration reassembling it, as
the JAX package's 'freq'-sharded step. ``cfg.outer_chunk`` runs the
chunked outer loop (:func:`chunk_scan`). With ``cfg.metrics_dir`` the
run writes its telemetry stream under ``algorithm="masked_admm"``
(utils.obs): its roofline records carry it/s only, as the JAX package
has no cost model of the masked objective.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import LearnConfig, ProblemGeom
from ..ops import fourier, freq_solvers, proxes
from ..parallel import driver, mesh as mesh_lib
from ..utils import checkpoint as ckpt
from ..utils import obs, resilience, validate, watchdog
from ..utils.device import PhaseTimer, resolve_device
from . import common
from .learn import LearnResult, OuterMetrics, extract_filters


class MaskedLearnState(NamedTuple):
    d_full: torch.Tensor  # [k, *reduce, *spatial] full-domain filters
    dual_d1: torch.Tensor  # [n, *reduce, *spatial] data-side dual (d-pass)
    dual_d2: torch.Tensor  # [k, *reduce, *spatial] kernel-side dual
    z: torch.Tensor  # [n, k, *spatial]
    dual_z1: torch.Tensor  # [n, *reduce, *spatial] data-side dual (z-pass)
    dual_z2: torch.Tensor  # [n, k, *spatial] sparsity-side dual


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def init_state(
    generator: torch.Generator,
    geom: ProblemGeom,
    fg: common.FreqGeom,
    n: int,
    z_dtype=torch.float32,
    init_d: Optional[torch.Tensor] = None,
) -> MaskedLearnState:
    """The reference's init (admm_learn.m:50-58), drawn from
    ``generator`` on its device: one randn 2D spatial profile per filter
    replicated across the reduce dims (or ``init_d`` [k, *reduce,
    *support]), randn codes rounded to ``z_dtype``, zero duals. torch and
    jax random streams differ: parity tests pass the JAX init through
    ``convert.masked_state_from_jax``."""
    dev = generator.device
    if init_d is None:
        d0 = torch.randn((geom.num_filters, *geom.spatial_support),
                         generator=generator, device=dev)
        init_d = d0.reshape(
            geom.num_filters, *(1,) * geom.ndim_reduce, *geom.spatial_support
        ).expand(geom.filter_shape)
    d_full = fourier.circ_embed(init_d, fg.spatial_shape).contiguous()
    z0 = torch.randn((n, geom.num_filters, *fg.spatial_shape),
                     generator=generator, device=dev).to(z_dtype)
    x_shape = (n, *geom.reduce_shape, *fg.spatial_shape)
    zeros = torch.zeros(x_shape, device=dev)
    return MaskedLearnState(d_full, zeros, torch.zeros_like(d_full), z0,
                            zeros.clone(), torch.zeros_like(z0))


def outer_step(
    state: MaskedLearnState,
    b_pad: torch.Tensor,
    M_pad: torch.Tensor,
    smoothinit: torch.Tensor,
    geom: ProblemGeom,
    cfg: LearnConfig,
    fg: common.FreqGeom,
    gamma_div_d: float,
    gamma_div_z: float,
    on_phase: Optional[Callable[[str], None]] = None,
    mesh=None,
    poison: Optional[torch.Tensor] = None,
) -> Tuple[MaskedLearnState, OuterMetrics]:
    """One outer iteration: d-ADMM (admm_learn.m:102-136) then z-ADMM
    (:165-200), the JAX package's ``_outer_step_impl``. ``on_phase`` is
    called at the pass boundaries (d_start, d_end, z_start, z_end), as
    in models.learn.outer_step. ``mesh``: a ('freq',) mesh whose ranks
    each solve their slice of the spectrum (state and data replicated).
    ``poison`` (chaos testing, utils.faults): a 0-d bool tensor; where
    true the z iterate is NaN after the z-pass (models.learn.outer_step's
    seam); None launches nothing."""
    mark = on_phase or (lambda _name: None)
    ax_f = "freq" if mesh is not None else None

    def fslice(x):
        return mesh_lib.fslice(x, mesh, ax_f)

    def fgather(x):
        return mesh_lib.all_gather_tiled(x, mesh, ax_f)

    g = 60.0 * cfg.lambda_prior / torch.clamp(torch.max(M_pad * b_pad),
                                              min=1e-30)
    Mtb = (b_pad - smoothinit) * M_pad
    MtM = M_pad * M_pad
    rho_d = float(gamma_div_d)  # gammas(2)/gammas(1) is the divisor
    rho_z = float(gamma_div_z)
    sd = state.z.dtype  # z/dual_z2 storage; all math runs f32
    carry = cfg.carry_freq

    def prox_kernel(u):
        return proxes.kernel_constraint_proj(u, geom.spatial_support,
                                             fg.spatial_shape)

    def objective(z, zh, dhat):
        """The masked objective from z's live spectrum zh."""
        Dz = common.recon_from_freq(dhat, zh, fg)
        r = M_pad * (Dz + smoothinit - b_pad)
        return 0.5 * cfg.lambda_residual * torch.sum(r * r) + \
            common.l1_penalty(_f32(z), cfg.lambda_prior)

    def full_to_freq(d):
        return common.full_filters_to_freq(d, fg)

    # ------------------ d-pass (:102-136) ---------------------------
    mark("d_start")
    zhat = common.codes_to_freq(_f32(state.z), fg)
    dkern = freq_solvers.precompute_d_kernel(fslice(zhat), rho_d)
    theta_d = cfg.lambda_residual / (g / gamma_div_d)
    d_full, du1, du2 = state.d_full, state.dual_d1, state.dual_d2
    dhat = full_to_freq(d_full)
    for _ in range(cfg.max_it_d):
        v1 = common.recon_from_freq(dhat, zhat, fg)  # Dz
        u1 = proxes.masked_quadratic_prox(v1 - du1, theta_d, MtM, Mtb)
        u2 = prox_kernel(d_full - du2)
        du1 = du1 - (v1 - u1)
        du2 = du2 - (d_full - u2)
        xi1_hat = fslice(common.data_to_freq(u1 + du1, fg))
        xi2_hat = fslice(full_to_freq(u2 + du2))
        dhat_new = fgather(
            freq_solvers.solve_d(dkern, xi1_hat, xi2_hat, rho_d)
        )
        d_full = fourier.irfftn_spatial(
            dhat_new.reshape(dhat_new.shape[0], *fg.reduce_shape,
                             *fg.freq_shape),
            fg.spatial_shape, impl=fg.fft_impl,
        )
        # carry_freq: d_full is the inverse FFT of the solve's spectrum,
        # so reuse it instead of re-transforming d_full
        dhat = dhat_new if carry else full_to_freq(d_full)
    del dkern
    d_diff = common.rel_change(d_full, state.d_full)
    mark("d_end")
    # the objective only when tracked: it costs two reconstructions
    zero = torch.zeros((), dtype=torch.float32, device=b_pad.device)
    obj_d = objective(state.z, zhat, dhat) if cfg.with_objective else zero

    # ------------------ z-pass (:165-200) ---------------------------
    mark("z_start")
    zkern = freq_solvers.precompute_z_kernel(fslice(dhat), rho_z)
    theta_z = cfg.lambda_residual / (g / gamma_div_z)
    z_s, zdu1, zdu2_s = state.z, state.dual_z1, state.dual_z2
    zh = zhat  # the live spectrum of z
    for _ in range(cfg.max_it_z):
        z, zdu2 = _f32(z_s), _f32(zdu2_s)
        v1 = common.recon_from_freq(dhat, zh, fg)
        u1 = proxes.masked_quadratic_prox(v1 - zdu1, theta_z, MtM, Mtb)
        u2 = proxes.soft_threshold(z - zdu2, cfg.lambda_prior / g)
        zdu1 = zdu1 - (v1 - u1)
        zdu2 = zdu2 - (z - u2)
        xi1_hat = fslice(common.data_to_freq(u1 + zdu1, fg))
        xi2_hat = fslice(common.codes_to_freq(u2 + zdu2, fg))
        zh_new = fgather(
            freq_solvers.solve_z(zkern, xi1_hat, xi2_hat, rho_z)
        )
        z_s = common.codes_from_freq(zh_new, fg).to(sd)
        zdu2_s = zdu2.to(sd)
        # carry_freq as in the d-pass (the stored z may be rounded to
        # bf16; the carried spectrum is not, as in JAX)
        zh = zh_new if carry else common.codes_to_freq(_f32(z_s), fg)
    del zkern
    if poison is not None:
        # chaos injection: NaN the iterate so z_diff/obj_z go non-finite
        # exactly like a real blow-up
        z_s = torch.where(poison, torch.full_like(z_s, float("nan")), z_s)
    mark("z_end")
    z_diff = common.rel_change(z_s, state.z)
    obj_z = objective(z_s, zh, dhat) if cfg.with_objective else zero
    new = MaskedLearnState(d_full, du1, du2, z_s, zdu1, zdu2_s)
    return new, OuterMetrics(obj_d, obj_z, d_diff, z_diff)


def chunk_scan(state, prev, obj_best, b_pad, M_pad, smoothinit, geom, cfg,
               fg, gamma_div_d, gamma_div_z, chunk: int, mesh=None,
               poison_at: Optional[int] = None, donate: bool = False):
    """``chunk`` masked outer iterations with no host read between them
    (the JAX package's ``_chunk_scan_impl``, models/learn_masked.py:245
    there). The per-step driver's three stopping rules move onto the
    device:

    - non-finite metrics: the step is not adopted and ``done`` latches;
    - the objective rollback (admm_learn.m:204-213): when neither pass
      improved the best objective (``obj_best``, a 0-d float32 tensor),
      both iterates revert to ``prev`` and ``done`` latches;
    - the tol stop: the converged step is adopted, then ``done``
      latches.

    Returns (state, prev, obj_best, records) with records the stacked
    [chunk] tensors (obj_d, obj_z, d_diff, z_diff, active, adopted,
    rolled). Every select is ``torch.where`` (a taken branch is bitwise
    its input). ``donate``: the adopted values are written into
    ``state``'s and ``prev``'s own storage, so the caller's two input
    states carry the chunk (it must rebind both and pass distinct
    storages). ``poison_at``: chaos NaN injection at that 0-based step."""
    dev = b_pad.device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    best = obj_best
    ys = []
    st, pv = state, prev
    for j in range(chunk):
        poison = (torch.ones((), dtype=torch.bool, device=dev)
                  if poison_at == j else None)
        new, m = outer_step(st, b_pad, M_pad, smoothinit, geom, cfg, fg,
                            gamma_div_d, gamma_div_z, mesh=mesh,
                            poison=poison)
        finite = torch.all(torch.isfinite(
            torch.stack([m.obj_d, m.obj_z, m.d_diff, m.z_diff])))
        active = torch.logical_not(done)
        if cfg.with_objective:
            regressed = torch.logical_and(best <= m.obj_d, best <= m.obj_z)
        else:
            # untracked steps return 0.0: the rollback is disarmed
            regressed = torch.zeros((), dtype=torch.bool, device=dev)
        adopted = torch.logical_and(active, torch.logical_and(
            finite, torch.logical_not(regressed)))
        rolled = torch.logical_and(active, torch.logical_and(
            finite, regressed))
        # the new state into new's storage, then the rollback carry
        sel = [torch.where(rolled, p, torch.where(adopted, n, s, out=n),
                           out=n)
               for p, s, n in zip(pv, st, new)]
        if donate:
            for p, s in zip(pv, st):
                torch.where(adopted, s, p, out=p)
            for s, x in zip(st, sel):
                s.copy_(x)
            del sel
        else:
            pv = MaskedLearnState(*(torch.where(adopted, s, p)
                                    for p, s in zip(pv, st)))
            st = MaskedLearnState(*sel)
        del new
        best = torch.where(
            adopted, torch.minimum(best, torch.minimum(m.obj_d, m.obj_z)),
            best)
        converged = torch.logical_and(m.d_diff < cfg.tol, m.z_diff < cfg.tol)
        done = torch.logical_or(done, torch.logical_and(active, torch.logical_or(
            torch.logical_not(finite), torch.logical_or(regressed, converged))))
        ys.append((m.obj_d, m.obj_z, m.d_diff, m.z_diff, active, adopted,
                   rolled))
    recs = tuple(torch.stack([y[i] for y in ys]) for i in range(7))
    return st, pv, best, recs


def hbm_estimate(
    geom: ProblemGeom,
    data_spatial_shape: Tuple[int, ...],
    n: int,
    dtype_bytes: int = 4,
    num_freq_shards: int = 1,
    fg: Optional[common.FreqGeom] = None,
    z_dtype_bytes: Optional[int] = None,
) -> dict:
    """Analytic peak device-memory estimate (bytes) of one learn_masked
    step, the JAX package's formula unchanged.

    The masked learner cannot stream over images: its d-pass Woodbury
    inner system couples ALL n images per frequency (the [F, n, n] Gram
    inverse of precompute_d_kernel; admm_learn.m:273-300), so the whole
    state must be device-resident. Counts the resident state, the padded
    data triple, and the live frequency-domain temporaries of the bigger
    (z) pass, the working set approximated by the 3 largest simultaneous
    spectra. Frequency sharding divides only the per-shard solve
    temporaries, not the replicated state.
    """
    if fg is None:
        fg = common.FreqGeom.create(geom, data_spatial_shape)
    S = 1
    for s in fg.spatial_shape:
        S *= s
    F = fg.num_freq
    W = 1
    for w in geom.reduce_shape:
        W *= w
    k = geom.num_filters
    cplx = 2 * dtype_bytes
    Fl = F // max(1, num_freq_shards)
    # z/dual_z2 may be stored bf16 (LearnConfig.storage_dtype)
    zb = z_dtype_bytes if z_dtype_bytes is not None else dtype_bytes

    state = (
        2 * k * W * S  # d_full + kernel-side dual
        + 2 * n * W * S  # two data-side duals
    ) * dtype_bytes + 2 * n * k * S * zb  # z + sparsity-side dual
    data = 5 * n * W * S * dtype_bytes  # b_pad, M_pad, smoothinit, Mtb, MtM
    # z-pass live spectra: zhat-new, xi1, xi2 (+ the z-kernel)
    spectra = (2 * n * k * Fl + n * W * Fl + k * W * Fl) * cplx
    # d-pass Woodbury: code spectra + [F, n, n] Gram inverse
    woodbury = (n * k * Fl + Fl * n * n) * cplx
    total = state + data + max(spectra, woodbury)
    return {
        "state_bytes": state,
        "data_bytes": data,
        "spectra_bytes": spectra,
        "woodbury_bytes": woodbury,
        "total_bytes": total,
    }


def _preflight_hbm(geom, data_spatial_shape, n, device, fg=None,
                   z_dtype_bytes=None):
    """Warn before a step that cannot fit the card's memory (its total,
    from ``torch.cuda.mem_get_info``); returns the estimate."""
    est = hbm_estimate(geom, data_spatial_shape, n, fg=fg,
                       z_dtype_bytes=z_dtype_bytes)
    if device.type == "cuda":
        limit = torch.cuda.mem_get_info(device)[1]
        if est["total_bytes"] > 0.9 * limit:
            import warnings

            warnings.warn(
                f"learn_masked estimated peak device memory "
                f"{est['total_bytes'] / 1e9:.2f} GB vs the card's "
                f"{limit / 1e9:.2f} GB — likely OOM. The masked learner's "
                "d-pass couples all n images per frequency and cannot "
                "stream; shrink n, or switch to the consensus learner.",
                stacklevel=3,
            )
    return est


def learn_masked(
    b,
    geom: ProblemGeom,
    cfg: LearnConfig,
    smooth_init=None,
    init_d=None,
    generator: Optional[torch.Generator] = None,
    gamma_div_d: float = 5000.0,
    gamma_div_z: float = 500.0,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    device="cuda",
    initial_state: Optional[MaskedLearnState] = None,
) -> LearnResult:
    """Learn a filter bank from b [n, *reduce, *data_spatial] (numpy or
    tensor) on ``device`` (default ``"cuda"``; raises when CUDA is
    absent). ``smooth_init``: the same shape, the low-frequency offset;
    ``init_d`` [k, *reduce, *support]: warm start (admm_learn.m:50-58).

    ``generator``: the torch.Generator the random init draws from (on
    ``device``); None seeds one with 0. ``initial_state``: a
    MaskedLearnState to start from instead (the parity tests' seam).
    ``checkpoint_dir``: atomic snapshots every ``checkpoint_every`` outer
    iterations and resume-on-restart under the "masked_admm" fingerprint
    (a JAX checkpoint of the same problem resumes too). With
    ``cfg.max_recoveries > 0`` a non-finite step keeps the last good
    state, backs off the gamma divisors by ``cfg.rho_backoff`` and
    retries. SIGTERM/SIGINT checkpoint and exit at the next step. The
    objective rollback (admm_learn.m:204-213) reverts both iterates and
    stops. On the card the trace carries ``d_pass_ms`` / ``z_pass_ms``.
    ``cfg.watchdog`` arms the dispatch-fence watchdog around each step's
    host read (no cost model here, so the ``CCSC_WATCHDOG_MIN_S`` floor
    governs, as in JAX); ``CCSC_FAULT_*`` arm the chaos faults
    (utils.faults), at the consensus learner's points.

    ``mesh``: a 1-D ('freq',) parallel.mesh.Mesh (freq_mesh), called on
    every rank with the same arguments; the run happens on
    ``mesh.device``, every rank holds the whole (replicated) state and
    returns the same result, and the host-side decisions read rank 0's
    metrics. Checkpoints are written by rank 0.

    ``cfg.outer_chunk > 1`` (or ``cfg.donate_state``) runs the chunked
    outer loop (:func:`chunk_scan`): one host read a chunk, the rollback
    and the tol stop carried on the device, bitwise the per-step run.
    """
    if mesh is not None and mesh.axis_names != ("freq",):
        raise ValueError(
            f"learn_masked expects a 1-D ('freq',) mesh, got "
            f"{mesh.axis_names}"
        )
    # blocks=False: this solver never consensus-splits the batch
    validate.check_learn_inputs(b, geom, cfg, init_d=init_d,
                                smooth_init=smooth_init, blocks=False)
    validate.check_positive("learn_masked", gamma_div_d=gamma_div_d,
                            gamma_div_z=gamma_div_z)
    if cfg.compat_coding != "consensus":
        raise ValueError(
            "compat_coding is only supported by the consensus learner "
            "(models.learn)"
        )
    if mesh is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(
            f"device={str(device)!r} but this rank's mesh runs on "
            f"{mesh.device}"
        )
    dev = resolve_device(device) if mesh is None else mesh.device
    b = validate.as_float32(b, dev)
    ndim_s = geom.ndim_spatial
    n = b.shape[0]
    radius = geom.psf_radius
    data_sp = tuple(b.shape[-ndim_s:])
    fg = common.FreqGeom.create(geom, data_sp, fft_pad=cfg.fft_pad,
                                fft_impl=cfg.fft_impl)
    nf = mesh.shape["freq"] if mesh is not None else 1
    if fg.num_freq % nf:
        raise ValueError(
            f"num_freq={fg.num_freq} not divisible by num_freq_shards={nf}"
        )
    sd = getattr(torch, cfg.storage_dtype)
    _preflight_hbm(geom, data_sp, n, dev, fg=fg,
                   z_dtype_bytes=torch.finfo(sd).bits // 8)

    run = obs.start_run(
        cfg.metrics_dir, algorithm="masked_admm", verbose=cfg.verbose,
        geom=geom, cfg=cfg,
        fingerprint=resilience.config_fingerprint(geom, cfg, "masked_admm"),
        mesh=mesh, device=dev, data_shape=list(b.shape),
    )
    # hang/stall watchdog: no analytic cost model for the masked
    # objective, so the MIN_S floor (plus the first fence's build
    # allowance) governs its deadlines
    wd = watchdog.maybe_start(cfg, algorithm="masked_admm", device=dev)
    try:
        return _learn_masked_impl(
            b, geom, cfg, smooth_init, init_d, generator, gamma_div_d,
            gamma_div_z, mesh, checkpoint_dir, checkpoint_every, dev,
            initial_state, fg, sd, run, wd,
        )
    finally:
        if wd is not None:
            wd.stop()
        # idempotent backstop: only an escaping exception lands here with
        # the run still open
        run.close(status="error")


def _learn_masked_impl(
    b, geom, cfg, smooth_init, init_d, generator, gamma_div_d, gamma_div_z,
    mesh, checkpoint_dir, checkpoint_every, dev, initial_state, fg, sd, run,
    wd=None,
):
    n = b.shape[0]
    radius = geom.psf_radius
    data_sp = tuple(b.shape[-geom.ndim_spatial:])
    b_pad = fourier.pad_spatial(b, radius, target=fg.spatial_shape)
    # the mask is zero over ALL padding (incl. any fast-FFT extra), so
    # the masked data prox excludes it (admm_learn.m:255)
    M_pad = fourier.pad_spatial(torch.ones_like(b), radius,
                                target=fg.spatial_shape)
    if smooth_init is not None:
        smoothinit = fourier.pad_spatial(
            validate.as_float32(smooth_init, dev, "smooth_init"), radius,
            mode="symmetric", target=fg.spatial_shape,
        )
    else:
        smoothinit = torch.zeros_like(b_pad)

    if initial_state is not None:
        # a donated state is written in place: never the caller's tensors
        own = (lambda t: t.to(dev).clone()) if cfg.donate_state else \
            (lambda t: t.to(dev).contiguous())
        state = MaskedLearnState(*(own(t) for t in initial_state))
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        state = init_state(
            generator, geom, fg, n, z_dtype=sd,
            init_d=None if init_d is None
            else validate.as_float32(init_d, dev, "init_d"),
        )
    x_shape = (n, *geom.reduce_shape, *fg.spatial_shape)
    d_shape = (*geom.filter_shape[:1 + geom.ndim_reduce], *fg.spatial_shape)
    z_shape = (n, geom.num_filters, *fg.spatial_shape)
    expect = dict(d_full=d_shape, dual_d1=x_shape, dual_d2=d_shape,
                  z=z_shape, dual_z1=x_shape, dual_z2=z_shape)
    driver.check_shapes("state", state._asdict(), expect)
    fingerprint = resilience.config_fingerprint(geom, cfg, "masked_admm")
    fields, trace, start_it = driver.resume(cfg, checkpoint_dir, fingerprint,
                                            expect)
    if fields is not None:
        state = MaskedLearnState(**{k: v.to(dev) for k, v in fields.items()})
    # rho-backoff recovery: the gamma divisors are this learner's rho
    trace, recov = driver.start_trace(cfg, trace, "masked_admm")

    # untracked iterations persist 0.0 placeholders; real objectives are
    # strictly positive, so a resumed best ignores the placeholders
    seen = [v for v in trace["obj_vals_d"] + trace["obj_vals_z"] if v > 0.0]
    obj_best = min(seen) if seen else math.inf
    # the pass (JAX models/learn_masked.py:750-900): one step
    # (:func:`outer_step`), adopted or rolled back on the host after the
    # pass's read, or with ``cfg.chunked_driver`` a chunk of
    # :func:`chunk_scan`, which carries the three stopping rules on the
    # device
    chunked = cfg.chunked_driver
    timer = None if chunked else PhaseTimer(dev)
    new = None
    # the rollback carry needs its own storage when both are written in
    # place: one state copy up front, as JAX's
    prev = (MaskedLearnState(*(t.clone() for t in state))
            if cfg.donate_state else state)
    # the best objective: on the device for a chunk, on the host for a step
    best = torch.tensor(obj_best, dtype=torch.float32, device=dev) \
        if chunked else obj_best

    def launch(i, clen, poison_at):
        nonlocal state, prev, best, new
        gd, gz = gamma_div_d * recov.scale, gamma_div_z * recov.scale
        if chunked:
            state, prev, best, ys = chunk_scan(
                state, prev, best, b_pad, M_pad, smoothinit, geom, cfg, fg,
                gd, gz, clen, mesh=mesh, poison_at=poison_at,
                donate=cfg.donate_state,
            )
        else:
            new, m = outer_step(
                state, b_pad, M_pad, smoothinit, geom, cfg, fg, gd, gz,
                on_phase=timer, mesh=mesh, poison=None if poison_at is None
                else torch.ones((), dtype=torch.bool, device=dev),
            )
            ys = (m.obj_d, m.obj_z, m.d_diff, m.z_diff)
        return torch.cat([y.to(torch.float32).reshape(-1) for y in ys])

    def adopt(cols):
        nonlocal state, prev, best, new
        if chunked:
            return cols[:4], *cols[4:]  # active, adopted, rolled
        # non-finite guard: NaN metrics would sail through the regression
        # test and poison the adopted state; the rollback
        # (admm_learn.m:204-213) is armed only when the objective is
        # tracked (untracked steps return 0.0)
        finite = all(math.isfinite(c[0]) for c in cols)
        regressed = (cfg.with_objective and best <= cols[0][0]
                     and best <= cols[1][0])
        if finite and not regressed:
            prev, state = state, new
            best = min(best, cols[0][0], cols[1][0])
        elif finite:
            state = prev
        new = None
        return cols, [True], [finite and not regressed], [finite and regressed]

    def series(extras):
        phases = timer.read() if timer is not None else None
        if phases is None:
            return (), {}
        return (("d_pass_ms", phases[0]), ("z_pass_ms", phases[1])), {}

    def save(it):
        # the (replicated) state: written by rank 0 of a mesh, every rank
        # waiting for it
        if mesh is None or mesh.rank == 0:
            ckpt.save(checkpoint_dir, state, trace, it,
                      fingerprint=fingerprint)
        mesh_lib.barrier(mesh)

    it_done = driver.Driver(
        cfg, run, trace, recov, save, checkpoint_dir, checkpoint_every,
    ).passes(
        launch, adopt, series, start_it, tag="masked_outer",
        line="Iter {it}, Obj_d {obj_d:.5g}, Obj_z {obj_z:.5g}, Diff_d "
             "{d_diff:.3g}, Diff_z {z_diff:.3g}", mesh=mesh, wd=wd)

    # the outputs
    dhat = common.full_filters_to_freq(state.d_full, fg)
    d_proj = proxes.kernel_constraint_proj(state.d_full, geom.spatial_support,
                                           fg.spatial_shape)
    zhat = common.codes_to_freq(_f32(state.z), fg)
    Dz = common.recon_from_freq(dhat, zhat, fg) + smoothinit
    Dz = fourier.crop_spatial(Dz, radius, data_sp)
    run.close(status="ok", iterations=it_done,
              wall_s=round(trace["tim_vals"][-1], 4))
    return LearnResult(extract_filters(d_proj, geom), state.z[None], Dz,
                       trace)
