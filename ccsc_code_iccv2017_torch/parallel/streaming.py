"""Host-streaming consensus learning: one block on the card at a time
(torch port of ``ccsc_code_iccv2017_tpu.parallel.streaming``).

The CCSC paper's memory claim is that consensus splitting bounds working
memory to one block's codes: the reference keeps per-block cells in host
RAM and touches one at a time (dzParallel.m:96-158). The in-memory
learner (parallel.consensus) keeps every block on the card; this module
is the single-card path for data that does not fit, with three placement
tiers, chosen by a byte budget or forced (same math, same
block-sequential loop):

- ``device``: all block state on the card; Python only sequences the
  per-block work. For state that fits but whose in-memory full-batch
  spectra temporaries do not. No host traffic per iteration.
- ``kern``: block state in host RAM, one block on the card at a time,
  but the d-pass kernels (constant within an outer step) and the data
  spectra stay on the card.
- ``paged``: everything in host RAM; the card holds one block's tensors
  and the consensus variables.

Exactness: streaming reorders block-independent work only. The z-pass
has no cross-block terms, so each block's whole inner loop runs alone;
the d-pass couples blocks through the consensus averages Dbar/Udbar
(dzParallel.m:115-121), formed after every block's solve in each
d-iteration, the barrier this loop keeps. The result matches the
in-memory learner up to float summation order.

Cost: per outer step the host traffic of the ``paged`` tier is
max_it_d * N uploads of a block's d-pass kernel (code spectra, Woodbury
inverse, the hoisted Z^H b) plus O(N |z|) for the z-pass and the
objectives; ``kern`` pays the z-pass's O(N |z|). Every copy is blocking
(overlap with compute is a perf line of ROADMAP.md Queue 1).

Host tiers hold CPU torch tensors (bfloat16 storage included). Block
tensors are never updated in place: every step rebinds a list entry, so
the divergence-recovery snapshot is a set of shallow list copies.

Differences from the JAX module: ``generator`` (a torch.Generator) and
``initial_state`` take the place of ``key``; without them the init is
drawn on the host from seed 0 and placed block by block. The d-pass
kernel hoists Z^H b, as the port's in-memory learner does, so the paged
d-pass uploads no data spectra. The z-diff sums run on the card in every
tier. With ``cfg.metrics_dir`` the run writes its telemetry stream under
``algorithm="consensus_streaming"`` (utils.obs), each step scored
against the consensus step's analytic cost (the host copies of the paged
tiers are not in that model). The watchdog and the chaos faults are the
JAX module's (utils.watchdog, utils.faults). ``cfg.outer_chunk > 1``
moves the host read to chunk granularity: the steps' metrics stay on the
card and are read in one flush every ``outer_chunk`` steps, as in JAX;
the state advances in place, so a tol hit inside a chunk stops at the
chunk's end and the trace covers every step the state went through.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import torch

from ..config import LearnConfig, ProblemGeom
from ..models import common, learn as learn_mod
from ..ops import freq_solvers
from . import driver
from ..utils import checkpoint as ckpt
from ..utils import env, faults, obs, perfmodel, resilience, validate
from ..utils import watchdog
from ..utils.device import PhaseTimer, resolve_device
from ..utils.resilience import console

TIERS = ("device", "kern", "paged")
# an adopted step's console line (Driver.record)
_LINE = ("Iter {it}, Obj_z {obj_z:.4g}, Diff_d {d_diff:.3g}, Diff_z "
         "{z_diff:.3g}, t {t_total:.2f}s")


def placement_bytes(b_shape, geom: ProblemGeom, cfg: LearnConfig,
                    fg: common.FreqGeom) -> dict:
    """The byte counts the ``auto`` tier selection weighs, formula for
    formula as the JAX module (streaming.py:399-412): every block's
    d-pass kernel, the data spectra cache, the block state with the raw
    data, and one block's complex temporaries."""
    N = cfg.num_blocks
    n = b_shape[0]
    ni = n // N
    K = geom.num_filters
    F = fg.num_freq
    spatial = math.prod(fg.spatial_shape)
    z_item = getattr(torch, cfg.storage_dtype).itemsize
    d_item = getattr(torch, cfg.d_storage_dtype).itemsize
    return {
        "kern": N * 2 * 4 * (ni * K + ni * ni) * F,
        "bhat": N * ni * fg.reduce_size * F * 8,
        "state": (2 * N * ni * K * spatial * z_item  # z + dual_z
                  + 2 * N * K * fg.reduce_size * spatial * d_item
                  + n * math.prod(b_shape[1:]) * 4),  # the raw data
        "temp": 5 * ni * K * F * 8,
    }


def select_tier(sizes: dict, budget_bytes: float, mode: str = "auto") -> str:
    """The placement tier: ``mode`` itself unless it is ``auto``, then
    the most resident tier whose bytes fit ``budget_bytes``."""
    if mode not in ("auto",) + TIERS:
        raise ValueError(f"stream mode must be auto | device | kern | "
                         f"paged, got {mode!r}")
    if mode != "auto":
        return mode
    resident = sizes["kern"] + sizes["bhat"] + sizes["temp"]
    if sizes["state"] + resident <= budget_bytes:
        return "device"
    return "kern" if resident <= budget_bytes else "paged"


class _Mover:
    """Blocking copies between the host and the card, counted in bytes
    (a copy to where the tensor already is is free and not counted)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.h2d = 0
        self.d2h = 0

    def up(self, x):
        if x is None or x.device == self.dev:
            return x
        self.h2d += x.numel() * x.element_size()
        return x.to(self.dev)

    def down(self, x):
        if x is None or x.device.type == "cpu":
            return x
        self.d2h += x.numel() * x.element_size()
        return x.to("cpu")


def _kern_to(kern: freq_solvers.DSolveKernel, move):
    return freq_solvers.DSolveKernel(*(move(t) for t in kern))


def _restore(snap):
    """A recovery snapshot's lists, copied, so the replay can rebind
    entries without touching the snapshot (a second divergence restores
    from it again)."""
    d_local, dual_d, z, dual_z, dbar, udbar, it = snap
    return (list(d_local), list(dual_d), list(z), list(dual_z), dbar, udbar,
            it)


def learn_streaming(
    b,
    geom: ProblemGeom,
    cfg: LearnConfig,
    generator: Optional[torch.Generator] = None,
    stream_mode: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    device="cuda",
    initial_state: Optional[learn_mod.LearnState] = None,
) -> learn_mod.LearnResult:
    """The consensus learner with host-resident block state on
    ``device`` (default ``"cuda"``; raises when CUDA is absent). b:
    [n, *reduce, *data_spatial], numpy or a tensor; it stays on the host.

    ``stream_mode``: 'auto' | 'device' | 'kern' | 'paged', taking
    precedence over ``CCSC_STREAM_MODE``; 'auto' (or None with the knob
    unset) picks the most resident tier whose bytes
    (:func:`placement_bytes`) fit ``CCSC_STREAM_RESIDENT_GB`` (default
    10). The tier is recorded in ``trace['stream_mode']``.

    ``generator``: the torch.Generator the random init draws from (on its
    own device; the blocks are then placed per tier); None draws on the
    host from seed 0. ``initial_state``: a models.learn.LearnState to
    start from instead (the seam the parity tests use to hand over the
    JAX init).

    ``checkpoint_dir``: snapshots every ``checkpoint_every`` outer steps
    in the stacked LearnState layout under the ``consensus_streaming``
    fingerprint, assembled one block at a time, and resume (a JAX
    streaming checkpoint of the same problem resumes too). Non-finite
    metrics stop the run (the state has advanced in place); with
    ``cfg.max_recoveries > 0`` the state of the last good step is
    restored, rho backs off by ``cfg.rho_backoff`` and the step is
    replayed. SIGTERM/SIGINT checkpoint and exit at the next step.
    ``cfg.watchdog`` arms the dispatch-fence watchdog around each step
    (its one host read is the fence), seeded with the consensus step's
    analytic cost, as in JAX; ``CCSC_FAULT_*`` arm the chaos faults
    (utils.faults: the NaN poisons block 0's codes of its step).

    Returns d, z and Dz on the host. The trace also carries, per step,
    the bytes copied host-to-device and device-to-host (``h2d_bytes``,
    ``d2h_bytes``) and, on the card, the d-pass and z-pass times
    (``d_pass_ms``/``z_pass_ms``, CUDA events)."""
    validate.check_learn_inputs(b, geom, cfg)
    if cfg.compat_coding != "consensus":
        raise ValueError(
            "compat_coding is only supported by the in-memory consensus "
            "learner (models.learn)"
        )
    if cfg.donate_state:
        raise ValueError(
            "donate_state is only supported by the in-memory learners "
            "(models.learn / models.learn_masked)"
        )
    dev = resolve_device(device)
    host = torch.device("cpu")
    b = validate.as_float32(b, host)
    ndim_s = geom.ndim_spatial
    n = b.shape[0]
    N = cfg.num_blocks
    ni = n // N
    data_sp = tuple(b.shape[-ndim_s:])
    fg = common.FreqGeom.create(
        geom, data_sp, fft_pad=cfg.fft_pad, fft_impl=cfg.fft_impl
    )
    b_blocks = b.reshape(N, ni, *b.shape[1:])

    run = obs.start_run(
        cfg.metrics_dir, algorithm="consensus_streaming",
        verbose=cfg.verbose, geom=geom, cfg=cfg,
        fingerprint=resilience.config_fingerprint(
            geom, cfg, "consensus_streaming"),
        device=dev, data_shape=list(b.shape), stream_mode=stream_mode,
    )
    step_cost = None
    if run.active or cfg.watchdog:
        # the streamed math is the consensus outer step, so its analytic
        # roofline applies (the paged tiers' host copies are not in it);
        # the watchdog's deadline comes from its bound, and its
        # self-calibration and the CCSC_WATCHDOG_MIN_S floor cover the
        # paging the model does not see
        step_cost = perfmodel.analytic_outer_step_cost(
            num_blocks=N, ni=ni, k=geom.num_filters,
            spatial=fg.spatial_shape, num_freq=fg.num_freq,
            max_it_d=cfg.max_it_d, max_it_z=cfg.max_it_z,
            reduce_size=geom.reduce_size,
            state_dtype_bytes=getattr(torch, cfg.storage_dtype).itemsize,
            d_state_dtype_bytes=getattr(torch, cfg.d_storage_dtype).itemsize,
            fft_impl=cfg.fft_impl,
        )
    wd = watchdog.maybe_start(cfg, cost=step_cost,
                              algorithm="consensus_streaming", device=dev)
    try:
        return _learn_streaming_impl(
            b_blocks, geom, cfg, generator, stream_mode, checkpoint_dir,
            checkpoint_every, dev, initial_state, fg, run, step_cost, wd,
        )
    finally:
        if wd is not None:
            wd.stop()
        # idempotent backstop for escaping exceptions
        run.close(status="error")


def _learn_streaming_impl(
    b_blocks, geom, cfg, generator, stream_mode, checkpoint_dir,
    checkpoint_every, dev, initial_state, fg, run, step_cost=None, wd=None,
):
    host = torch.device("cpu")
    N, ni = b_blocks.shape[0], b_blocks.shape[1]
    data_sp = tuple(b_blocks.shape[-geom.ndim_spatial:])
    d_shape = (geom.num_filters, *geom.reduce_shape, *fg.spatial_shape)
    z_shape = (N, ni, geom.num_filters, *fg.spatial_shape)
    expect = dict(d_local=(N, *d_shape), dual_d=(N, *d_shape),
                  dbar=d_shape, udbar=d_shape, z=z_shape, dual_z=z_shape)
    fingerprint = resilience.config_fingerprint(
        geom, cfg, "consensus_streaming"
    )
    fields, trace, start_it = driver.resume(cfg, checkpoint_dir, fingerprint,
                                            expect)
    src = initial_state if fields is None else learn_mod.LearnState(**fields)
    if src is None:
        if generator is None:
            generator = torch.Generator(device=host).manual_seed(0)
        src = learn_mod.init_state(
            generator, geom, fg, N, ni, torch.float32,
            z_dtype=getattr(torch, cfg.storage_dtype),
            d_dtype=getattr(torch, cfg.d_storage_dtype),
        )
    driver.check_shapes("state", src._asdict(), expect)
    # the producer's identity: a .mat saved from a --streaming run records
    # which objective produced it
    trace, recov = driver.start_trace(cfg, trace, "consensus_streaming",
                                      lambda: 0.0)

    budget = env.env_float("CCSC_STREAM_RESIDENT_GB") * 1e9
    mode = select_tier(
        placement_bytes((N * ni, *b_blocks.shape[2:]), geom, cfg, fg),
        budget, stream_mode or env.env_str("CCSC_STREAM_MODE"))
    trace["stream_mode"] = mode
    device_state = mode == "device"
    kern_resident = mode in ("device", "kern")
    mv = _Mover(dev)
    # where block state lives between its uses: the one placement seam
    hold = mv.up if device_state else mv.down

    # block lists: each step rebinds entries, never writes into them
    d_local = [hold(src.d_local[nn]) for nn in range(N)]
    dual_d = [hold(src.dual_d[nn]) for nn in range(N)]
    z = [hold(src.z[nn]) for nn in range(N)]
    dual_z = [hold(src.dual_z[nn]) for nn in range(N)]
    # the consensus lives on the card in every tier, in float32
    dbar = src.dbar.to(dev, torch.float32)
    udbar = src.udbar.to(dev, torch.float32)
    del src
    mv.h2d = mv.d2h = 0  # placing the init is set-up, not a step's traffic

    # the raw data and its spectra are constant for the run: device tier
    # keeps both on the card, kern keeps the spectra, paged recomputes
    # them from the host for each use
    b_cache = ([mv.up(b_blocks[nn]) for nn in range(N)] if device_state
               else None)

    def get_b(nn):
        return b_cache[nn] if device_state else mv.up(b_blocks[nn])

    bhat_cache = ([learn_mod.f_bhat(get_b(nn), geom, fg) for nn in range(N)]
                  if kern_resident else None)

    def get_bhat(nn):
        if kern_resident:
            return bhat_cache[nn]
        return learn_mod.f_bhat(get_b(nn), geom, fg)

    def save(it):
        """Block-sequential checkpoint: one block to the host at a time,
        stacked into the LearnState layout."""
        st = learn_mod.LearnState(
            d_local=torch.stack([x.cpu() for x in d_local]),
            dual_d=torch.stack([x.cpu() for x in dual_d]),
            dbar=dbar.cpu(), udbar=udbar.cpu(),
            z=torch.stack([x.cpu() for x in z]),
            dual_z=torch.stack([x.cpu() for x in dual_z]),
        )
        ckpt.save(checkpoint_dir, st, trace, it, fingerprint=fingerprint)

    def snapshot(it):
        return (list(d_local), list(dual_d), list(z), list(dual_z), dbar,
                udbar, it)

    # divergence recovery restores the state of the last good step
    rec_snap = snapshot(start_it) if recov.enabled else None
    timer = PhaseTimer(dev)
    it_done = start_it
    diverged = False
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pending = []  # (it, [5] device metrics, h2d, d2h, phase events)
    t_chunk0 = 0.0
    drv = driver.Driver(cfg, run, trace, recov, save, checkpoint_dir,
                        checkpoint_every, step_cost=step_cost)

    with drv.gs:
        i = start_it
        stop = False
        fresh_pieces = True  # the first chunk builds the kernels
        while i < cfg.max_it and not stop:
            c = recov.cfg  # rho as backed off so far
            if not pending:
                t_chunk0 = time.perf_counter()
                if wd is not None:
                    # one armed window a chunk: the chunk is many small
                    # launches, but a hang in any of them stalls its read
                    wd.arm(cfg.outer_chunk, f"stream_outer_{i}",
                           may_compile=fresh_pieces)
            na = faults.nan_iteration()
            h2d0, d2h0 = mv.h2d, mv.d2h
            dbar_prev = dbar
            # ---- d-pass: kernels fixed at the incoming codes ----------
            timer("d_start")
            kerns = []
            for nn in range(N):
                k = learn_mod.f_dkern(mv.up(z[nn]), get_bhat(nn), c, fg)
                kerns.append(k if kern_resident else _kern_to(k, mv.down))
            del k  # paged: no block's kernel stays on the card
            dsd = d_local[0].dtype  # d-state storage (d_storage_dtype)
            for _ in range(c.max_it_d):
                u = learn_mod.f_prox(dbar, udbar, geom, fg)
                d_sum = du_sum = zero
                for nn in range(N):
                    d_new, du_new = learn_mod.f_d_block(
                        _kern_to(kerns[nn], mv.up), mv.up(d_local[nn]),
                        mv.up(dual_d[nn]), u, c, fg,
                    )
                    d_new, du_new = d_new.to(dsd), du_new.to(dsd)
                    d_local[nn] = hold(d_new)
                    dual_d[nn] = hold(du_new)
                    d_sum = d_sum + d_new.float()
                    du_sum = du_sum + du_new.float()
                # the consensus barrier (dzParallel.m:115-121)
                dbar, udbar = d_sum / N, du_sum / N
            del kerns
            d_diff = common.rel_change(dbar, dbar_prev)
            dhat_z = learn_mod.f_full_dhat(
                learn_mod.f_prox(dbar, udbar, geom, fg), fg
            )
            timer("d_end")
            # the objective after the d-pass, codes not yet updated
            # (dParallel.m:62-71)
            obj_d = zero
            if c.with_objective:
                for nn in range(N):
                    obj_d = obj_d + learn_mod.f_obj_block(
                        mv.up(z[nn]), get_b(nn), dhat_z, geom, c, fg
                    )

            # ---- z-pass: blocks independent ---------------------------
            timer("z_start")
            zkern = freq_solvers.precompute_z_kernel(dhat_z, c.rho_z)
            num = den = obj_z = zero
            for nn in range(N):
                z_old = mv.up(z[nn])
                z_new, du_new = learn_mod.f_z_block(
                    z_old, mv.up(dual_z[nn]), get_bhat(nn), zkern, c, fg
                )
                if na == i + 1 and nn == 0:
                    # chaos injection (utils.faults): NaN block 0's codes
                    # so the step's metrics go non-finite
                    z_new = torch.full_like(z_new, float("nan"))
                ssd, ssq = learn_mod.z_diff_sums(z_new, z_old)
                num, den = num + ssd, den + ssq
                z[nn] = hold(z_new)
                dual_z[nn] = hold(du_new)
                if c.with_objective:
                    obj_z = obj_z + learn_mod.f_obj_block(
                        z_new, get_b(nn), dhat_z, geom, c, fg
                    )
                del z_old, z_new, du_new
            del zkern
            timer("z_end")
            if na == i + 1:
                faults.consume_nan()

            pending.append((i, torch.stack([obj_d, obj_z, d_diff, num, den]),
                            mv.h2d - h2d0, mv.d2h - d2h0,
                            dict(timer.events) if timer.enabled else None))
            if len(pending) < cfg.outer_chunk and i < cfg.max_it - 1:
                i += 1
                continue

            # ---- the chunk's one host read (also its fence) ----------
            flat = torch.stack([p[1] for p in pending]).tolist()
            dt = time.perf_counter() - t_chunk0
            vals = []  # (it, metrics, series) a step
            for (it, _, h2d, d2h, evs), (o_d, o_z, dd, num_, den_) in zip(
                    pending, flat):
                zd = math.sqrt(num_) / max(math.sqrt(den_), 1e-30)
                series = (("h2d_bytes", h2d), ("d2h_bytes", d2h))
                if evs is not None:
                    series += (
                        ("d_pass_ms", evs["d_start"].elapsed_time(
                            evs["d_end"])),
                        ("z_pass_ms", evs["z_start"].elapsed_time(
                            evs["z_end"])))
                vals.append((it, (o_d, o_z, dd, zd), series))
            pending = []
            # injected hang fires INSIDE the armed fence (utils.faults)
            faults.hang_tick(vals[-1][0] + 1)
            if wd is not None:
                wd.disarm()
            fresh_pieces = False
            bad = next((k for k, v in enumerate(vals)
                        if not all(math.isfinite(x) for x in v[1])), None)
            if bad is not None:
                it_b = vals[bad][0]
                if drv.diverged(it_b + 1, vals[bad][1], note=""):
                    # restore the state of the last good read and replay
                    # the chunk with the backed-off rho
                    (d_local, dual_d, z, dual_z, dbar, udbar,
                     i) = _restore(rec_snap)
                    fresh_pieces = True  # as JAX's rho rebuild
                    continue
                # the state advanced through the diverged step: only the
                # finite prefix enters the trace, and the state stays out
                # of the checkpoint (the newest generation stays the last
                # good read)
                for it, m, ser in vals[:bad]:
                    drv.record(it + 1, m, dt / len(vals), _LINE, ser)
                trace["diverged_at"] = it_b + 1
                console(cfg, "stopping: the streamed state advanced "
                             "through the diverged step — resume from the "
                             "last checkpoint or enable max_recoveries",
                        always=True)
                diverged = True
                break
            for it, m, ser in vals:
                # every flushed step is appended: the state advanced
                # through it in place (a tol hit mid-chunk stops at the
                # chunk's end, as in JAX)
                if drv.record(it + 1, m, dt / len(vals), _LINE, ser):
                    stop = True
            it_done = vals[-1][0] + 1
            if recov.enabled:
                rec_snap = snapshot(it_done)
            if drv.end_pass(vals[0][0], len(vals), len(vals), dt, stop):
                stop = True
            i += 1

    if not diverged:
        drv.finish(it_done)

    # final outputs, one block on the card at a time
    d_proj = learn_mod.f_prox(dbar, udbar, geom, fg)
    dhat_z = learn_mod.f_full_dhat(d_proj, fg)
    Dz = torch.cat([
        learn_mod.f_dz_block(mv.up(z[nn]), dhat_z, geom, fg, data_sp).cpu()
        for nn in range(N)
    ])
    run.close(status="ok", iterations=it_done,
              wall_s=round(trace["tim_vals"][-1], 4))
    return learn_mod.LearnResult(
        learn_mod.extract_filters(d_proj, geom).cpu(),
        torch.stack([x.cpu() for x in z]), Dz, trace,
    )

