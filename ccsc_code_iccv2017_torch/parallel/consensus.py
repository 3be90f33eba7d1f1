"""The consensus learner's driver on one device or on a mesh (torch
port of the per-step branch of
``ccsc_code_iccv2017_tpu.parallel.consensus.learn``).

The per-step math lives in models.learn.outer_step; this module is the
Python outer loop around it with the reference's trace protocol
(obj_vals_d / obj_vals_z / tim_vals / d_diff / z_diff,
dParallel.m:62-71), its rel-change stop (:186-188), the non-finite guard
that keeps the last good state, rho-backoff recovery, graceful
preemption and checkpoint cadence/resume. Each outer step reads its four
metric scalars back in one host sync, as the JAX driver does; with
``cfg.outer_chunk > 1`` (or ``cfg.donate_state``) the chunked driver
runs chunks of steps (models.learn.outer_chunk_scan) and reads a chunk's
stacked trace in one host sync, keeping the per-step contract (the
non-finite guard, the tol stop, recovery, preemption, checkpoints,
telemetry records) at chunk granularity.

The robustness hooks are the JAX driver's: with ``cfg.watchdog`` a
utils.watchdog.DispatchWatchdog is armed around each step's one host
read (its deadline the perfmodel roofline bound of the step times
``cfg.watchdog_slack``; on a mesh every rank arms its own), and the
chaos faults of utils.faults fire at the same points (the NaN poison
inside the step, the hang inside the armed fence, SIGTERM at the
boundary). With every hook off they add no launch and no host read.

With ``cfg.metrics_dir`` the run writes its telemetry stream (utils.obs):
run metadata, one ``step`` record per adopted step with the ObsExtras
fields, its ``roofline`` (the analytic utils.perfmodel cost) and
``heartbeat``, ``recovery`` / ``preemption`` / checkpoint records, the
section timers and a closing ``summary``. The extras leave the card in
the step's one host read, and every record is written after it, so the
stream adds no read and no launch, and the trajectory is the one without
it. On a mesh every rank writes its own ``events-pNNNNN.jsonl``.

On a mesh (parallel.mesh) every rank runs this loop on its shard: the
block-local fields hold its L = N / nb blocks (and its K / nk filters
under 'filter'), dbar/udbar are replicated. Every host-side decision
(the stop test, the non-finite guard and its backoff, a shutdown
request) reads values agreed by one collective per step, so no rank can
leave the others waiting inside a collective.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from ..config import LearnConfig, ProblemGeom
from ..models import common, learn as learn_mod
from ..ops import fourier
from . import mesh as mesh_lib
from .distributed import GlobalBlockArray
from ..utils import checkpoint as ckpt
from ..utils import faults, obs, perfmodel, profiling, resilience, validate
from ..utils import watchdog
from ..utils.resilience import console
from ..utils.device import PhaseTimer, resolve_device


def learn(
    b,
    geom: ProblemGeom,
    cfg: LearnConfig,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    init_d=None,
    profile_dir: Optional[str] = None,
    figures_dir: Optional[str] = None,
    device="cuda",
    initial_state: Optional[learn_mod.LearnState] = None,
) -> learn_mod.LearnResult:
    """Learn a filter bank from data b [n, *reduce, *data_spatial] (numpy
    or tensor) on ``device`` (default ``"cuda"``; raises when CUDA is
    absent). n is split into ``cfg.num_blocks`` consensus blocks of
    n / num_blocks images.

    ``generator``: the torch.Generator the random init draws from (on
    ``device``); None seeds one with 0. ``init_d`` [k, *reduce,
    *support] warm-starts the dictionary (every block's local copy and
    the consensus average). ``checkpoint_dir`` enables atomic snapshots
    every ``checkpoint_every`` outer iterations and resume-on-restart
    (utils.checkpoint; a JAX checkpoint of the same problem resumes
    too). With ``cfg.max_recoveries > 0`` a non-finite step keeps the
    last good state, backs off rho by ``cfg.rho_backoff`` and retries.
    SIGTERM/SIGINT checkpoint and exit at the next step boundary.

    ``initial_state``: a models.learn.LearnState to start from instead
    of the random init — the seam the parity tests use to hand the JAX
    package's ``init_state`` (torch and jax random streams differ) to
    the port through ``convert.learn_state_from_jax``. ``init_d`` still
    applies on top of it.

    On the card the trace also carries ``d_pass_ms`` / ``z_pass_ms``,
    the device time of each step's two passes (CUDA events), and
    ``gram_ms`` (the d-pass's code Grams and their inverses),
    ``gram_inv_ms`` (the inverses alone) and
    ``step_rest_ms`` (the step outside both passes: the data FFT, the
    objectives, the change sums, the metrics' stack).

    ``mesh``: a parallel.mesh.Mesh with a 'block' axis and at most one
    of 'freq' / 'filter' (block_mesh, block_freq_mesh,
    block_filter_mesh), called on every rank with the same arguments.
    The run happens on ``mesh.device`` (``device`` must name its type).
    Every rank draws the global init from ``generator`` (or takes the
    global ``initial_state`` / checkpoint) and keeps its shard, so a
    mesh run from seed s equals the one-device run from seed s to within
    reduction order. On a mesh ``b`` may instead be this rank's blocks,
    a parallel.distributed.GlobalBlockArray (global_block_array), so no
    rank holds the whole data; ``initial_state`` may then be this
    rank's shard alone (d_local, dual_d [L_local, ...], z, dual_z
    [L_local, ni, ...], under 'filter' each its K / nk filters; dbar,
    udbar replicated), taken as it is, so no rank holds a global-sized
    state either (a checkpoint still holds the global one). ``d`` and
    the trace come back replicated; ``z`` and
    ``Dz`` hold this rank's blocks (parallel.mesh.gather_blocks
    assembles them). Checkpoints: rank 0 writes the gathered global
    state in the one-device format. On a mesh the per-step trace also
    carries ``wire_bytes`` (the bytes the step handed to collectives,
    ``Mesh.wire_bytes``) and, on the card, ``allreduce_ms`` (the step's
    summed device time inside its collectives, the wait on peers
    included: CUDA events read after the step's one host read).

    ``profile_dir`` captures a ``torch.profiler`` trace of the step loop
    (utils.profiling.xla_trace; each step is the span ``ccsc.learn.step``
    with its first iteration as the argument),
    kernels on the card included. ``verbose='all'`` writes per-iteration
    figures (the filter mosaic and original-vs-iterate panels, PNG) into
    ``figures_dir`` (default ``ccsc_figures``); on a mesh rank 0 writes
    them. ``cfg.metrics_dir``: the telemetry stream (module docstring).

    ``cfg.watchdog`` arms the dispatch-fence watchdog (module
    docstring); ``CCSC_FAULT_*`` arm the chaos faults (utils.faults).

    ``cfg.outer_chunk > 1`` (or ``cfg.donate_state``) runs the chunked
    driver: chunks of steps with one host read a chunk, bitwise the
    per-step run on the same inputs (models.learn.outer_chunk_scan).
    ``cfg.tune`` is not read here: the learner apps resolve it.
    """
    N = cfg.num_blocks
    ndim_s = geom.ndim_spatial
    if isinstance(b, GlobalBlockArray):
        # this rank's blocks only: the whole data is on no rank
        if mesh is None or b.global_shape[0] != N:
            raise ValueError(
                f"a GlobalBlockArray of {b.global_shape[0]} blocks needs "
                f"its mesh and num_blocks={N}"
            )
        L, ni = b.local.shape[0], b.local.shape[1]
        validate.check_learn_inputs(
            b.local.reshape(L * ni, *b.local.shape[2:]), geom,
            dataclasses.replace(cfg, num_blocks=L), init_d=init_d,
        )
    else:
        validate.check_learn_inputs(b, geom, cfg, init_d=init_d)
        ni = b.shape[0] // N
    fg = common.FreqGeom.create(
        geom, b.local.shape[-ndim_s:] if isinstance(b, GlobalBlockArray)
        else b.shape[-ndim_s:], fft_pad=cfg.fft_pad, fft_impl=cfg.fft_impl,
    )
    dev = (resolve_device(device) if mesh is None
           else _check_mesh(mesh, device, geom, fg, N))
    if isinstance(b, GlobalBlockArray):
        b_blocks = validate.as_float32(b.local, dev)
    else:
        b = validate.as_float32(b, dev)
        b_blocks = mesh_lib.fslice(b.reshape(N, ni, *b.shape[1:]), mesh,
                                   "block" if mesh is not None else None,
                                   dim=0)
    data_shape = [N * ni, *b_blocks.shape[2:]]

    run = obs.start_run(
        cfg.metrics_dir, algorithm="consensus", verbose=cfg.verbose,
        geom=geom, cfg=cfg,
        fingerprint=resilience.config_fingerprint(geom, cfg, "consensus"),
        mesh=mesh, device=dev, data_shape=data_shape,
    )
    wd = None
    try:
        step_cost = None
        if run.active or cfg.watchdog:
            # the analytic cost of one outer step of THIS problem: each
            # step's achieved rate is scored against it (roofline), and
            # the watchdog derives its fence deadline from its bound
            step_cost = perfmodel.analytic_outer_step_cost(
                num_blocks=N, ni=ni, k=geom.num_filters,
                spatial=fg.spatial_shape, num_freq=fg.num_freq,
                max_it_d=cfg.max_it_d, max_it_z=cfg.max_it_z,
                reduce_size=geom.reduce_size,
                state_dtype_bytes=getattr(torch, cfg.storage_dtype).itemsize,
                d_state_dtype_bytes=getattr(
                    torch, cfg.d_storage_dtype).itemsize,
                fft_impl=cfg.fft_impl,
                fused_z=learn_mod.fused_z_ok(cfg, fg, mesh, dev),
                donate_state=cfg.donate_state,
            )
            if run.memwatch is not None:
                est, _budget = perfmodel.inmem_learn_estimate(
                    data_shape, geom, cfg, device=dev)
                run.modeled_hbm_bytes = int(est)
        # hang/stall watchdog: armed around every step's fence below
        wd = watchdog.maybe_start(cfg, cost=step_cost,
                                  algorithm="consensus", device=dev)
        return _learn_impl(
            b_blocks, geom, cfg, generator, mesh, checkpoint_dir,
            checkpoint_every, init_d, profile_dir, figures_dir, dev,
            initial_state, fg, N, ni, run, step_cost, wd,
        )
    finally:
        if wd is not None:
            wd.stop()
        # idempotent: the normal path closed with status='ok' already
        run.close(status="error")


def _learn_impl(
    b_blocks, geom, cfg, generator, mesh, checkpoint_dir, checkpoint_every,
    init_d, profile_dir, figures_dir, dev, initial_state, fg, N, ni, run,
    step_cost, wd=None,
):
    timers = profiling.SectionTimers()
    t_setup0 = time.perf_counter()
    if initial_state is not None:
        # a donated state is written in place: never the caller's tensors
        own = (lambda t: t.to(dev).clone()) if cfg.donate_state else \
            (lambda t: t.to(dev).contiguous())
        state = learn_mod.LearnState(*(own(t) for t in initial_state))
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        state = learn_mod.init_state(
            generator, geom, fg, N, ni, torch.float32,
            z_dtype=getattr(torch, cfg.storage_dtype),
            d_dtype=getattr(torch, cfg.d_storage_dtype),
        )
    d_shape = (geom.num_filters, *geom.reduce_shape, *fg.spatial_shape)
    z_shape = (N, ni, geom.num_filters, *fg.spatial_shape)
    expect = dict(d_local=(N, *d_shape), dual_d=(N, *d_shape),
                  dbar=d_shape, udbar=d_shape, z=z_shape, dual_z=z_shape)
    local = (mesh is not None and initial_state is not None
             and _shapes(state) == _local_shapes(expect, mesh)
             and _shapes(state) != expect)
    if init_d is not None:
        d_full = fourier.circ_embed(validate.as_float32(init_d, dev),
                                    fg.spatial_shape)
        if local:
            d_full = mesh_lib.fslice(
                d_full, mesh, "filter" if "filter" in mesh.shape else None,
                dim=0)
        state = state._replace(
            # keep the d-state storage dtype
            d_local=d_full.expand(state.d_local.shape).to(
                state.d_local.dtype
            ).contiguous(),
            dbar=d_full,
        )
    start_it = 0
    resumed_trace = None
    fingerprint = resilience.config_fingerprint(geom, cfg, "consensus")
    if checkpoint_dir is not None:
        snap = ckpt.load(checkpoint_dir, expect_fingerprint=fingerprint)
        if snap is not None:
            fields, resumed_trace, start_it = snap
            got = {k: tuple(v.shape) for k, v in fields.items()}
            if expect != got:
                raise ValueError(
                    f"checkpoint shapes {got} do not match problem {expect}"
                )
            state = learn_mod.LearnState(
                **{k: v.to(dev) for k, v in fields.items()}
            )
            local = False
            console(cfg, f"resumed from {checkpoint_dir} at iteration "
                          f"{start_it}", always=True)
    if not local:
        got = _shapes(state)
        if got != expect:
            raise ValueError(f"state shapes {got} do not match problem "
                             f"{expect}" + (
                                 "" if mesh is None else " (or this rank's "
                                 f"shard {_local_shapes(expect, mesh)})"))
        if mesh is not None:
            state = _shard_state(state, mesh)

    if resumed_trace is not None:
        trace = resumed_trace
        trace.setdefault("algorithm", "consensus")
    else:
        obj0 = (
            float(learn_mod.eval_block(
                state, b_blocks, geom, cfg, fg, with_outputs=False,
                mesh=mesh,
            )[0])
            if cfg.with_objective
            else 0.0
        )
        trace = {
            "algorithm": "consensus",
            "obj_vals_d": [obj0],
            "obj_vals_z": [obj0],
            "tim_vals": [0.0],
            "d_diff": [0.0],
            "z_diff": [0.0],
        }
    note = learn_mod.fused_z_note(cfg, fg, mesh, dev)
    if note is not None:
        console(cfg, note)
    recov = resilience.RecoveryManager(cfg, trace)
    t_total = trace["tim_vals"][-1]
    timers.add("setup", time.perf_counter() - t_setup0)

    state, t_total, it_done, saved_it = _run_outer(
        state, b_blocks, geom, cfg, fg, N, mesh, dev, recov, trace, run,
        timers, wd, profile_dir, figures_dir, checkpoint_dir,
        checkpoint_every, fingerprint, start_it, t_total, step_cost,
    )

    if checkpoint_dir is not None and saved_it != it_done:
        with timers.section("checkpoint"):
            _save(checkpoint_dir, state, trace, it_done, fingerprint, mesh)
    with timers.section("final_eval"):
        _, d_sup, Dz = learn_mod.eval_block(state, b_blocks, geom, cfg, fg,
                                            mesh=mesh)
        Dz = Dz.reshape(-1, *Dz.shape[2:])
    run.drain_timers(timers)
    run.close(status="ok", iterations=it_done, wall_s=round(t_total, 4))
    return learn_mod.LearnResult(d_sup, state.z, Dz, trace)


def _run_outer(state, b_blocks, geom, cfg, fg, N, mesh, dev, recov, trace,
               run, timers, wd, profile_dir, figures_dir, checkpoint_dir,
               checkpoint_every, fingerprint, start_it, t_total, step_cost):
    """The outer loop (JAX parallel/consensus.py:560-740). Each pass runs
    one step (``learn_mod.outer_step``) or, with ``cfg.chunked_driver``,
    a chunk of ``cfg.outer_chunk`` steps (``learn_mod.outer_chunk_scan``,
    which carries the non-finite rollback and the tol stop on the
    device), then makes ONE host read (on a mesh one ``agree``, so every
    rank decides alike). A step is adopted on the host after its read; a
    chunk returns its adopted state. Trace entries stay per step (a
    chunk's wall time split evenly over its adopted steps, a step's
    d-pass and z-pass device times read by its PhaseTimer, on a mesh
    its collectives' bytes and device time); the watchdog, telemetry
    records, figures, checkpoints and preemption work a pass at a
    time. With ``cfg.donate_state`` the state is
    consumed by each chunk and rebound to its output. Returns (state,
    t_total, it_done, saved_it)."""
    chunked = cfg.chunked_driver
    timer = None if chunked else PhaseTimer(dev)
    it_done = start_it
    saved_it = None  # last iteration committed to the checkpoint dir
    with resilience.GracefulShutdown() as gs, \
            profiling.xla_trace(profile_dir, dev):
        i = start_it
        stop = False
        fresh_step = True  # the first fence builds the kernels
        while i < cfg.max_it and not stop:
            clen = min(cfg.outer_chunk, cfg.max_it - i) if chunked else 1
            na = faults.nan_iteration()
            poisoned = na is not None and i + 1 <= na <= i + clen
            tag = f"ccsc_outer_{i}_{i + clen}" if chunked else \
                f"ccsc_outer_{i}"
            if mesh is not None and not chunked:
                # the step's collectives: bytes counted, device time
                # recorded (CUDA events, read after the step's host read)
                wire0 = sum(mesh.wire_bytes.values())
                mesh.record_step()
            t0 = time.perf_counter()
            if wd is not None:
                wd.arm(clen, tag, may_compile=fresh_step or poisoned)
            with profiling.annotate("ccsc.learn.step", str(i)):
                # chaos injection (utils.faults): the step NaNs its
                # iterate on the card
                if chunked:
                    new_state, tr = learn_mod.outer_chunk_scan(
                        state, b_blocks, geom, recov.cfg, fg, N, clen,
                        mesh=mesh,
                        poison_at=na - (i + 1) if poisoned else None,
                        donate=cfg.donate_state,
                    )
                    m, flags = tr.metrics, [tr.active, tr.adopted]
                else:
                    new_state, m = learn_mod.outer_step(
                        state, b_blocks, geom, recov.cfg, fg, N,
                        on_phase=timer, mesh=mesh,
                        poison=(torch.ones((), dtype=torch.bool, device=dev)
                                if poisoned else None),
                    )
                    flags = []
                if poisoned:
                    faults.consume_nan()
                rows = [m.obj_d, m.obj_z, m.d_diff, m.z_diff, *(m.extras or ())]
                packed = torch.cat([torch.stack(rows).reshape(-1),
                                    *(f.to(torch.float32) for f in flags)])
                if timer is not None:
                    timer("step_end")
                # the one host read of the pass (also its device fence),
                # the telemetry scalars in it; on a mesh every rank reads
                # rank 0's metrics and any rank's shutdown request
                with profiling.annotate("ccsc.learn.read"):
                    flat, stop_req = mesh_lib.agree(packed, gs.requested,
                                                    mesh)
            coll = None
            if mesh is not None and not chunked:
                coll = (mesh.step_ms(),
                        sum(mesh.wire_bytes.values()) - wire0)
            # injected hang fires INSIDE the armed fence (utils.faults)
            faults.hang_tick(i + clen)
            if wd is not None:
                wd.disarm()
            fresh_step = False
            nrow = len(rows)
            cols = [flat[r * clen:(r + 1) * clen] for r in range(nrow)]
            if chunked:
                active = flat[nrow * clen:(nrow + 1) * clen]
                adopted = flat[(nrow + 1) * clen:]
                state = new_state
            else:
                # a non-finite metric means the iterate diverged: keep
                # the last good state (or back off rho and retry from it)
                active = [True]
                adopted = [all(math.isfinite(c[0]) for c in cols[:4])]
                if adopted[0]:
                    state = new_state
            del new_state
            dt = time.perf_counter() - t0
            timers.add("step", dt)
            n_adopted = 0
            for j in range(clen):
                if not active[j]:
                    break  # the tail after the chunk stopped
                vals = [c[j] for c in cols]
                obj_d, obj_z, d_diff, z_diff = vals[:4]
                if not adopted[j]:
                    console(
                        cfg,
                        f"Iter {i + j + 1}: non-finite metrics "
                        f"(obj_d={obj_d}, obj_z={obj_z}, d_diff={d_diff}, "
                        f"z_diff={z_diff}); keeping last good state",
                        always=True,
                    )
                    # the pass kept the last good iterate: only rho backs
                    # off, and the next pass retries from there
                    ev = recov.on_divergence(i + j + 1)
                    if ev is None:
                        stop = True
                    else:
                        trace.setdefault("recoveries", []).append(ev)
                        run.event("recovery", **ev)
                        fresh_step = True  # as JAX's rho rebuild
                    break
                n_adopted += 1
                t_total += dt / clen
                trace["obj_vals_d"].append(obj_d)
                trace["obj_vals_z"].append(obj_z)
                trace["tim_vals"].append(t_total)
                trace["d_diff"].append(d_diff)
                trace["z_diff"].append(z_diff)
                phases = timer.read() if timer is not None else None
                if phases is not None:
                    d_ms, z_ms, gram_ms, step_ms, inv_ms = phases
                    trace.setdefault("d_pass_ms", []).append(d_ms)
                    trace.setdefault("z_pass_ms", []).append(z_ms)
                    trace.setdefault("gram_ms", []).append(gram_ms)
                    trace.setdefault("gram_inv_ms", []).append(inv_ms)
                    trace.setdefault("step_rest_ms", []).append(
                        step_ms - d_ms - z_ms)
                if coll is not None:
                    if coll[0] is not None:
                        trace.setdefault("allreduce_ms", []).append(coll[0])
                    trace.setdefault("wire_bytes", []).append(coll[1])
                run.step(
                    it=i + j + 1, obj_d=obj_d, obj_z=obj_z, d_diff=d_diff,
                    z_diff=z_diff, t_total=round(t_total, 4),
                    **_extras_fields(vals[4:]),
                )
                console(
                    cfg,
                    f"Iter {i + j + 1}, Obj_d {obj_d:.4g}, Obj_z "
                    f"{obj_z:.4g}, Diff_d {d_diff:.3g}, Diff_z "
                    f"{z_diff:.3g}, t {t_total:.2f}s",
                )
                if d_diff < cfg.tol and z_diff < cfg.tol:
                    stop = True
                    break
            it_end = i + n_adopted
            it_done = it_end
            if n_adopted:
                run.chunk(i, clen, n_adopted, dt, cost=step_cost)
                run.heartbeat(it_end, dt)
                if cfg.verbose == "all":
                    # one panel a pass
                    _write_figures(figures_dir or "ccsc_figures", it_end,
                                   state, b_blocks, geom, cfg, fg, mesh)
                faults.sigterm_tick(it_end)
            # one device: a request raised after the pass's read (the
            # SIGTERM fault) counts now, as in JAX; on a mesh the next
            # pass's agreed read carries it, so every rank decides alike
            preempting = ((stop_req or (mesh is None and gs.requested))
                          and not stop and it_end < cfg.max_it)
            if preempting:
                trace.setdefault("preemptions", []).append(it_end)
                run.event("preemption", iteration=it_end, signum=gs.signum)
            crossed = (n_adopted and it_end // checkpoint_every
                       > i // checkpoint_every)
            if checkpoint_dir is not None and (
                (crossed and saved_it != it_end) or preempting
            ):
                with timers.section("checkpoint"):
                    _save(checkpoint_dir, state, trace, it_end, fingerprint,
                          mesh)
                saved_it = it_end
                run.drain_timers(timers)
            if preempting:
                console(cfg, f"preempted: checkpointed iteration {it_end}, "
                             "exiting cleanly", always=True)
                stop = True
            i = it_end
    return state, t_total, it_done, saved_it


def _extras_fields(vals) -> dict:
    """The ObsExtras values of a step's host read (in field order) as
    step-record fields; none without telemetry."""
    if not vals:
        return {}
    fid, l1, dis, nonf = vals
    return {"obj_fid": fid, "obj_l1": l1, "consensus_dis": dis,
            "nonfinite_z": int(nonf)}


def _write_figures(figdir, it, state, b_blocks, geom, cfg, fg, mesh=None):
    """The iteration's filter mosaic and original-vs-iterate panels
    (display_func, dParallel.m:326-369) as ``filters_NNN.png`` and
    ``iterates_NNN.png``. Every rank of a mesh evaluates; rank 0
    writes."""
    import os

    from ..utils import display

    _, d_sup, Dz = learn_mod.eval_block(state, b_blocks, geom, cfg, fg,
                                        mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return
    os.makedirs(figdir, exist_ok=True)
    display.save_filter_mosaic(
        os.path.join(figdir, f"filters_{it:03d}.png"),
        d_sup.cpu().numpy(), title=f"iter {it}",
    )
    flat_Dz = Dz.reshape(-1, *Dz.shape[2:]).cpu().numpy()
    flat_b = b_blocks.reshape(-1, *b_blocks.shape[2:]).cpu().numpy()
    display.save_iterate_panel(
        os.path.join(figdir, f"iterates_{it:03d}.png"),
        list(flat_b[:3]), list(flat_Dz[:3]), title=f"iter {it}",
    )


def _check_mesh(mesh, device, geom, fg, num_blocks) -> torch.device:
    """Refuse a mesh the consensus learner cannot run (the JAX package's
    checks) and return the device this rank runs on."""
    if torch.device(device).type != mesh.device.type:
        raise ValueError(
            f"device={str(device)!r} but this rank's mesh runs on "
            f"{mesh.device}"
        )
    unknown = set(mesh.axis_names) - {"block", "freq", "filter"}
    if "block" not in mesh.shape or unknown:
        raise ValueError(
            "the consensus learner's mesh has a 'block' axis and at most "
            f"one of 'freq' / 'filter', got {mesh.axis_names}"
        )
    if "freq" in mesh.shape and "filter" in mesh.shape:
        raise ValueError(
            "freq and filter tensor parallelism cannot be combined"
        )
    nb = mesh.shape["block"]
    if num_blocks % nb:
        raise ValueError(
            f"num_blocks={num_blocks} not divisible by mesh 'block' axis {nb}"
        )
    nk = mesh.shape.get("filter", 1)
    if geom.num_filters % nk:
        raise ValueError(
            f"num_filters={geom.num_filters} not divisible by mesh "
            f"'filter' axis {nk}"
        )
    nf = mesh.shape.get("freq", 1)
    if fg.num_freq % nf:
        raise ValueError(
            f"num_freq={fg.num_freq} not divisible by num_freq_shards={nf}"
        )
    return mesh.device


def _shapes(state: learn_mod.LearnState) -> dict:
    return {f: tuple(getattr(state, f).shape) for f in state._fields}


def _local_shapes(expect: dict, mesh) -> dict:
    """A rank's shard of the global state shapes ``expect``: the block
    axis of the block-local fields over 'block', the k axis of every
    field over 'filter' (as :func:`_shard_state` cuts them)."""
    nb = mesh.shape["block"]
    nk = mesh.shape.get("filter", 1)
    out = {}
    for f, shp in expect.items():
        shp = list(shp)
        kdim = 0
        if f in ("d_local", "dual_d", "z", "dual_z"):
            shp[0] //= nb
            kdim = 1 if f in ("d_local", "dual_d") else 2
        shp[kdim] //= nk
        out[f] = tuple(shp)
    return out


def _shard_state(state: learn_mod.LearnState, mesh) -> learn_mod.LearnState:
    """This rank's shard of a global state: its blocks of the block-local
    fields and, under 'filter', its slice of every field's k axis (axis 1
    of the d fields, 2 of the codes, 0 of dbar/udbar)."""
    k_ax = "filter" if "filter" in mesh.shape else None

    def shard(x, kdim, blocked=True):
        if blocked:
            x = mesh_lib.fslice(x, mesh, "block", dim=0)
        return mesh_lib.fslice(x, mesh, k_ax, dim=kdim).contiguous()

    out = learn_mod.LearnState(
        d_local=shard(state.d_local, 1), dual_d=shard(state.dual_d, 1),
        dbar=shard(state.dbar, 0, False), udbar=shard(state.udbar, 0, False),
        z=shard(state.z, 2), dual_z=shard(state.dual_z, 2),
    )
    del state
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()  # the global init is no longer held
    return out


def _gather_state(state: learn_mod.LearnState, mesh):
    """The global LearnState of a sharded one, on rank 0 (None on the
    others); every rank must call it."""
    filt = "filter" in mesh.shape
    kdim = {"d_local": 1, "dual_d": 1, "z": 2, "dual_z": 2}
    fields = {}
    for f in state._fields:
        x = getattr(state, f)
        if f in kdim:
            spec = {"block": 0, **({"filter": kdim[f]} if filt else {})}
        else:
            spec = {"filter": 0} if filt else {}
        full = mesh_lib.gather(x.to(torch.float32), mesh, spec)
        # back to the storage dtype (a bf16 -> f32 -> bf16 round trip is
        # exact), so the file is the one-device format
        fields[f] = None if full is None else full.to(x.dtype)
    return learn_mod.LearnState(**fields) if mesh.rank == 0 else None


def _save(checkpoint_dir, state, trace, it, fingerprint, mesh) -> None:
    """One checkpoint: on a mesh, rank 0 writes the gathered global state
    and every rank waits for it."""
    if mesh is None:
        ckpt.save(checkpoint_dir, state, trace, it, fingerprint=fingerprint)
        return
    full = _gather_state(state, mesh)
    if full is not None:
        ckpt.save(checkpoint_dir, full, trace, it, fingerprint=fingerprint)
    mesh_lib.barrier(mesh)
