"""The consensus learner's driver, single device (torch port of the
per-step branch of ``ccsc_code_iccv2017_tpu.parallel.consensus.learn``).

The per-step math lives in models.learn.outer_step; this module is the
Python outer loop around it with the reference's trace protocol
(obj_vals_d / obj_vals_z / tim_vals / d_diff / z_diff,
dParallel.m:62-71), its rel-change stop (:186-188), the non-finite guard
that keeps the last good state, rho-backoff recovery, graceful
preemption and checkpoint cadence/resume. Each outer step reads its four
metric scalars back in one host sync, as the JAX driver does.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import torch

from ..config import LearnConfig, ProblemGeom
from ..models import common, learn as learn_mod
from ..ops import fourier
from ..utils import checkpoint as ckpt
from ..utils import resilience, validate
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
    the device time of each step's two passes (CUDA events).

    Not ported yet: ``mesh`` (ROADMAP.md Queue 1 item 8c),
    ``profile_dir`` and ``figures_dir`` (item 10), the chunked driver
    (item 9, refused by LearnConfig) and chaos faults.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the sharded learner is not ported yet "
            "(ROADMAP.md Queue 1 item 8c)"
        )
    if profile_dir is not None or figures_dir is not None:
        raise NotImplementedError(
            "profile_dir / figures_dir: profiling and figures are not "
            "ported yet (ROADMAP.md Queue 1 item 10)"
        )
    validate.check_learn_inputs(b, geom, cfg, init_d=init_d)
    dev = resolve_device(device)
    b = validate.as_float32(b, dev)
    ndim_s = geom.ndim_spatial
    n = b.shape[0]
    N = cfg.num_blocks
    ni = n // N
    fg = common.FreqGeom.create(
        geom, b.shape[-ndim_s:], fft_pad=cfg.fft_pad, fft_impl=cfg.fft_impl
    )
    b_blocks = b.reshape(N, ni, *b.shape[1:])

    if initial_state is not None:
        state = learn_mod.LearnState(
            *(t.to(dev).contiguous() for t in initial_state)
        )
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        state = learn_mod.init_state(
            generator, geom, fg, N, ni, torch.float32,
            z_dtype=getattr(torch, cfg.storage_dtype),
            d_dtype=getattr(torch, cfg.d_storage_dtype),
        )
    if init_d is not None:
        d_full = fourier.circ_embed(validate.as_float32(init_d, dev),
                                    fg.spatial_shape)
        state = state._replace(
            # keep the d-state storage dtype
            d_local=d_full.expand(state.d_local.shape).to(
                state.d_local.dtype
            ).contiguous(),
            dbar=d_full,
        )
    d_shape = (geom.num_filters, *geom.reduce_shape, *fg.spatial_shape)
    z_shape = (N, ni, geom.num_filters, *fg.spatial_shape)
    expect = dict(d_local=(N, *d_shape), dual_d=(N, *d_shape),
                  dbar=d_shape, udbar=d_shape, z=z_shape, dual_z=z_shape)
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
            console(cfg, f"resumed from {checkpoint_dir} at iteration "
                          f"{start_it}", always=True)
    got = {f: tuple(getattr(state, f).shape) for f in state._fields}
    if got != expect:
        raise ValueError(f"state shapes {got} do not match problem {expect}")

    if resumed_trace is not None:
        trace = resumed_trace
        trace.setdefault("algorithm", "consensus")
    else:
        obj0 = (
            float(learn_mod.eval_block(
                state, b_blocks, geom, cfg, fg, with_outputs=False
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
    recov = resilience.RecoveryManager(cfg, trace)
    timer = PhaseTimer(dev)
    t_total = trace["tim_vals"][-1]
    it_done = start_it
    saved_it = None  # last iteration committed to the checkpoint dir

    with resilience.GracefulShutdown() as gs:
        i = start_it
        while i < cfg.max_it:
            t0 = time.perf_counter()
            new_state, m = learn_mod.outer_step(
                state, b_blocks, geom, recov.cfg, fg, N, on_phase=timer
            )
            # the one host read of the step (also its device fence)
            obj_d, obj_z, d_diff, z_diff = torch.stack(
                [m.obj_d, m.obj_z, m.d_diff, m.z_diff]
            ).tolist()
            # a non-finite metric means the iterate diverged: keep the
            # last good state (or back off rho and retry from it)
            if not all(
                math.isfinite(v) for v in (obj_d, obj_z, d_diff, z_diff)
            ):
                console(
                    cfg,
                    f"Iter {i + 1}: non-finite metrics (obj_d={obj_d}, "
                    f"obj_z={obj_z}, d_diff={d_diff}, z_diff={z_diff}); "
                    "keeping last good state",
                    always=True,
                )
                del new_state
                ev = recov.on_divergence(i + 1)
                if ev is None:
                    break
                trace.setdefault("recoveries", []).append(ev)
                continue  # retry iteration i with the backed-off rho
            state = new_state
            dt = time.perf_counter() - t0
            t_total += dt
            trace["obj_vals_d"].append(obj_d)
            trace["obj_vals_z"].append(obj_z)
            trace["tim_vals"].append(t_total)
            trace["d_diff"].append(d_diff)
            trace["z_diff"].append(z_diff)
            phases = timer.read()
            if phases is not None:
                trace.setdefault("d_pass_ms", []).append(phases[0])
                trace.setdefault("z_pass_ms", []).append(phases[1])
            console(
                cfg,
                f"Iter {i + 1}, Obj_d {obj_d:.4g}, Obj_z {obj_z:.4g}, "
                f"Diff_d {d_diff:.3g}, Diff_z {z_diff:.3g}, "
                f"t {t_total:.2f}s",
            )
            it_done = i + 1
            preempting = gs.requested and i + 1 < cfg.max_it
            if preempting:
                trace.setdefault("preemptions", []).append(i + 1)
            if checkpoint_dir is not None and (
                (i + 1) % checkpoint_every == 0 or preempting
            ):
                ckpt.save(checkpoint_dir, state, trace, i + 1,
                          fingerprint=fingerprint)
                saved_it = i + 1
            if preempting:
                console(cfg, f"preempted: checkpointed iteration {i + 1}, "
                              "exiting cleanly", always=True)
                break
            if d_diff < cfg.tol and z_diff < cfg.tol:
                break
            i += 1

    if checkpoint_dir is not None and saved_it != it_done:
        ckpt.save(checkpoint_dir, state, trace, it_done,
                  fingerprint=fingerprint)
    _, d_sup, Dz = learn_mod.eval_block(state, b_blocks, geom, cfg, fg)
    Dz = Dz.reshape(n, *Dz.shape[2:])
    return learn_mod.LearnResult(d_sup, state.z, Dz, trace)
