"""The consensus learner, through the port's
``parallel/consensus.py::learn``, on one device: the configuration's
blocks of training images, its inner iterations and rhos, ``fused_z``
(K2 on the card), tol 0 so that every step does the same work.

Set-up warms every shape with a one-step run. The window is one
``learn`` call from the initial state the harness drew from the seed;
a timer asks the learner for its graceful stop (SIGINT, which its
driver turns into a stop at the next step boundary) once ``--seconds``
have passed, so the learner's own loop runs the whole window without a
restart. ``learn_steps_per_s`` is the steps of that call over its wall.

``correct``: the plain reference (portbench/reference/consensus.py,
float64) follows the first ``check.steps`` steps from the same initial
state and images. ``obj_gap`` is the largest relative gap of a step's
objective after its d-pass and after its z-pass; ``diff_gap`` that of
its relative changes of the consensus dictionary and of the codes.
"""
from __future__ import annotations

import os
import signal
import threading
import time

from .. import inputs
from ..record import RunRecord
from ..reference import consensus as ref_consensus
from ..reference import fourier
from . import Check, Outcome

STEPS_UNBOUNDED = 10 ** 9


def _state(d0, z0, blocks, size, z_dtype):
    """The program's initial state from the harness's draw: every block's
    filters the embedded d0, zero duals, the codes z0 stored in the
    configuration's code dtype (expanded views are materialised by the
    learner)."""
    import torch

    from ccsc_code_iccv2017_torch.models.learn import LearnState

    d_full = fourier.embed(d0, (size, size))
    zero_d = torch.zeros((), device=d0.device).expand(blocks, *d_full.shape)
    return LearnState(d_full.expand(blocks, *d_full.shape), zero_d, d_full,
                      torch.zeros_like(d_full), z0.to(z_dtype),
                      torch.zeros((), dtype=z_dtype,
                                  device=z0.device).expand(z0.shape))


def run(ctx) -> Outcome:
    import dataclasses

    import torch

    from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
    from ccsc_code_iccv2017_torch.parallel import consensus

    c = ctx.config
    dev = torch.device(ctx.device)
    L, ni, side = c["blocks"], c["ni"], c["side"]
    K, s = c["num_filters"], c["support"]
    size = side + s - 1
    geom = ProblemGeom((s, s), K)
    if ctx.traffic["driver"] != "learner_window":
        raise ValueError(f"the learner runs a learner window, not "
                         f"{ctx.traffic['driver']!r}")
    lcfg = LearnConfig(num_blocks=L, max_it=ctx.max_steps or STEPS_UNBOUNDED,
                       tol=c["tol"], **c["learn"])
    if ctx.control:
        # the program's own lower-precision path: bf16 code storage
        lcfg = dataclasses.replace(lcfg, storage_dtype="bfloat16")
    b = inputs.training_images(ctx.seed, L * ni, side, dev)
    d0, z0 = inputs.learn_init(ctx.seed, K, s, L, ni, size, dev)
    zdt = getattr(torch, lcfg.storage_dtype)

    # warm every shape the window runs: one step, its objectives and the
    # final evaluation (the kernels build here on a checkout's first run)
    consensus.learn(b, geom, dataclasses.replace(lcfg, max_it=1),
                    initial_state=_state(d0, z0, L, size, zdt), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    stop = None
    if not ctx.max_steps:
        stop = threading.Timer(ctx.seconds, os.kill,
                               (os.getpid(), signal.SIGINT))
    ctx.tracer.start()
    t0 = time.perf_counter()
    if stop is not None:
        stop.start()
    try:
        with ctx.tracer.span("learn_call"):
            res = consensus.learn(b, geom, lcfg,
                                  initial_state=_state(d0, z0, L, size,
                                                       zdt),
                                  device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        if stop is not None:
            stop.cancel()
    wall = time.perf_counter() - t0
    ctx.tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = res.trace
    steps = len(trace["tim_vals"]) - 1
    del res, d0, z0
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    F = size * (size // 2 + 1)
    record = RunRecord(
        cell=ctx.cell, config=c, traffic=ctx.traffic, setup_s=setup_s,
        window_s=wall, steps=steps, learn_trace=trace,
        shapes={"codes": L * ni, "K": K, "S": size, "F": F},
        trace=ctx.tracer.trace,
    )
    checks, complete = _check(ctx, b, trace)
    return Outcome(record, steps, 0, int(peak), checks, complete)


def _check(ctx, b, trace):
    import torch

    c = ctx.config
    lim = c["check"]["limits"]
    n = c["check"]["steps"]
    if len(trace["tim_vals"]) - 1 < n:
        return [Check(k, float("nan"), v) for k, v in lim.items()], False
    L, ni, side = c["blocks"], c["ni"], c["side"]
    K, s = c["num_filters"], c["support"]
    size = side + s - 1
    dt = torch.float64
    d0, z0 = inputs.learn_init(ctx.seed, K, s, L, ni, size, b.device)
    d_full = fourier.embed(d0.to(dt), (size, size))
    del d0
    z0 = z0.to(dt)
    st = ref_consensus.State(
        d_full.expand(L, *d_full.shape).clone(),
        torch.zeros((L, *d_full.shape), dtype=dt, device=b.device),
        d_full, torch.zeros_like(d_full), z0, torch.zeros_like(z0))
    del z0
    bb = b.to(dt).reshape(L, ni, side, side)
    obj_gap = diff_gap = 0.0
    for i in range(1, n + 1):
        st, m = ref_consensus.outer_step(st, bb, c["learn"])
        for key, ref in (("obj_vals_d", m["obj_d"]),
                         ("obj_vals_z", m["obj_z"])):
            obj_gap = max(obj_gap, abs(trace[key][i] - ref) / abs(ref))
        for key, ref in (("d_diff", m["d_diff"]), ("z_diff", m["z_diff"])):
            diff_gap = max(diff_gap, abs(trace[key][i] - ref) / abs(ref))
    return [Check("obj_gap", obj_gap, lim["obj_gap"]),
            Check("diff_gap", diff_gap, lim["diff_gap"])], True
