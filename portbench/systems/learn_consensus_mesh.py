"""The consensus learner on a mesh, through the port's normal mesh path:
``parallel.distributed.launch`` starts the configuration's ``ranks``
processes (NCCL, one card each, on ``cuda``; gloo on the CPU), each
builds ``block_mesh(ranks)`` and calls ``parallel/consensus.py::learn``
with its own blocks of images as a ``GlobalBlockArray`` and its own
blocks' initial state alone: no rank holds the whole data or a
global-sized state. Every rank runs the one-card learner's step
(``learn_consensus``) on ``blocks / ranks`` blocks; the consensus
averages are one all-reduce a d-iteration.

The initial state is drawn block by block from the seed (a generator a
block, so a rank draws its blocks alone, whatever the number of ranks):
the filters as ``inputs.learn_init`` draws them, every block's codes
from its own generator. The images are ``inputs.training_images`` of
the whole set, of which each rank keeps its blocks.

Set-up (from process start: the spawn, the process group, the kernels
and a one-step call on every rank) ends at a barrier. The window is one
``learn`` call on every rank; at ``--seconds`` rank 0 sends itself
SIGINT, which its outer loop turns into a stop request that the step's
``agree`` carries to every rank, so all stop at the same step.
``learn_steps_per_s`` is rank 0's steps over its call's wall;
``memory_peak_bytes`` the largest rank's peak. With ``--trace 1`` rank 0
profiles its call, and its parsed trace is the run's.

``correct``: on every rank, after the program's state is freed, the
sharded float64 reference (``reference/consensus_sharded.py``, its sums
all-reduced over the same process group) follows the window's first
``check.steps`` steps from the same start; ``obj_gap`` and ``diff_gap``
as ``learn_consensus`` computes them.

A failing rank fails the run: ``launch`` kills every rank and raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time

from .. import inputs
from ..record import RunRecord
from ..reference import consensus as ref_consensus
from ..reference import consensus_sharded, fourier
from . import Check, Outcome
from .learn_consensus import STEPS_UNBOUNDED, _state

# the process group's collective timeout (s): longer than any wait of a
# rank on its peers (a first run's kernel builds)
GROUP_TIMEOUT_S = 600.0
# how long a run may take past its window before every rank is killed:
# set-up, the reference's steps and the teardown
DEADLINE_PAST_WINDOW_S = 1500.0
# tests only: a module-level function every rank calls with its rank
# before anything else (a fault seam); it must pickle
RANK_HOOK = None


def _block_generator(seed: int, block: int, device):
    import torch

    return torch.Generator(device=device).manual_seed(
        ((int(seed) * 8 + 4) * 65536 + block) % (2 ** 63))


def rank_init(seed: int, k: int, s: int, blocks: range, ni: int, size: int,
              device, dtype=None):
    """The initial filters [k, s, s] float32 (``inputs.learn_init``'s
    draw) and the codes of ``blocks`` [len(blocks), ni, k, size, size]
    in ``dtype`` (float32 by default), each block drawn in float32 from
    its own generator."""
    import torch

    d0 = torch.randn((k, s, s), generator=inputs.generator(
        seed, inputs._INIT, device), device=device)
    z0 = torch.empty((len(blocks), ni, k, size, size), device=device,
                     dtype=dtype or torch.float32)
    one = torch.empty((ni, k, size, size), device=device)
    for j, g in enumerate(blocks):
        z0[j] = one.normal_(generator=_block_generator(seed, g, device))
    return d0, z0


def _rank(rank: int, p: dict) -> dict:
    import torch

    from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
    from ccsc_code_iccv2017_torch.parallel import consensus, distributed
    from ccsc_code_iccv2017_torch.parallel import mesh as mesh_lib

    from ..trace import Tracer

    if p["hook"] is not None:
        p["hook"](rank)
    c = p["config"]
    mesh = mesh_lib.block_mesh(c["ranks"])
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    L, ni, side = c["blocks"], c["ni"], c["side"]
    K, s = c["num_filters"], c["support"]
    size = side + s - 1
    geom = ProblemGeom((s, s), K)
    lcfg = LearnConfig(num_blocks=L, max_it=p["max_steps"] or STEPS_UNBOUNDED,
                       tol=c["tol"], **c["learn"])
    if p["control"]:
        # the program's own lower-precision path: bf16 code storage
        lcfg = dataclasses.replace(lcfg, storage_dtype="bfloat16")
    zdt = getattr(torch, lcfg.storage_dtype)
    mine = distributed.process_block_slice(L, mesh)
    blocks = range(mine.start, mine.stop)
    Lr = len(blocks)
    b_local = inputs.training_images(p["seed"], L * ni, side, dev)[
        mine.start * ni:mine.stop * ni].reshape(Lr, ni, side, side)
    b = distributed.global_block_array(b_local, mesh)
    d0, z0 = rank_init(p["seed"], K, s, blocks, ni, size, dev, zdt)
    tracer = Tracer(p["trace"] and rank == 0)
    tracer.prepare()

    def call(cfg):
        return consensus.learn(b, geom, cfg, mesh=mesh, device=dev.type,
                               initial_state=_state(d0, z0, Lr, size, zdt))

    # warm every shape the window runs (the kernels build here on a
    # checkout's first run, the collectives' communicators start)
    call(dataclasses.replace(lcfg, max_it=1))
    if cuda:
        torch.cuda.synchronize(dev)
    mesh_lib.barrier(mesh)
    if cuda:
        torch.cuda.synchronize(dev)
    t_ready = time.perf_counter()

    stop = None
    if rank == 0 and not p["max_steps"]:
        stop = threading.Timer(p["seconds"], os.kill,
                               (os.getpid(), signal.SIGINT))
    tracer.start()
    t0 = time.perf_counter()
    if stop is not None:
        stop.start()
    try:
        with tracer.span("learn_call"):
            res = call(lcfg)
            if cuda:
                torch.cuda.synchronize(dev)
    finally:
        if stop is not None:
            stop.cancel()
    wall = time.perf_counter() - t0
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = res.trace
    del res, z0
    if cuda:
        torch.cuda.empty_cache()
    checks, complete = _check(p, b_local, trace, blocks, dev)
    return dict(rank=rank, t_ready=t_ready, wall=wall, peak=peak,
                steps=len(trace["tim_vals"]) - 1,
                trace=trace if rank == 0 else {
                    k: trace[k] for k in ("d_pass_ms", "z_pass_ms")
                    if k in trace},
                profile=tracer.trace, checks=checks, complete=complete)


def _check(p, b_local, trace, blocks, dev):
    """(checks as (name, value, limit), complete) against the sharded
    float64 reference; every rank runs it (its sums are collectives)."""
    import torch

    c = p["config"]
    lim = c["check"]["limits"]
    n = c["check"]["steps"]
    if len(trace["tim_vals"]) - 1 < n:
        return [(k, float("nan"), v) for k, v in lim.items()], False
    K, s, ni = c["num_filters"], c["support"], c["ni"]
    size = c["side"] + s - 1
    dt = torch.float64
    d0, z0 = rank_init(p["seed"], K, s, blocks, ni, size, dev, dt)
    d_full = fourier.embed(d0.to(dt), (size, size))
    Lr = len(blocks)
    st = ref_consensus.State(
        d_full.expand(Lr, *d_full.shape).clone(),
        torch.zeros((Lr, *d_full.shape), dtype=dt, device=dev),
        d_full, torch.zeros_like(d_full), z0, torch.zeros_like(z0))
    del z0
    bb = b_local.to(dt)
    obj_gap = diff_gap = 0.0
    for i in range(1, n + 1):
        st, m = consensus_sharded.outer_step(st, bb, c["learn"], c["blocks"])
        for key, ref in (("obj_vals_d", m["obj_d"]),
                         ("obj_vals_z", m["obj_z"])):
            obj_gap = max(obj_gap, abs(trace[key][i] - ref) / abs(ref))
        for key, ref in (("d_diff", m["d_diff"]), ("z_diff", m["z_diff"])):
            diff_gap = max(diff_gap, abs(trace[key][i] - ref) / abs(ref))
    return [("obj_gap", obj_gap, lim["obj_gap"]),
            ("diff_gap", diff_gap, lim["diff_gap"])], True


def run(ctx) -> Outcome:
    from ccsc_code_iccv2017_torch.parallel import distributed

    c = ctx.config
    if ctx.traffic["driver"] != "learner_window":
        raise ValueError(f"the learner runs a learner window, not "
                         f"{ctx.traffic['driver']!r}")
    p = dict(config=c, seed=ctx.seed, seconds=ctx.seconds,
             trace=bool(ctx.tracer.enabled), control=ctx.control,
             max_steps=ctx.max_steps, hook=RANK_HOOK)
    outs = distributed.launch(
        _rank, c["ranks"], args=(p,), device=ctx.device,
        timeout=GROUP_TIMEOUT_S,
        join_timeout=ctx.seconds + DEADLINE_PAST_WINDOW_S)
    r0 = outs[0]
    ctx.tracer.trace = r0["profile"]
    if r0["profile"] is not None:
        # the collectives' kernels on rank 0's card, which the
        # breakdown's ten longest operations may leave out
        nccl = {}
        for name, t0, t1 in r0["profile"].ops_named(("nccl",)):
            nccl[name[:120]] = nccl.get(name[:120], 0.0) + t1 - t0
        ctx.note("rank 0 collective kernels (s): " + json.dumps(nccl))
    trace = dict(r0["trace"])
    if all("d_pass_ms" in o["trace"] for o in outs):
        # each rank's device time of its two passes a step
        trace["rank_pass_ms"] = [
            [d + z for d, z in zip(o["trace"]["d_pass_ms"],
                                   o["trace"]["z_pass_ms"])] for o in outs]
    size = c["side"] + c["support"] - 1
    record = RunRecord(
        cell=ctx.cell, config=c, traffic=ctx.traffic,
        setup_s=r0["t_ready"] - ctx.t_start, window_s=r0["wall"],
        steps=r0["steps"], learn_trace=trace,
        shapes={"codes": c["blocks"] * c["ni"] // c["ranks"],
                "K": c["num_filters"], "S": size,
                "F": size * (size // 2 + 1), "ranks": c["ranks"]},
        trace=r0["profile"],
    )
    checks = [Check(*t) for t in r0["checks"]]
    return Outcome(record, r0["steps"], 0, max(o["peak"] for o in outs),
                   checks, r0["complete"])
