"""Inpainting requests served by the port's ``serve/engine.py::CodecEngine``:
one bucket of ``slots`` slots at the configuration's side, the bank and
solve parameters of the configuration, the engine's defaults otherwise
(depth-1 dispatch, no tuning, no capture, one device).

``correct``: once the window has closed and the engine is gone, a
sample drawn from the seed of the requests it finished (the one that
ran most iterations among them) is solved again by the plain reference
(portbench/reference/inpaint.py, float64) from the same request, and
``recon_gap`` is the largest max|served - reference| / max|reference|.
"""
from __future__ import annotations

import time

import numpy as np

from .. import drivers, inputs
from ..record import RunRecord
from ..reference import inpaint
from . import Check, Outcome


def _engine(ctx, d):
    import dataclasses

    from ccsc_code_iccv2017_torch.config import (ProblemGeom, ServeConfig,
                                                 SolveConfig)
    from ccsc_code_iccv2017_torch.models.reconstruct import \
        ReconstructionProblem
    from ccsc_code_iccv2017_torch.serve.engine import CodecEngine

    c = ctx.config
    cfg = SolveConfig(**c["solve"])
    if ctx.control:
        # the program's own lower-precision path: bf16 code storage
        cfg = dataclasses.replace(cfg, storage_dtype="bfloat16")
    side = c["side"]
    geom = ProblemGeom((c["support"],) * 2, c["num_filters"])
    scfg = ServeConfig(
        buckets=((c["serve"]["slots"], (side, side)),),
        max_wait_ms=c["serve"]["max_wait_ms"], verbose="none",
        mesh_shape=(), pipeline_depth=1, capture_dir="", tune="off",
    )
    return CodecEngine(d, ReconstructionProblem(geom), cfg, scfg,
                       device=ctx.device)


def start(ctx):
    """The cell's set-up: the bank, the seed's pool of requests, the
    engine, and its bucket warmed with real requests (every shape and
    path the window runs, at full iterations). Returns ``(engine,
    submit, bank, pool)``, ``submit(j)`` sending pool entry j; the
    caller closes the engine."""
    import torch

    c, tr = ctx.config, ctx.traffic
    d = inputs.bank(c)
    pool = inputs.inpaint_requests(ctx.seed, tr["pool"], c["side"],
                                   torch.device(ctx.device))
    engine = _engine(ctx, d)

    def submit(j):
        return engine.submit(b=pool["b"][j], mask=pool["mask"][j],
                             smooth_init=pool["smooth_init"][j])

    try:
        for f in [submit(j % tr["pool"])
                  for j in range(c["serve"]["slots"])]:
            f.result(timeout=600)
    except BaseException:
        engine.close()
        raise
    return engine, submit, d, pool


def run(ctx) -> Outcome:
    import torch

    c, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    slots = c["serve"]["slots"]
    engine, submit, d, pool = start(ctx)
    try:
        log0 = len(engine.dispatch_log)
        setup_s = time.perf_counter() - ctx.t_start
        t0, recs = drivers.DRIVERS[tr["driver"]](
            tr, submit, ctx.seed, ctx.seconds, ctx.tracer, ctx.trace_at)
        ctx.tracer.stop(until=t0 + ctx.seconds)
        log = engine.dispatch_log[log0:]
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    finally:
        engine.close()

    requests = []
    for r in recs:
        res = r["result"]
        requests.append({
            "pool": r["pool"], "due": r["due"], "submit": r["submit"],
            "done": r["done"] if res is not None else None,
            "wait_s": res.wait_s if res is not None else None,
            "iters": int(res.trace.num_iters) if res is not None else None,
            "ok": res is not None,
        })
    failed = sum(not q["ok"] for q in requests)
    F = (c["side"] + c["support"] - 1) * ((c["side"] + c["support"] - 1)
                                          // 2 + 1)
    record = RunRecord(
        cell=ctx.cell, config=c, traffic=tr, setup_s=setup_s,
        window_s=ctx.seconds, window_t0=t0, requests=requests,
        dispatches=_dispatches(log, requests) if not failed else [],
        shapes={"K": c["num_filters"], "F": F, "slots": slots},
        trace=ctx.tracer.trace,
    )
    checks, complete = _check(ctx, d, pool, recs, dev)
    return Outcome(record, len(requests), failed, int(peak), checks,
                   complete)


def _dispatches(log, requests):
    """The engine's dispatch log, with each entry's requests (in the
    order their results came back: one worker resolves them dispatch by
    dispatch) and its end on the wall clock."""
    done = sorted((q for q in requests if q["ok"]), key=lambda q: q["done"])
    out, i = [], 0
    for e in log:
        members = done[i:i + e["requests"]]
        i += e["requests"]
        if len(members) < e["requests"]:
            break
        out.append({"requests": e["requests"], "iters": e["iters"],
                    "wall_s": e["wall_s"],
                    "t_end": min(q["done"] for q in members),
                    "members": [q["iters"] for q in members]})
    return out


def _check(ctx, d, pool, recs, dev):
    import torch

    c = ctx.config
    ok = [r for r in recs if r["result"] is not None]
    if not ok:
        return [Check("recon_gap", float("nan"),
                      c["check"]["limits"]["recon_gap"])], False
    n = min(c["check"]["sample"], len(ok))
    pick = set(inputs.rng(ctx.seed, 7).choice(len(ok), n, replace=False)
               .tolist())
    pick.add(max(range(len(ok)),
                 key=lambda i: int(ok[i]["result"].trace.num_iters)))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params = dict(c["solve"])
    dt = torch.float64
    bank = torch.from_numpy(d).to(dev)
    refs, worst, iter_diff = {}, 0.0, 0
    for i in sorted(pick):
        r = ok[i]
        j = r["pool"]
        if j not in refs:
            refs[j] = inpaint.solve(
                *(torch.from_numpy(pool[k][j]).to(dev)
                  for k in ("b", "mask", "smooth_init")), bank, params, dt)
        ref, it = refs[j]
        ref = ref.cpu().numpy()
        got = r["result"].recon
        worst = max(worst, float(np.abs(got - ref).max()
                                 / max(np.abs(ref).max(), 1e-30)))
        iter_diff = max(iter_diff,
                        abs(int(r["result"].trace.num_iters) - it))
    ctx.note(f"recon_gap over {len(pick)} served requests of {len(ok)}; "
             f"largest iteration difference {iter_diff}")
    return [Check("recon_gap", worst, c["check"]["limits"]["recon_gap"])], True
