"""Serving benchmark: the engine against the direct-call loop.

    python -m ccsc_code_iccv2017_torch.serve.bench [--requests 40]
        [--padded 2] [--slots 4] [--side 256] [--pad-side 240]
        [--max-it 100] [--tol 1e-3] [--seed 0] [--device cuda]

One stream of inpainting requests against the repo's k=100 11x11 bank
(``--requests`` Gaussian-smoothed noise images of ``--side``² and
``--padded`` of ``--pad-side``², 50% masks, the smooth-fill warm start,
from ``--seed``) runs twice: through a :class:`CodecEngine` with one
bucket of ``--slots`` slots at ``--side``², all submitted at once; and
through one ``reconstruct(plan=...)`` call per request (the direct-call
loop; its plans, one per request shape, are built and warmed before the
clock starts, as the engine's are at construction). Prints one JSON
record: requests/s of each (the engine's over the whole window and over
its full dispatches alone), the engine's p50, p90 and largest latency
(no p99: a stream of tens of requests cannot support it), the largest
valid-region relative difference between the two, slots, bucket, and
on the card its name and power limit. It writes no ledger.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import ProblemGeom, ServeConfig, SolveConfig
from ..data.images import smooth_fill_batch, smooth_noise_images
from ..models.reconstruct import ReconstructionProblem, build_plan, reconstruct
from ..utils.device import resolve_device
from ..utils.io_mat import load_filters_2d
from .engine import CodecEngine, _bucket_name

BANK = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "artifacts_2d", "learned_bank.mat",
)


def make_requests(sides: Sequence[int], seed: int) -> List[Dict]:
    """One request dict (b, mask, smooth_init, x_orig) per side:
    Gaussian-smoothed noise in [0, 1], a 50% mask, the smooth fill."""
    rng = np.random.default_rng(seed)
    out = []
    for side in sides:
        x = smooth_noise_images(rng, 1, side)
        m = (rng.random(x.shape) < 0.5).astype(np.float32)
        sm = smooth_fill_batch(x, m)
        out.append({"b": x[0] * m[0], "mask": m[0], "smooth_init": sm[0],
                    "x_orig": x[0]})
    return out


def run_engine(engine: CodecEngine, requests: List[Dict],
               timeout: float = 600.0) -> Tuple[list, float, float]:
    """Submit every request at once and wait for all: (results in
    order, wall seconds from the first submit to the last result, wall
    seconds of the submit loop alone)."""
    t0 = time.perf_counter()
    futs = [engine.submit(**q) for q in requests]
    submit_s = time.perf_counter() - t0
    results = [f.result(timeout=timeout) for f in futs]
    return results, time.perf_counter() - t0, submit_s


def run_direct_loop(d, prob, cfg, requests: List[Dict],
                    device) -> Tuple[list, float]:
    """One ``reconstruct(plan=...)`` call per request, each ending in
    its result's read to the host: (results, wall seconds). The plans
    are built, and each shape solved once, before the clock starts."""
    plans = {}
    for q in requests:
        shape = tuple(q["b"].shape)
        if shape not in plans:
            plans[shape] = build_plan(d, prob, cfg, shape, device=device)
            _solve(d, prob, dataclasses.replace(cfg, max_it=1), q,
                   plans[shape], device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    results = [_solve(d, prob, cfg, q, plans[tuple(q["b"].shape)], device)
               for q in requests]
    return results, time.perf_counter() - t0


def _solve(d, prob, cfg, q, plan, device):
    res = reconstruct(
        q["b"][None], d, prob, cfg, mask=q["mask"][None],
        smooth_init=q["smooth_init"][None], x_orig=q["x_orig"][None],
        plan=plan, device=device,
    )
    return res.recon[0].cpu().numpy(), int(res.trace.num_iters)


def max_rel_diff(served, looped) -> float:
    """Largest over requests of max|served - loop| / max|loop| on the
    request's own (valid) region."""
    worst = 0.0
    for s, (rec, _) in zip(served, looped):
        scale = max(float(np.abs(rec).max()), 1e-9)
        worst = max(worst, float(np.abs(s.recon - rec).max()) / scale)
    return worst


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def record(engine: CodecEngine, served, engine_s: float, submit_s: float,
           looped, loop_s: float, device) -> Dict:
    """The bench's JSON record from one engine run and one loop run.
    ``full_dispatch_requests_per_sec`` is the requests of the dispatches
    that filled every slot over those dispatches' summed wall: the
    engine's rate at full occupancy, without the stream's part-full
    tail or the gaps between dispatches."""
    slots, spatial = engine.buckets[0]
    n = len(served)
    log = engine.dispatch_log
    full = [e for e in log if e["requests"] == slots]
    lat_ms = 1e3 * np.array([s.latency_s for s in served])
    rec = {
        "requests": n,
        "slots": slots,
        "bucket": _bucket_name(slots, spatial),
        "engine_requests_per_sec": n / engine_s,
        "full_dispatch_requests_per_sec": (
            sum(e["requests"] for e in full)
            / sum(e["wall_s"] for e in full) if full else None),
        "loop_requests_per_sec": n / loop_s,
        "speedup_engine_vs_loop": loop_s / engine_s,
        "engine_wall_s": engine_s,
        "submit_wall_s": submit_s,
        "loop_wall_s": loop_s,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p90_ms": float(np.percentile(lat_ms, 90)),
        "max_ms": float(lat_ms.max()),
        "dispatches": len(log),
        "full_dispatches": len(full),
        "dispatch_requests": [e["requests"] for e in log],
        "dispatch_iters": [e["iters"] for e in log],
        "dispatch_ms": [1e3 * e["wall_s"] for e in log],
        "served_iters": [int(s.trace.num_iters) for s in served],
        "loop_iters": [it for _, it in looped],
        "max_rel_err_vs_loop": max_rel_diff(served, looped),
    }
    dev = torch.device(device)
    if dev.type == "cuda":
        rec["device"] = torch.cuda.get_device_name(dev)
        rec["card"] = card_line()
    else:
        rec["device"] = "cpu"
    return rec


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=40)
    p.add_argument("--padded", type=int, default=2)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--side", type=int, default=256)
    p.add_argument("--pad-side", type=int, default=240)
    p.add_argument("--max-it", type=int, default=100)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    d = load_filters_2d(BANK)
    prob = ReconstructionProblem(ProblemGeom(d.shape[1:], d.shape[0]))
    cfg = SolveConfig(lambda_residual=5.0, lambda_prior=2.0,
                      max_it=args.max_it, tol=args.tol)
    reqs = make_requests(
        [args.side] * args.requests + [args.pad_side] * args.padded,
        args.seed,
    )
    with CodecEngine(d, prob, cfg, ServeConfig(
            buckets=((args.slots, (args.side, args.side)),),
            verbose="none"), device=dev) as eng:
        served, engine_s, submit_s = run_engine(eng, reqs)
        looped, loop_s = run_direct_loop(d, prob, cfg, reqs, dev)
        out = record(eng, served, engine_s, submit_s, looped, loop_s, dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
