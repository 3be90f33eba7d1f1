"""Serving benchmark: the engine against the direct-call loop.

    python -m ccsc_code_iccv2017_torch.serve.bench [--requests 40]
        [--padded 2] [--slots 4] [--side 256] [--pad-side 240]
        [--max-it 100] [--tol 1e-3] [--seed 0] [--device cuda]
        [--mesh SPEC] [--mesh-devices 0,0] [--tune off|auto|sweep]
        [--pipeline DEPTH] [--tune-store PATH]

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
on the card its name and power limit. The record also carries the
perf ledger's ``chip``, ``shape_key`` and ``knobs``: with
``CCSC_PERF_LEDGER`` set, ``main`` appends it as a ``kind=serve`` row
(``analysis.ledger.append_serve_record``, a second row for the mesh
arm); unset, it writes no ledger.

``--mesh SPEC`` (``BATCH`` or ``BATCHxFREQ``, e.g. ``4`` or ``2x2``;
default the ``CCSC_SERVE_MESH`` env knob) adds the mesh arm: the same
stream through a mesh engine on the first prod(SPEC) cards, or on the
cards ``--mesh-devices`` names (an index may repeat: positions sharing
one card) (``ServeConfig.mesh_shape`` / ``mesh_devices``), beside the
baseline engine, which pins one
device (``mesh_shape=()``). It records ``mesh``, ``mesh_devices``,
``mesh_requests_per_sec``, ``speedup_mesh_vs_default``,
``mesh_max_rel_err_vs_loop`` and ``mesh_warmup_s``, the mesh engine's
latencies and per-position loop iterations and all-gathers, and the
all-gather's ms an iteration on each position (CUDA events on its
stream) over one more full dispatch; or ``mesh_skipped`` with the reason
when the cards cannot back the mesh or it does not divide the bucket. A
malformed spec refuses before any work.

:func:`run_serve_workload` adds the JAX bench's two other engines on the
same stream, each pinned to one device: ``--tune`` (default the
``CCSC_SERVE_TUNE`` knob; 'auto' applies a store entry, 'sweep' measures
the solve arms on this device first) runs a second engine with
``ServeConfig.tune`` and records ``tuned_requests_per_sec``,
``speedup_tuned_vs_default``, ``tuned_knobs`` and
``tuned_max_rel_err_vs_loop``; ``--pipeline DEPTH`` > 1 (default the
``CCSC_SERVE_PIPELINE`` knob) runs one at that ``pipeline_depth`` and
records ``pipeline_requests_per_sec``, ``speedup_pipeline_vs_default``
and ``pipeline_bit_identical`` (every result bitwise the default
engine's, measured, not assumed). The default engine pins depth 1.
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
from ..tune import store as tune_store
from ..utils import env, perfmodel, validate
from .engine import CodecEngine, _bucket_name, parse_mesh_shape

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
    # the perf ledger's key of this configuration (analysis.ledger)
    geom = engine.geom
    sides = [max(s.recon.shape[-2:]) for s in served]
    rec["chip"] = perfmodel.detect_chip(dev)
    rec["shape_key"] = tune_store.solve_shape_key(
        "solve2d", k=geom.num_filters, support=tuple(geom.spatial_support),
        spatial=spatial)
    rec["knobs"] = {
        "requests": n, "size_min": min(sides), "size_max": max(sides),
        "k": geom.num_filters, "support": geom.spatial_support[0],
        "slots": slots, "max_it": engine.cfg.max_it,
        "max_wait_ms": engine.serve_cfg.max_wait_ms,
    }
    return rec


def mesh_record(engine: CodecEngine, served, engine_s: float,
                warm_s: float, looped, base_rps: float) -> Dict:
    """The mesh arm's fields, from one mesh engine run on the stream."""
    lat_ms = 1e3 * np.array([s.latency_s for s in served])
    log = engine.dispatch_log
    slots = engine.buckets[0][0]
    full = [e for e in log if e["requests"] == slots]
    rps = len(served) / engine_s
    return {
        "mesh": "x".join(str(a) for a in engine.mesh_shape),
        "mesh_devices": engine.devices,
        "mesh_position_devices": [str(v) for v in engine.position_devices],
        "mesh_requests_per_sec": rps,
        "mesh_full_dispatch_requests_per_sec": (
            sum(e["requests"] for e in full)
            / sum(e["wall_s"] for e in full) if full else None),
        "speedup_mesh_vs_default": rps / base_rps,
        "mesh_max_rel_err_vs_loop": max_rel_diff(served, looped),
        "mesh_warmup_s": warm_s,
        "mesh_p50_ms": float(np.percentile(lat_ms, 50)),
        "mesh_p90_ms": float(np.percentile(lat_ms, 90)),
        "mesh_max_ms": float(lat_ms.max()),
        "mesh_served_iters": [int(s.trace.num_iters) for s in served],
        "mesh_dispatch_iters": [e["iters"] for e in log],
        "mesh_position_iters": [e["position_iters"] for e in log],
        "mesh_gathers": [e["gathers"] for e in log],
    }


def gather_ms(engine: CodecEngine, request: Dict) -> Dict:
    """One more full dispatch of ``request`` repeated in every slot with
    the mesh's all-gathers timed: per position, the median ms of its
    gathers and their count."""
    mesh = engine.mesh
    slots = engine.buckets[0][0]
    engine.set_max_wait_ms(60_000.0)
    mesh.collective_ms()  # clear
    mesh.time_collectives = True
    try:
        futs = [engine.submit(**request) for _ in range(slots)]
        for f in futs:
            f.result(timeout=600)
    finally:
        mesh.time_collectives = False
        engine.set_max_wait_ms(engine.serve_cfg.max_wait_ms)
    per = mesh.collective_ms()
    return {"gather_ms_median": [float(np.median(m)) if m else None
                                 for m in per],
            "gathers": [len(m) for m in per]}


def run_mesh_arm(d, prob, cfg, reqs, spec_shape, bucket, dev, looped,
                 base_rps, mesh_devices=None) -> Dict:
    """The mesh arm, or ``mesh_skipped`` with the reason when the cards
    cannot back the mesh or it cannot shard the bucket."""
    try:
        t0 = time.perf_counter()
        eng = CodecEngine(d, prob, cfg, ServeConfig(
            buckets=(bucket,), verbose="none", mesh_shape=spec_shape,
            mesh_devices=mesh_devices), device=dev)
    except (ValueError, validate.CCSCInputError) as e:
        return {"mesh_skipped": str(e)}
    with eng:
        warm_s = time.perf_counter() - t0
        served, engine_s, _ = run_engine(eng, reqs)
        out = mesh_record(eng, served, engine_s, warm_s, looped, base_rps)
        if "freq" in eng.mesh.shape:
            out["mesh_gather_timing"] = gather_ms(eng, reqs[0])
    return out


def run_serve_workload(d, prob, cfg, reqs, bucket, dev, looped,
                       base_served, base_rps: float, tune_mode: str = "off",
                       pipe_depth: int = 1,
                       tune_store_path=None) -> Dict:
    """The tuned and pipelined arms of the JAX bench's
    ``run_serve_workload`` on the stream ``reqs``: each a second engine
    with one ServeConfig field changed (``tune``, or ``pipeline_depth``),
    timed by the same protocol as the default engine (``base_served``,
    ``base_rps``). Returns the record fields of the arms that ran."""
    out: Dict = {}
    if tune_mode != "off":
        t0 = time.perf_counter()
        with CodecEngine(d, prob, cfg, ServeConfig(
                buckets=(bucket,), verbose="none", mesh_shape=(),
                pipeline_depth=1, tune=tune_mode,
                tune_store=tune_store_path), device=dev) as eng:
            warm_s = time.perf_counter() - t0
            served, engine_s, _ = run_engine(eng, reqs)
            rps = len(served) / engine_s
            out.update({
                "tuned_requests_per_sec": rps,
                "speedup_tuned_vs_default": rps / base_rps,
                "tuned_warmup_s": warm_s,
                "tuned_knobs": dict(eng._knob_dict),
                "tuned_max_rel_err_vs_loop": max_rel_diff(served, looped),
            })
    if pipe_depth and int(pipe_depth) > 1:
        t0 = time.perf_counter()
        with CodecEngine(d, prob, cfg, ServeConfig(
                buckets=(bucket,), verbose="none", mesh_shape=(),
                pipeline_depth=int(pipe_depth)), device=dev) as eng:
            warm_s = time.perf_counter() - t0
            served, engine_s, _ = run_engine(eng, reqs)
            rps = len(served) / engine_s
            out.update({
                "pipeline_depth": int(pipe_depth),
                "pipeline_requests_per_sec": rps,
                "speedup_pipeline_vs_default": rps / base_rps,
                "pipeline_bit_identical": all(
                    np.array_equal(a.recon, b.recon)
                    and int(a.trace.num_iters) == int(b.trace.num_iters)
                    for a, b in zip(base_served, served)),
                "pipeline_warmup_s": warm_s,
                "pipeline_knobs": dict(eng._knob_dict),
            })
    return out


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
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="serving mesh BATCH or BATCHxFREQ for the mesh "
                        "arm (default: CCSC_SERVE_MESH)")
    p.add_argument("--mesh-devices", default=None, metavar="LIST",
                   help="card index of each mesh position, e.g. 0,0")
    p.add_argument("--tune", default=None, choices=["off", "auto", "sweep"],
                   help="the tuned arm (default: CCSC_SERVE_TUNE)")
    p.add_argument("--pipeline", type=int, default=None, metavar="DEPTH",
                   help="the pipelined arm's depth, > 1 to run it "
                        "(default: CCSC_SERVE_PIPELINE)")
    p.add_argument("--tune-store", default=None, metavar="PATH",
                   help="the tuned arm's store (default: CCSC_TUNE_STORE, "
                        "tune.store.default_store_path)")
    args = p.parse_args(argv)
    tune_mode = args.tune or env.env_str("CCSC_SERVE_TUNE") or "off"
    pipe_depth = (args.pipeline if args.pipeline is not None
                  else env.env_int("CCSC_SERVE_PIPELINE"))
    # a malformed spec is the caller's error: refuse before any work
    spec = args.mesh if args.mesh is not None else env.env_str(
        "CCSC_SERVE_MESH")
    mesh_shape = parse_mesh_shape(spec) if spec else None
    mesh_devices = (tuple(int(i) for i in args.mesh_devices.split(","))
                    if args.mesh_devices else None)
    dev = resolve_device(args.device)

    d = load_filters_2d(BANK)
    prob = ReconstructionProblem(ProblemGeom(d.shape[1:], d.shape[0]))
    cfg = SolveConfig(lambda_residual=5.0, lambda_prior=2.0,
                      max_it=args.max_it, tol=args.tol)
    reqs = make_requests(
        [args.side] * args.requests + [args.pad_side] * args.padded,
        args.seed,
    )
    bucket = (args.slots, (args.side, args.side))
    with CodecEngine(d, prob, cfg, ServeConfig(
            buckets=(bucket,), verbose="none", mesh_shape=(),
            pipeline_depth=1), device=dev) as eng:
        served, engine_s, submit_s = run_engine(eng, reqs)
        looped, loop_s = run_direct_loop(d, prob, cfg, reqs, dev)
        out = record(eng, served, engine_s, submit_s, looped, loop_s, dev)
    out.update(run_serve_workload(
        d, prob, cfg, reqs, bucket, dev, looped, served,
        out["engine_requests_per_sec"], tune_mode=tune_mode,
        pipe_depth=pipe_depth, tune_store_path=args.tune_store))
    if mesh_shape is not None:
        out.update(run_mesh_arm(d, prob, cfg, reqs, mesh_shape, bucket, dev,
                                looped, out["engine_requests_per_sec"],
                                mesh_devices))
    # the durable perf ledger: a no-op unless CCSC_PERF_LEDGER is set
    from ..analysis import ledger
    from ..utils import obs

    ledger.append_serve_record(out, git_sha=obs.git_sha(),
                               source="serve.bench")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
