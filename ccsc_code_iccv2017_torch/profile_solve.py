"""Where one served request's, one engine dispatch's, or one demosaicing
solve's time goes on the card.

    python -m ccsc_code_iccv2017_torch.profile_solve [--size 256]
        [--max-it 100] [--tol 1e-3] [--slots 0] [--requests SLOTS]
        [--app inpaint|demosaic] [--mesh SPEC] [--mesh-devices 0,0]

Profiles, with ``torch.profiler``, inpainting requests against the
repo's k=100 11x11 bank (Gaussian-smoothed noise images from
``--seed``, 50% masks, smooth-fill warm start, lambda_residual=5,
lambda_prior=2, as the serving phases run them), or with ``--app
demosaic`` one hyperspectral demosaicing solve as
``apps/demosaic_hyperspectral.py`` runs it (the k=100 11x11x31 bank, a
31-band synthetic cube of ``--size`` squared, the mosaic mask and its
smooth fill, lambda_residual=1e5, lambda_prior=1, unpadded, the W > 1
Woodbury z-solve):

- ``--slots 0``: one direct ``reconstruct(plan=...)`` call (the only
  mode of ``--app demosaic``);
- ``--slots S``: one dispatch of a ``serve.CodecEngine`` with one S-slot
  bucket at ``--size``, holding ``--requests`` requests (S by default;
  fewer leave filler slots, whose early stop makes every later
  iteration commit through the frozen-slot selects). The window runs
  from the first submit to the last result, so it holds the canvas fill,
  the copies to the card, the solve, the readbacks and the worker
  thread's hand-off. ``--mesh SPEC`` (``BATCH`` or ``BATCHxFREQ``)
  serves it from a mesh engine on the first prod(SPEC) cards, or on
  the cards ``--mesh-devices`` names (an index may repeat: positions
  sharing one card); the busy share is then given per card too.

Each runs once unprofiled first (kernels, cuFFT plans, the allocator).
Prints the device kernels ranked by their summed time and, as its last
line, one JSON object with the wall time, the device-busy share (summed
kernel time over wall time; for the engine also over the dispatch's own
wall), the top kernels and the device time by kind of kernel: cuFFT,
cuBLAS/cuSOLVER products and factorizations, K1, and the rest
(elementwise passes, reductions, copies).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .config import ProblemGeom, ServeConfig, SolveConfig
from .data.images import smooth_fill_batch, smooth_noise_images
from .models.reconstruct import ReconstructionProblem, build_plan, reconstruct
from .serve.engine import CodecEngine, parse_mesh_shape
from .utils.device import resolve_device
from .utils.io_mat import load_filters_2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "artifacts_2d", "learned_bank.mat")
BANK_HS = os.path.join(REPO, "artifacts_family_cpu", "bank_hs.mat")

# kernel-name fragments of each kind, first match wins
KINDS = (
    ("K1", ("k1_registers", "k1_loop")),
    ("K2a", ("fused_z_pass_a",)),
    ("K2b", ("fused_z_pass_b",)),
    ("cufft", ("fft", "FFT")),
    ("cublas_cusolver", ("gemm", "gemv", "Gemm", "Gemv", "potrf", "potri",
                         "trsm", "trmm", "syrk", "herk", "cholesky",
                         "magma", "cusolver", "cublas")),
)


def kernel_kind(name: str) -> str:
    for kind, frags in KINDS:
        if any(f in name for f in frags):
            return kind
    return "other"


def _requests(size, seed, n):
    rng = np.random.default_rng(seed)
    x = smooth_noise_images(rng, n, size)
    mask = (rng.random(x.shape) < 0.5).astype(np.float32)
    return x, mask, smooth_fill_batch(x, mask)


def _device_us(evt) -> float:
    # the attribute was renamed across torch versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _direct(d, prob, cfg, size, seed, dev):
    """One direct request: (run, close) where run() solves it and
    returns its iteration count and None."""
    x, mask, sm = _requests(size, seed, 1)
    plan = build_plan(d, prob, cfg, x.shape[1:], device=dev)

    def run():
        res = reconstruct(x * mask, d, prob, cfg, mask=mask, smooth_init=sm,
                          x_orig=x, plan=plan, device=dev)
        return int(res.trace.num_iters), None

    return run, lambda: None


def _demosaic(size, seed, max_it, tol, dev):
    """One demosaicing solve as the app runs it: (run, close)."""
    from .apps.demosaic_hyperspectral import mosaic_mask, nn_fill_smooth_init
    from .data.volumes import synthetic_hyperspectral
    from .utils.io_mat import load_filters_hyperspectral

    d = load_filters_hyperspectral(BANK_HS)
    k, bands = d.shape[0], d.shape[1]
    cube = synthetic_hyperspectral(n=1, bands=bands, side=size, seed=seed)[0]
    mask = mosaic_mask(bands, size, size)
    sm = nn_fill_smooth_init(cube * mask, mask)
    prob = ReconstructionProblem(ProblemGeom(d.shape[2:], k, (bands,)),
                                 pad=False)
    cfg = SolveConfig(lambda_residual=1e5, lambda_prior=1.0, max_it=max_it,
                      tol=tol)
    plan = build_plan(d, prob, cfg, (size, size), device=dev)

    def run():
        res = reconstruct((cube * mask)[None], d, prob, cfg,
                          mask=mask[None], smooth_init=sm[None],
                          x_orig=cube[None], plan=plan, device=dev)
        return int(res.trace.num_iters), None

    return run, lambda: None


def _engine(d, prob, cfg, size, seed, dev, slots, n, mesh=None,
            mesh_devices=None):
    """One engine dispatch of ``n`` requests: (run, close) where run()
    submits them, waits for every result and returns the dispatch's
    iterations and its own wall seconds."""
    x, mask, sm = _requests(size, seed, n)
    # the lane gathers every submit; set_max_wait_ms(0) then flushes it
    eng = CodecEngine(d, prob, cfg, ServeConfig(
        buckets=((slots, (size, size)),), max_wait_ms=60_000.0,
        verbose="none", mesh_shape=mesh if mesh is not None else (),
        mesh_devices=mesh_devices), device=dev)

    def run():
        eng.set_max_wait_ms(60_000.0)
        before = len(eng.dispatch_log)
        futs = [eng.submit(x[i] * mask[i], mask=mask[i],
                           smooth_init=sm[i], x_orig=x[i])
                for i in range(n)]
        eng.set_max_wait_ms(0.0)
        for f in futs:
            f.result(timeout=600)
        log = eng.dispatch_log[before:]
        if len(log) != 1:
            raise RuntimeError(f"{n} requests took {len(log)} dispatches")
        return log[0]["iters"], log[0]["wall_s"]

    return run, eng.close


def busy_by_card(prof) -> dict:
    """Per card index, the device time its kernels cover (µs): the union
    of their intervals, so kernels of positions that share a card and
    overlap count once."""
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    out = {}
    for idx, iv in spans.items():
        iv.sort()
        total, (lo, hi) = 0.0, iv[0]
        for a, b in iv[1:]:
            if a > hi:
                total, lo, hi = total + hi - lo, a, b
            else:
                hi = max(hi, b)
        out[idx] = total + hi - lo
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--max-it", type=int, default=100)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--slots", type=int, default=0)
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--app", default="inpaint", choices=["inpaint",
                                                          "demosaic"])
    p.add_argument("--mesh", default=None, metavar="SPEC")
    p.add_argument("--mesh-devices", default=None, metavar="LIST")
    args = p.parse_args(argv)
    if args.app != "inpaint" and args.slots:
        p.error("--slots profiles the inpainting engine only")
    if args.mesh and not args.slots:
        p.error("--mesh profiles the engine: give --slots")
    mesh = parse_mesh_shape(args.mesh) if args.mesh else None
    mesh_devices = (tuple(int(i) for i in args.mesh_devices.split(","))
                    if args.mesh_devices else None)
    dev = resolve_device("cuda")

    n = args.requests or max(args.slots, 1)
    if args.app == "demosaic":
        run, close = _demosaic(args.size, args.seed, args.max_it, args.tol,
                               dev)
    else:
        d = load_filters_2d(BANK)
        prob = ReconstructionProblem(ProblemGeom(d.shape[1:], d.shape[0]))
        cfg = SolveConfig(lambda_residual=5.0, lambda_prior=2.0,
                          max_it=args.max_it, tol=args.tol)
        if args.slots:
            run, close = _engine(d, prob, cfg, args.size, args.seed, dev,
                                 args.slots, n, mesh, mesh_devices)
        else:
            run, close = _direct(d, prob, cfg, args.size, args.seed, dev)
    try:
        run()  # unprofiled: kernels, cuFFT plans, the allocator
        torch.cuda.synchronize(dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            it, dispatch_s = run()
            torch.cuda.synchronize(dev)
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        close()
    # device-side events only: the aten ops that launched them would
    # count the same kernel time a second time
    rows = sorted(
        ((e.key, _device_us(e), e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and _device_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_card = busy_by_card(prof)
    kinds = {}
    for key, us, _ in rows:
        kinds[kernel_kind(key)] = kinds.get(kernel_kind(key), 0.0) + us
    what = (f"engine dispatch of {n} requests in {args.slots} slots"
            if args.slots else f"direct {args.app} request")
    print(f"{what}: {it} iterations, wall {wall_us / 1e3:.2f} ms, device "
          f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%)"
          + (f"; dispatch wall {1e3 * dispatch_s:.2f} ms "
             f"({100 * busy_us / (1e6 * dispatch_s):.1f}%)"
             if dispatch_s else ""))
    for key, us, count in rows[: args.top]:
        print(f"{us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}% "
              f"x{count:<5d} {key[:90]}")
    print("by kind: " + ", ".join(
        f"{kind} {us / 1e3:.3f} ms ({100 * us / busy_us:.1f}%)"
        for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1])))
    out = {
        "device": torch.cuda.get_device_name(dev), "app": args.app,
        "size": args.size,
        "slots": args.slots, "requests": n,
        "iters": it, "wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / wall_us,
        "dispatch_ms": 1e3 * dispatch_s if dispatch_s else None,
        "dispatch_busy_share": (busy_us / (1e6 * dispatch_s)
                                if dispatch_s else None),
        "top": [{"kernel": k[:120], "ms": us / 1e3, "count": c}
                for k, us, c in rows[: args.top]],
        "by_kind_ms": {kind: us / 1e3 for kind, us in kinds.items()},
        "mesh": args.mesh, "mesh_devices": mesh_devices,
        # per card: the union of its kernels' intervals over the wall,
        # and over the dispatch's own wall
        "busy_share_by_card": {str(i): us / wall_us
                               for i, us in by_card.items()},
        "dispatch_busy_share_by_card": (
            {str(i): us / (1e6 * dispatch_s) for i, us in by_card.items()}
            if dispatch_s else None),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
