"""The 2D north star on ``block_mesh(R)`` beside the one-card learner.

    python -m ccsc_code_iccv2017_torch.parallel.mesh_check [--ranks 4]
        [--steps 3] [--seed 0]

Learns k=100 11x11 filters from 8 consensus blocks x 100 synthetic
100x100 images (Gaussian-smoothed noise from ``--seed``, local contrast
normalization, zero mean; max_it_d=5, max_it_z=10, rho 5000/1, fused_z:
K2 on every rank) for ``--steps`` outer steps at tol=0, twice from the
same init (a CUDA generator seeded with ``--seed``): once on one card in
this process, then on R ranks (``parallel.distributed.launch``), one per
GPU over NCCL, each holding 8 / R blocks. The kernels are built before
either run is timed. ``run(..., shared=True)`` puts the R ranks on
cuda:0 over ``gloo`` instead (the one-card smoke seam of
``chip_smoke.py``).

Holds the mesh run to the one-card run at the JAX package's mesh limits
(filters 2e-5; objective traces rtol 1e-4; the codes, gathered on rank
0, 2e-5 of max(1, max|z|)), each rank's K2 launches to max_it_z a step,
its Gram-inverse kernel's (ops.herm_inv) to one a step and its d-solve
kernel's (ops.d_solve) to max_it_d a step (likewise the one card's), and
prints
one JSON record: steps/s of both runs, each rank's d-pass and z-pass ms
a step, the consensus all-reduce's ms per d-iteration, peak memory per
rank, the distances, the card's name and power limit. Exits
non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

NORTH_STAR = dict(blocks=8, ni=100, side=100, k=100, support=11)
# the learner's settings (learn_kernels_2D_large.m); chip_smoke.py's
# learner phases share them
CFG = dict(max_it_d=5, max_it_z=10, lambda_residual=1.0, lambda_prior=1.0,
           rho_d=5000.0, rho_z=1.0, tol=0.0, track_objective=True,
           verbose="none")
D_ATOL = 2e-5  # the JAX package's mesh tests (tests/test_learn.py)
TRACE_RTOL = 1e-4


def training_images(seed: int, n: int, side: int) -> np.ndarray:
    """n synthetic side x side training images: Gaussian-smoothed noise
    from ``seed``, local contrast normalization and zero mean by the
    native library (numpy where it cannot be built) — the learner CLI's
    preprocessing (``data.images.load_images_native``'s path)."""
    from ..data import images, native

    raw = images.smooth_noise_images(np.random.default_rng(seed), n, side)
    return native.zero_mean_batch(native.local_cn_batch(raw))


def _problem(steps):
    from ..config import LearnConfig, ProblemGeom

    ns = NORTH_STAR
    return (ProblemGeom((ns["support"],) * 2, ns["k"]),
            LearnConfig(num_blocks=ns["blocks"], max_it=steps, fused_z=True,
                        **CFG))


def _mesh_rank(rank, b, steps, seed, ref_z_path, shared):
    """One rank: the learn on block_mesh(R), its counters and timings;
    rank 0 also holds the gathered codes to the one-card run's."""
    import torch

    from ..ops import d_solve, fused_z, herm_inv
    from . import consensus, mesh as mesh_lib

    geom, cfg = _problem(steps)
    world = torch.distributed.get_world_size()
    mesh = mesh_lib.block_mesh(world, devices=["cuda:0"] * world
                               if shared else None)
    dev = mesh.device
    mesh.time_collectives = True
    fz = fused_z.fused_z_iter
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fz.launches_a = fz.launches_b = herm_inv.invert.launches = 0
    d_solve.solve.launches = 0
    t0 = time.perf_counter()
    res = consensus.learn(
        b, geom, cfg, mesh=mesh, device="cuda",
        generator=torch.Generator(device=dev).manual_seed(seed),
    )
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = [fz.launches_a, fz.launches_b]
    herm_launches = herm_inv.invert.launches
    ds_launches = d_solve.solve.launches
    coll = mesh.collective_ms()
    peak = torch.cuda.max_memory_allocated(dev)
    out = dict(
        rank=rank, device=str(dev), wall_s=wall, launches=launches,
        herm_inv_launches=herm_launches, d_solve_launches=ds_launches,
        trace={k: res.trace[k] for k in ("obj_vals_d", "obj_vals_z",
                                         "d_diff", "z_diff", "tim_vals",
                                         "d_pass_ms", "z_pass_ms")},
        consensus_ms=coll.get("consensus", []),
        peak_bytes=peak, local_blocks=int(res.z.shape[0]),
        z_shape=list(res.z.shape), d=res.d.cpu(),
    )
    mesh.time_collectives = False
    z = mesh_lib.gather_blocks(res.z, mesh)
    if z is not None:
        ref = np.load(ref_z_path, mmap_mode="r")
        err = scale = 0.0
        for i in range(z.shape[0]):  # block by block: host memory
            zi = z[i].cpu().numpy()
            err = max(err, float(np.abs(zi - ref[i]).max()))
            scale = max(scale, float(np.abs(ref[i]).max()))
        out.update(z_max_abs_err=err, z_max_abs=scale,
                   z_gathered_shape=list(z.shape))
    return out


def _steps_per_s(tim_vals) -> dict:
    """Outer steps/s over every step, and over the steps after the first
    (which holds cuFFT's and the collectives' set-up)."""
    steps = len(tim_vals) - 1
    return {"steps_per_s": steps / tim_vals[-1],
            "steps_per_s_after_first": (steps - 1) / (tim_vals[-1]
                                                      - tim_vals[1])}


def run(b: np.ndarray, ranks: int = 4, steps: int = 3, seed: int = 0,
        shared: bool = False, log=print) -> dict:
    """The one-card run, then the R-rank mesh run from the same init, on
    the north star's images ``b`` (:func:`training_images`), and the
    record; ``rec["ok"]`` is False and ``rec["failures"]`` says why when
    a check fails."""
    import torch

    from ..ops import d_solve, fused_z, herm_inv, kernels
    from . import consensus, distributed

    if steps < 2:
        raise ValueError(f"steps={steps}: the rates need 2 or more")
    ns = NORTH_STAR
    geom, cfg = _problem(steps)
    kernels.build_all()  # before any timing; the ranks then load them
    tmp = tempfile.mkdtemp(prefix="ccsc-mesh-check-")
    try:
        fz = fused_z.fused_z_iter
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fz.launches_a = fz.launches_b = herm_inv.invert.launches = 0
        d_solve.solve.launches = 0
        t0 = time.perf_counter()
        ref = consensus.learn(
            b, geom, cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(seed),
        )
        ref_wall = time.perf_counter() - t0
        ref_launches = [fz.launches_a, fz.launches_b]
        ref_herm = herm_inv.invert.launches
        ref_ds = d_solve.solve.launches
        ref_peak = torch.cuda.max_memory_allocated()
        ref_path = os.path.join(tmp, "z.npy")
        np.save(ref_path, ref.z.cpu().numpy())
        ref_d, ref_tr = ref.d.cpu(), ref.trace
        del ref
        torch.cuda.empty_cache()
        log(f"one card: {steps} steps in {ref_wall:.2f} s, peak "
            f"{ref_peak / 2**30:.2f} GiB")
        t0 = time.perf_counter()
        outs = distributed.launch(
            _mesh_rank, ranks, args=(b, steps, seed, ref_path, shared),
            device="cuda:0" if shared else "cuda",
            backend="gloo" if shared else None, threads=None,
            timeout=300.0, join_timeout=900.0,
        )
        mesh_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = outs[0]
    tr = r0["trace"]
    d_err = float((r0["d"] - ref_d).abs().max())
    trace_rel = max(
        float(np.max(np.abs(np.subtract(tr[key], ref_tr[key]))
                     / np.maximum(np.abs(ref_tr[key]), 1e-30)))
        for key in ("obj_vals_d", "obj_vals_z")
    )
    want = cfg.max_it_z * steps
    want_ds = cfg.max_it_d * steps  # one call for the local blocks
    z_lim = D_ATOL * max(1.0, r0["z_max_abs"])
    cons = [m for o in outs for m in o["consensus_ms"]]
    rec = {
        "ranks": ranks, "backend": "gloo" if shared else "nccl",
        "shared_card": shared, "steps": steps,
        "n": int(b.shape[0]), "side": int(b.shape[-1]), "k": ns["k"],
        "support": ns["support"], "blocks": ns["blocks"],
        "blocks_per_rank": r0["local_blocks"],
        "one_card": {
            "wall_s": ref_wall, "launches": ref_launches,
            "herm_inv_launches": ref_herm, "d_solve_launches": ref_ds,
            **_steps_per_s(ref_tr["tim_vals"]),
            "d_pass_ms": ref_tr.get("d_pass_ms"),
            "z_pass_ms": ref_tr.get("z_pass_ms"), "peak_bytes": ref_peak,
        },
        "mesh": {
            "wall_s_with_spawn": mesh_wall, **_steps_per_s(tr["tim_vals"]),
            "per_rank": [{
                "rank": o["rank"], "device": o["device"],
                "launches": o["launches"],
                "herm_inv_launches": o["herm_inv_launches"],
                "d_solve_launches": o["d_solve_launches"],
                "peak_bytes": o["peak_bytes"],
                "d_pass_ms": o["trace"]["d_pass_ms"],
                "z_pass_ms": o["trace"]["z_pass_ms"],
                "consensus_ms_median": float(np.median(o["consensus_ms"])),
            } for o in outs],
            "consensus_allreduce_ms_per_d_iter": {
                "median": float(np.median(cons)), "max": float(np.max(cons)),
                "count_per_rank": len(r0["consensus_ms"]),
            },
        },
        "d_max_abs_err": d_err, "trace_max_rel_err": trace_rel,
        "z_max_abs_err": r0["z_max_abs_err"], "z_max_abs": r0["z_max_abs"],
        "z_limit": z_lim,
    }
    bad = []
    if ref_launches != [want, want]:
        bad.append(f"one-card K2 launches {ref_launches}, want {want}")
    if ref_herm != steps:
        bad.append(f"one-card Gram-inverse launches {ref_herm}, want "
                   f"{steps}")
    if ref_ds != want_ds:
        bad.append(f"one-card d-solve launches {ref_ds}, want {want_ds}")
    for o in outs:
        if o["launches"] != [want, want]:
            bad.append(f"rank {o['rank']} K2 launches {o['launches']}, "
                       f"want {want} each")
        if o["herm_inv_launches"] != steps:
            bad.append(f"rank {o['rank']} Gram-inverse launches "
                       f"{o['herm_inv_launches']}, want {steps}")
        if o["d_solve_launches"] != want_ds:
            bad.append(f"rank {o['rank']} d-solve launches "
                       f"{o['d_solve_launches']}, want {want_ds}")
    if not d_err <= D_ATOL:
        bad.append(f"filters {d_err:.3e} from the one-card run")
    if not trace_rel <= TRACE_RTOL:
        bad.append(f"objective traces {trace_rel:.3e} (rel) apart")
    if not r0["z_max_abs_err"] <= z_lim:
        bad.append(f"codes {r0['z_max_abs_err']:.3e} > {z_lim:.3e}")
    if len(r0["consensus_ms"]) != cfg.max_it_d * steps:
        bad.append(f"{len(r0['consensus_ms'])} consensus all-reduces, "
                   f"want {cfg.max_it_d * steps}")
    rec["ok"] = not bad
    rec["failures"] = bad
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mesh_check: CUDA is not available", file=sys.stderr)
        return 2
    from ..serve.bench import card_line

    ns = NORTH_STAR
    b = training_images(args.seed, ns["blocks"] * ns["ni"], ns["side"])
    rec = run(b, ranks=args.ranks, steps=args.steps, seed=args.seed)
    rec["card"] = card_line()
    rec["device_count"] = torch.cuda.device_count()
    print(json.dumps({"mesh_check": rec}))
    if not rec["ok"]:
        print("mesh_check FAILED: " + "; ".join(rec["failures"]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
