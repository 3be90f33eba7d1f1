#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; nothing catches it, so a failed phase
never exits 0):

1. Environment: the card's name and power limit (nvidia-smi), the
   device name and compute capability, which must be (9, 0).
2. Build: K1 (``ccsc_code_iccv2017_torch/csrc/solve_z_rank1.cu``) from
   this checkout's sources with nvcc, timed.
3. Kernel vs plain: K1 against its plain torch version on the card at
   the slice's full shapes (K=100, F=266*134, N in {1, 4}; dinv = 1/rho
   and with one raised row as the Poisson dirac regularization makes
   it), max|dz|/max|z| <= 1e-5; kernel, plain-version and bound times.
4. The slice serves requests: the repo's k=100 11x11 bank, 4 synthetic
   256x256 images (Gaussian-smoothed noise from --seed), 50% masks and
   the smooth-fill warm start, one ``build_plan``, then 4 requests
   through ``reconstruct(plan=...)`` at max_it=100, tol=1e-3. K1's
   launch count is set to 0 just before and must grow by exactly the
   iterations served.
5. Card vs CPU: request 0 at max_it=10, tol=0 on both devices; the
   objective traces agree to rtol 1e-4 and the reconstructions to
   1e-4 * max|b|.
6. Output: a ``{"kernels": [...]}`` line, a ``{"slice": ...}`` line,
   the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when CUDA is absent or the
port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "ccsc_code_iccv2017_torch"
BANK = os.path.join(HERE, "artifacts_2d", "learned_bank.mat")

# Datasheet memory bandwidth (bytes/s) and float32 non-tensor-core peak
# (flop/s) by card name (NVIDIA H100/H200 data sheets). The more
# specific names come first.
DATASHEET = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),  # SXM5, "NVIDIA H100 80GB HBM3"
)

K, S, R = 100, 256, 5  # filters, image side, psf radius of the 11x11 bank
F = (S + 2 * R) * ((S + 2 * R) // 2 + 1)  # 266 * 134 rfft bins
RHO = 100.0  # SolveConfig.gamma_ratio: the z-solve's coupling constant


def _datasheet(name: str):
    for key, bw, flops in DATASHEET:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no datasheet bandwidth for card {name!r}")


def _time_ms(torch, fn, warmup=5, reps=30) -> float:
    """Median CUDA-event time of one call, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_environment(torch, device_report):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    rep = device_report("cuda:0")
    print(f"[1] nvidia-smi: {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {rep['name']}, capability {rep['capability']}, "
          f"{rep['sm_count']} SMs, {torch.cuda.device_count()} device(s)")
    if tuple(rep["capability"]) != (9, 0):
        raise RuntimeError(
            f"expected a Hopper card (9, 0), got {rep['capability']}"
        )
    return smi, rep["name"]


def phase_build(kernels):
    info = kernels.build()
    print(f"[2] K1 built in {info['seconds']:.2f} s "
          f"(compiled={info['compiled']}): {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2]   {line.strip()}")
    return info


def phase_kernel_vs_plain(torch, kernels, bw, flops, seed):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def cplx(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev),
        )

    cases = []
    for n in (1, 4):
        for raised in (False, True):
            dhat, xi1, xi2 = cplx(K, F), cplx(n, F), cplx(n, K, F)
            gamma = torch.full((K, F), RHO, device=dev)
            if raised:  # the dirac row's gradient regularization
                gamma[K - 1] += 4.0 * torch.rand(F, generator=gen, device=dev)
            dinv = 1.0 / gamma
            args = (dhat, xi1, xi2, RHO, dinv)
            z = kernels.solve_z_rank1(*args)
            torch.cuda.synchronize()
            ref = kernels.solve_z_rank1_reference(*args)
            abs_err = float((z - ref).abs().max())
            rel_err = abs_err / float(ref.abs().max())
            if not rel_err <= 1e-5:
                raise RuntimeError(
                    f"K1 disagrees with its plain version: N={n} "
                    f"raised={raised} max|dz|/max|z|={rel_err:.3e}"
                )
            kernel_ms = _time_ms(torch, lambda: kernels.solve_z_rank1(*args))
            plain_ms = _time_ms(
                torch, lambda: kernels.solve_z_rank1_reference(*args)
            )
            # each input read once, the output written once
            nbytes = (K * (12 + 16 * n) + 8 * n) * F
            # ~35 real operations per (n, k, f) and 4 per (n, f)
            nops = n * F * (35 * K + 4)
            bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / flops
            case = {
                "n": n, "raised_row": raised, "max_abs_err": abs_err,
                "max_rel_err": rel_err, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes,
            }
            print(f"[3] K1 N={n} raised={raised}: rel err {rel_err:.2e}, "
                  f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
            cases.append(case)
            del dhat, xi1, xi2, gamma, dinv, args, z, ref
    return cases


def _images(port, seed):
    """4 synthetic 256x256 images in [0, 1] (Gaussian-smoothed noise)
    and their 50% masks."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = port["images"].smooth_noise_images(rng, 4, S)
    mask = (rng.random(b.shape) < 0.5).astype(np.float32)
    return b, mask


def phase_serve(torch, port, seed):
    import numpy as np

    cfg_kw = dict(lambda_residual=5.0, lambda_prior=2.0, max_it=100,
                  tol=1e-3)
    d = port["io_mat"].load_filters_2d(BANK)
    b, mask = _images(port, seed)
    sm = port["images"].smooth_fill_batch(b, mask)
    rec = port["reconstruct"]
    prob = rec.ReconstructionProblem(port["config"].ProblemGeom((11, 11), K))
    cfg = port["config"].SolveConfig(**cfg_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = rec.build_plan(d, prob, cfg, (S, S), device="cuda")
    torch.cuda.synchronize()
    plan_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[4] build_plan: {plan_ms:.1f} ms, F={plan.fg.num_freq}")
    if plan.fg.num_freq != F:
        raise RuntimeError(f"plan has {plan.fg.num_freq} bins, expected {F}")

    def request(i, c=cfg):
        return rec.reconstruct(
            b[i:i + 1] * mask[i:i + 1], d, prob, c, mask=mask[i:i + 1],
            smooth_init=sm[i:i + 1], x_orig=b[i:i + 1], plan=plan,
            device="cuda",
        )

    # warm cuFFT plans and the allocator once, like a server's warmup
    request(0, dataclasses.replace(cfg, max_it=2))
    torch.cuda.synchronize()

    kernels = port["kernels"]
    kernels.solve_z_rank1.launches = 0
    served = []
    for i in range(b.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = request(i)
        recon = res.recon.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        it = int(res.trace.num_iters)
        if not np.isfinite(recon).all() or recon.shape != (1, S, S):
            raise RuntimeError(f"request {i}: bad recon {recon.shape}")
        served.append({
            "iters": it,
            "psnr_db": float(res.trace.psnr_vals[it]),
            "smooth_fill_psnr_db": float(port["common"].psnr(
                torch.from_numpy(sm[i]), torch.from_numpy(b[i]), (R, R)
            )),
            "latency_ms": ms,
        })
        print(f"[4] request {i}: {it} iterations, PSNR "
              f"{served[-1]['psnr_db']:.2f} dB (smooth fill "
              f"{served[-1]['smooth_fill_psnr_db']:.2f} dB), {ms:.1f} ms")
    launches = kernels.solve_z_rank1.launches
    total = sum(s["iters"] for s in served)
    if launches != total:
        raise RuntimeError(
            f"K1 launched {launches} times for {total} iterations served"
        )
    print(f"[4] K1 launches {launches} == iterations served {total}")
    return {"plan_ms": plan_ms, "requests": served, "launches": launches,
            "data": (b, mask, sm, d, prob, cfg_kw)}


def phase_card_vs_cpu(torch, port, data):
    import numpy as np

    b, mask, sm, d, prob, cfg_kw = data
    cfg = port["config"].SolveConfig(**dict(cfg_kw, max_it=10, tol=0.0))
    out = {}
    for dev in ("cuda", "cpu"):
        res = port["reconstruct"].reconstruct(
            b[:1] * mask[:1], d, prob, cfg, mask=mask[:1],
            smooth_init=sm[:1], x_orig=b[:1], device=dev,
        )
        out[dev] = (res.trace.obj_vals.cpu().numpy().astype(np.float64),
                    res.recon.cpu().numpy())
    obj_c, rec_c = out["cuda"]
    obj_p, rec_p = out["cpu"]
    obj_rel = float(np.max(np.abs(obj_c - obj_p) / np.abs(obj_p)))
    rec_abs = float(np.abs(rec_c - rec_p).max())
    b_max = float(np.abs(b[:1] * mask[:1]).max())
    print(f"[5] card vs CPU, 10 iterations: obj max rel diff {obj_rel:.2e}, "
          f"recon max abs diff {rec_abs:.2e} (b max {b_max:.3f})")
    if not obj_rel <= 1e-4:
        raise RuntimeError(f"objective traces differ: {obj_rel:.3e} > 1e-4")
    if not rec_abs <= 1e-4 * b_max:
        raise RuntimeError(
            f"reconstructions differ: {rec_abs:.3e} > 1e-4 * {b_max:.3f}"
        )
    return {"obj_max_rel_diff": obj_rel, "recon_max_abs_diff": rec_abs,
            "b_max": b_max}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script drives "
              "the port on an NVIDIA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script — run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    import importlib

    port = {
        name: importlib.import_module(f"{PACKAGE}.{mod}")
        for name, mod in (
            ("config", "config"), ("kernels", "ops.kernels"),
            ("reconstruct", "models.reconstruct"),
            ("common", "models.common"),
            ("io_mat", "utils.io_mat"), ("images", "data.images"),
            ("device", "utils.device"),
        )
    }
    t_start = time.perf_counter()
    smi, name = phase_environment(torch, port["device"].device_report)
    bw, flops = _datasheet(name)
    build = phase_build(port["kernels"])
    cases = phase_kernel_vs_plain(
        torch, port["kernels"], bw, flops, args.seed
    )
    served = phase_serve(torch, port, args.seed)
    agree = phase_card_vs_cpu(torch, port, served.pop("data"))

    main_case = next(c for c in cases if c["n"] == 1 and not c["raised_row"])
    kernels_line = {"kernels": [{
        "name": "solve_z_rank1",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/solve_z_rank1.cu",
        "replaces": "ccsc_code_iccv2017_tpu/ops/pallas_kernels.py:51",
        "launches": served["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err": max(c["max_rel_err"] for c in cases),
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "build_s": build["seconds"],
        "cases": cases,
    }]}
    print(json.dumps(kernels_line))
    print(json.dumps({"slice": dict(
        served, card_vs_cpu=agree,
        seconds=time.perf_counter() - t_start,
    )}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
