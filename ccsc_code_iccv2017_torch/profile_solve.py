"""Where one served request's time goes on the card.

    python -m ccsc_code_iccv2017_torch.profile_solve [--size 256] [--max-it 20]

Builds a plan for the repo's k=100 11x11 bank, warms up once, then
profiles one inpainting request (a Gaussian-smoothed noise image from
``--seed``, 50% mask, smooth-fill warm start) with ``torch.profiler``.
Prints the device kernels ranked by their summed time and, as its last
line, one JSON object with the wall time, the device-busy share
(summed kernel time over wall time) and the top kernels.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .config import ProblemGeom, SolveConfig
from .data.images import smooth_fill_batch, smooth_noise_images
from .models.reconstruct import ReconstructionProblem, build_plan, reconstruct
from .utils.device import resolve_device
from .utils.io_mat import load_filters_2d

BANK = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts_2d", "learned_bank.mat",
)


def _request(size, seed):
    rng = np.random.default_rng(seed)
    x = smooth_noise_images(rng, 1, size)
    mask = (rng.random(x.shape) < 0.5).astype(np.float32)
    return x, mask, smooth_fill_batch(x, mask)


def _device_us(evt) -> float:
    # the attribute was renamed across torch versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--max-it", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")

    d = load_filters_2d(BANK)
    x, mask, sm = _request(args.size, args.seed)
    prob = ReconstructionProblem(ProblemGeom(d.shape[1:], d.shape[0]))
    cfg = SolveConfig(max_it=args.max_it, tol=0.0)
    plan = build_plan(d, prob, cfg, x.shape[1:], device=dev)

    def solve():
        res = reconstruct(x * mask, d, prob, cfg, mask=mask, smooth_init=sm,
                          x_orig=x, plan=plan, device=dev)
        torch.cuda.synchronize()
        return res

    solve()  # warm cuFFT plans and the allocator
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = solve()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only: the aten ops that launched them would
    # count the same kernel time a second time
    rows = sorted(
        ((e.key, _device_us(e), e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and _device_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_us = sum(r[1] for r in rows)
    it = int(res.trace.num_iters)
    print(f"{it} iterations, wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%)")
    for key, us, count in rows[: args.top]:
        print(f"{us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}% "
              f"x{count:<5d} {key[:90]}")
    out = {
        "device": torch.cuda.get_device_name(dev), "size": args.size,
        "iters": it, "wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / wall_us,
        "top": [{"kernel": k[:120], "ms": us / 1e3, "count": c}
                for k, us, c in rows[: args.top]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
