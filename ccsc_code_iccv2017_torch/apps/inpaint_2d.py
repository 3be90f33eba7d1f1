"""2D inpainting / subsampled reconstruction driver (torch port of
``ccsc_code_iccv2017_tpu.apps.inpaint_2d``).

Protocol: load images (a folder, a .mat stack or one file) -> random
mask keeping ``--keep`` of the pixels -> masked coding with a filter
bank (lambda_res=5.0, lambda=2.0, max_it=100, tol=1e-3) with a
normalized-convolution Gaussian fill of the observed pixels as the
smooth offset -> PSNR and optional 16-bit PNG outputs. Runs on
``--device`` (default cuda).

    python -m ccsc_code_iccv2017_torch.apps.inpaint_2d --data DIR \\
        --filters artifacts_2d/learned_bank.mat
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ._common import (
        add_device_arg, add_mat_layout_arg, add_obs_args, add_perf_args,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="test image folder")
    p.add_argument("--filters", required=True, help=".mat filter bank")
    p.add_argument("--keep", type=float, default=0.5, help="observed fraction")
    p.add_argument("--lambda-residual", type=float, default=5.0)
    p.add_argument("--lambda-prior", type=float, default=2.0)
    p.add_argument("--max-it", type=int, default=100)
    add_perf_args(p)
    add_obs_args(p)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--out-dir", default=None, help="write 16-bit PNGs here")
    p.add_argument("--seed", type=int, default=0)
    add_mat_layout_arg(p)
    add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..config import ProblemGeom, SolveConfig
    from ..data.images import load_images
    from ..data.native import smooth_fill_batch
    from ..models.reconstruct import ReconstructionProblem, reconstruct
    from ..utils import validate
    from ..utils.io_mat import load_filters_2d

    d = load_filters_2d(args.filters)
    size = (args.size, args.size) if args.size else None
    b = load_images(args.data, limit=args.limit, size=size,
                    mat_layout=args.mat_layout)
    rng = np.random.default_rng(args.seed)
    mask = (rng.random(b.shape) < args.keep).astype(np.float32)
    sm = smooth_fill_batch(b, mask)

    geom = ProblemGeom(d.shape[1:], d.shape[0])
    # fail on garbage inputs HERE, with the file/flag named
    validate.check_solve_data(b, d, geom, mask=mask, smooth_init=sm)
    cfg = SolveConfig(
        metrics_dir=args.metrics_dir,
        lambda_residual=args.lambda_residual,
        lambda_prior=args.lambda_prior,
        max_it=args.max_it,
        tol=args.tol,
        fft_pad=args.fft_pad,
        fft_impl=args.fft_impl,
        tune=args.tune,
    )
    res = reconstruct(
        b * mask,
        d,
        ReconstructionProblem(geom),
        cfg,
        mask=mask,
        smooth_init=sm,
        x_orig=b,
        device=args.device,
    )
    ni = int(res.trace.num_iters)
    psnr = float(res.trace.psnr_vals[ni])
    print(f"{b.shape[0]} images, {ni} iterations, PSNR {psnr:.2f} dB")

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        from PIL import Image

        rec = np.clip(res.recon.cpu().numpy(), 0.0, 1.0)
        for i in range(rec.shape[0]):
            # 16-bit PNG outputs like the reference
            arr = (rec[i] * 65535.0).astype(np.uint16)
            Image.fromarray(arr).save(
                os.path.join(args.out_dir, f"recon_{i}.png")
            )
        print(f"wrote {rec.shape[0]} PNGs to {args.out_dir}")
    return res


if __name__ == "__main__":
    main()
