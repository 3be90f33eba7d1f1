"""2D Poisson-noise deconvolution app (torch port of
``ccsc_code_iccv2017_tpu.apps.poisson_2d``).

Protocol (reconstruct_poisson_noise.m): load a list of images (a
folder, a .mat stack or one file) -> rescale each to [1, peak] photons
and draw Poisson counts -> Poisson coding with an appended dirac
channel that is gradient-regularized and not sparsified
(lambda_res=2e4, lambda=1, lambda_smooth=0.5, max_it=50, tol=1e-4,
gamma 20/5), recon clamped >= 0 -> un-rescaled by the known peak ->
PSNR beside the noisy input's. Each image is its own solve; on the card
each iteration's z-solve is one launch of the kernel K1.

    python -m ccsc_code_iccv2017_torch.apps.poisson_2d --data DIR \\
        --filters artifacts_2d/learned_bank.mat
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ._common import (
        add_device_arg, add_mat_layout_arg, add_obs_args, add_perf_args,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="image folder")
    p.add_argument("--filters", required=True)
    p.add_argument("--peak", type=float, default=1000.0, help="photon peak")
    p.add_argument("--lambda-residual", type=float, default=20000.0)
    p.add_argument("--lambda-prior", type=float, default=1.0)
    p.add_argument("--lambda-smooth", type=float, default=0.5)
    p.add_argument("--max-it", type=int, default=50)
    add_perf_args(p)
    add_obs_args(p)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    add_mat_layout_arg(p)
    add_device_arg(p)
    return p


def run(args: argparse.Namespace):
    """The app on parsed arguments: returns an ``AppRun`` whose result
    is the list of per-image ReconResults, with the mean PSNR and the
    mean noisy-input PSNR."""
    from ..config import ProblemGeom, SolveConfig
    from ..data.images import load_image_list
    from ..models.reconstruct import ReconstructionProblem, reconstruct
    from ..utils import validate
    from ..utils.io_mat import load_filters_2d
    from ._common import AppRun

    d = load_filters_2d(args.filters)
    imgs = load_image_list(args.data, limit=args.limit,
                           mat_layout=args.mat_layout)
    rng = np.random.default_rng(args.seed)

    geom = ProblemGeom(d.shape[1:], d.shape[0])
    # fail on garbage inputs HERE, with the file/flag named
    validate.check_filters(d, geom)
    for i, x in enumerate(imgs):
        validate.check_finite(f"data image {i}", x)
    prob = ReconstructionProblem(
        geom,
        data_term="poisson",
        dirac="append",
        grad_reg_dirac=True,
        sparsify_dirac=False,
        clamp_nonneg=True,
    )
    cfg = SolveConfig(
        metrics_dir=args.metrics_dir,
        lambda_residual=args.lambda_residual,
        lambda_prior=args.lambda_prior,
        lambda_smooth=args.lambda_smooth,
        max_it=args.max_it,
        tol=args.tol,
        fft_pad=args.fft_pad,
        fft_impl=args.fft_impl,
        tune=args.tune,
        gamma_factor=20.0,
        gamma_ratio=5.0,
    )

    psnrs, noisy_psnrs, results = [], [], []
    for i, x in enumerate(imgs):
        if args.size:
            from PIL import Image

            x = np.asarray(
                Image.fromarray(x).resize(
                    (args.size, args.size), Image.BILINEAR
                )
            )
        # rescale to [1, peak] photons and draw Poisson counts
        lo, hi = x.min(), x.max()
        scale = (x - lo) / max(hi - lo, 1e-9) * (args.peak - 1.0) + 1.0
        obs = rng.poisson(scale).astype(np.float32)
        res = reconstruct(
            obs[None],
            d,
            prob,
            cfg,
            mask=np.ones((1, *obs.shape), np.float32),
            x_orig=scale[None].astype(np.float32),
            device=args.device,
        )
        rec = res.recon[0].cpu().numpy()
        # un-rescale by the known peak
        rec01 = (rec - 1.0) / (args.peak - 1.0) * max(hi - lo, 1e-9) + lo
        mse = np.mean((np.clip(rec01, 0, 1) - x) ** 2)
        p = 10 * np.log10(1.0 / max(mse, 1e-12))
        noisy = np.mean((obs - scale) ** 2)
        p_noisy = 10 * np.log10(args.peak**2 / max(noisy, 1e-12))
        psnrs.append(p)
        noisy_psnrs.append(p_noisy)
        results.append(res)
        print(
            f"image {i}: PSNR {p:.2f} dB (noisy input {p_noisy:.2f} dB), "
            f"{int(res.trace.num_iters)} iterations"
        )
    print(f"mean PSNR {np.mean(psnrs):.2f} dB over {len(psnrs)} images")
    return AppRun(
        results, float(np.mean(psnrs)), float(np.mean(noisy_psnrs)),
        sum(int(r.trace.num_iters) for r in results),
    )


def main(argv=None):
    """Returns the per-image ReconResults, in image order."""
    return run(build_parser().parse_args(argv)).result


if __name__ == "__main__":
    main()
