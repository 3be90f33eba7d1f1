"""Hyperspectral demosaicing (torch port of
``ccsc_code_iccv2017_tpu.apps.demosaic_hyperspectral``).

Protocol (reconstruct_subsampling_hyperspectral.m): a spatial-spectral
mosaic mask on a ceil(sqrt(bands)) grid, each pixel observing one band
-> per-band nearest-neighbor fill + Gaussian lowpass as the smooth
offset -> masked coding with (band x spatial) filters sharing 2D code
maps (W = bands, the Woodbury z-solve), lambda_res=1e5, max_it=200,
tol=1e-4, NO padding -> PSNR beside the smooth fill's.

The cube is a band-image folder, a .mat with variable 'b' [x y w], or a
synthetic cube from ``--seed``; ``--side`` (default 48, the JAX app's
fixed size) sets the synthetic cube's width, a flag the JAX CLI lacks.

    python -m ccsc_code_iccv2017_torch.apps.demosaic_hyperspectral \\
        --synthetic --filters artifacts_family_cpu/bank_hs.mat
"""
from __future__ import annotations

import argparse
import math

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ._common import add_device_arg, add_obs_args, add_perf_args

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--data", help="folder of band images")
    src.add_argument("--mat", help=".mat with variable 'b' [x y w]")
    src.add_argument("--synthetic", action="store_true")
    p.add_argument("--filters", required=True, help="hyperspectral filter .mat")
    p.add_argument("--bands", type=int, default=31)
    p.add_argument("--lambda-residual", type=float, default=100000.0)
    p.add_argument("--lambda-prior", type=float, default=1.0)
    p.add_argument("--max-it", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--side", type=int, default=48,
                   help="side of the --synthetic cube")
    add_perf_args(p, fft_pad=False)
    add_obs_args(p)
    add_device_arg(p)
    return p


def mosaic_mask(bands: int, side_x: int, side_y: int) -> np.ndarray:
    """Spatial-spectral mosaic: tile a ceil(sqrt(bands))-square grid of
    band assignments over the image (reconstruct_subsampling_
    hyperspectral.m:21-30). Each pixel observes exactly one band."""
    sb = int(math.ceil(math.sqrt(bands)))
    assign = (np.arange(sb * sb) % bands).reshape(sb, sb)
    mask = np.zeros((bands, side_x, side_y), np.float32)
    for i in range(side_x):
        for j in range(side_y):
            mask[assign[i % sb, j % sb], i, j] = 1.0
    return mask


def nn_fill_smooth_init(
    b: np.ndarray, mask: np.ndarray, sigma: float = 4.773
) -> np.ndarray:
    """Per-band nearest-neighbor fill of unobserved pixels followed by
    a Gaussian lowpass (:46-55)."""
    from scipy.ndimage import distance_transform_edt, gaussian_filter

    out = np.empty_like(b)
    for w in range(b.shape[0]):
        m = mask[w] > 0
        if m.any():
            _, (ix, iy) = distance_transform_edt(
                ~m, return_indices=True
            )
            filled = b[w][ix, iy]
        else:
            filled = b[w]
        out[w] = gaussian_filter(filled, sigma, mode="nearest")
    return out


def run(args: argparse.Namespace):
    """The app on parsed arguments: returns an ``AppRun`` with the
    ReconResult, its PSNR and the smooth fill's."""
    from ..config import ProblemGeom, SolveConfig
    from ..data import volumes
    from ..models.reconstruct import ReconstructionProblem, reconstruct
    from ..utils import validate
    from ..utils.io_mat import _loadmat, load_filters_hyperspectral
    from ._common import AppRun

    d = load_filters_hyperspectral(args.filters)
    k, bands = d.shape[0], d.shape[1]

    if args.synthetic:
        cube = volumes.synthetic_hyperspectral(
            n=1, bands=bands, side=args.side, seed=args.seed
        )[0]
    elif args.mat:
        cube = np.transpose(_loadmat(args.mat)["b"], (2, 0, 1)).astype(
            np.float32
        )
    else:
        cube = volumes.load_hyperspectral_dir(args.data, bands=bands)[0]
    print(f"cube: {cube.shape}")

    mask = mosaic_mask(bands, cube.shape[1], cube.shape[2])
    sm = nn_fill_smooth_init(cube * mask, mask)

    geom = ProblemGeom(d.shape[2:], k, (bands,))
    # fail on garbage inputs HERE, with the file/flag named
    validate.check_solve_data(
        (cube * mask)[None], d, geom, mask=mask[None],
        smooth_init=sm[None],
    )
    prob = ReconstructionProblem(geom, pad=False)
    cfg = SolveConfig(
        metrics_dir=args.metrics_dir,
        fft_impl=args.fft_impl,
        tune=args.tune,
        lambda_residual=args.lambda_residual,
        lambda_prior=args.lambda_prior,
        max_it=args.max_it,
        tol=args.tol,
    )
    res = reconstruct(
        (cube * mask)[None],
        d,
        prob,
        cfg,
        mask=mask[None],
        smooth_init=sm[None],
        x_orig=cube[None],
        device=args.device,
    )
    ni = int(res.trace.num_iters)
    psnr = float(res.trace.psnr_vals[ni])
    base = 10 * np.log10(1.0 / max(np.mean((sm - cube) ** 2), 1e-12))
    print(
        f"{ni} iterations, PSNR {psnr:.2f} dB "
        f"(smooth-init baseline {base:.2f} dB)"
    )
    return AppRun(res, psnr, float(base), ni)


def main(argv=None):
    """Returns the ReconResult."""
    return run(build_parser().parse_args(argv)).result


if __name__ == "__main__":
    main()
