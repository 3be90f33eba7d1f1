"""Lightfield view synthesis (torch port of
``ccsc_code_iccv2017_tpu.apps.view_synthesis``).

Protocol (reconstruct_subsampling_lightfield.m): observe only the border
views of the angular grid (the interior views are blocked) -> warm-fill
the interior by bilinear view interpolation -> masked coding with 4D
filters whose views play the role of the demosaic solver's bands
(W = views, the Woodbury z-solve), lambda_res=1e4, max_it=200,
tol=1e-4, no padding -> interior-view PSNR beside the interpolation's.

    python -m ccsc_code_iccv2017_torch.apps.view_synthesis --synthetic \\
        --filters artifacts_family_cpu/bank_4d.mat
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ._common import add_device_arg, add_obs_args, add_perf_args

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--mat", help=".mat with lightfield")
    src.add_argument("--synthetic", action="store_true")
    p.add_argument("--filters", required=True, help="4D filter .mat")
    p.add_argument("--side", type=int, default=64)
    p.add_argument("--lambda-residual", type=float, default=10000.0)
    p.add_argument("--lambda-prior", type=float, default=1.0)
    p.add_argument("--max-it", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    add_perf_args(p, fft_pad=False)
    add_obs_args(p)
    add_device_arg(p)
    return p


def border_view_mask(views: tuple, spatial: tuple) -> np.ndarray:
    """Observe border views only; block the interior
    (reconstruct_subsampling_lightfield.m:29-34)."""
    a1, a2 = views
    m = np.zeros((a1, a2, *spatial), np.float32)
    for u in range(a1):
        for v in range(a2):
            if u in (0, a1 - 1) or v in (0, a2 - 1):
                m[u, v] = 1.0
    return m


def interp_fill(lf_obs: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Bilinear interpolation of interior views from the border
    (:48-52): each unobserved view is a weighted blend of the corner
    views along the angular axes."""
    a1, a2 = lf_obs.shape[:2]
    out = lf_obs.copy()
    for u in range(a1):
        for v in range(a2):
            if mask[u, v].max() > 0:
                continue
            wu = u / (a1 - 1)
            wv = v / (a2 - 1)
            out[u, v] = (
                (1 - wu) * (1 - wv) * lf_obs[0, 0]
                + (1 - wu) * wv * lf_obs[0, a2 - 1]
                + wu * (1 - wv) * lf_obs[a1 - 1, 0]
                + wu * wv * lf_obs[a1 - 1, a2 - 1]
            )
    return out


def run(args: argparse.Namespace):
    """The app on parsed arguments: returns an ``AppRun`` with the
    ReconResult and the interior views' PSNR beside the
    interpolation's."""
    from ..config import ProblemGeom, SolveConfig
    from ..data import volumes
    from ..models.reconstruct import ReconstructionProblem, reconstruct
    from ..utils import validate
    from ..utils.io_mat import _loadmat, load_filters_lightfield
    from ._common import AppRun

    d = load_filters_lightfield(args.filters)
    k, a1, a2 = d.shape[0], d.shape[1], d.shape[2]

    if args.synthetic:
        lf = volumes.synthetic_lightfield(views=a1, side=args.side,
                                          seed=args.seed)
    else:
        arrs = [
            v
            for v in _loadmat(args.mat).values()
            if hasattr(v, "ndim") and v.ndim == 4
        ]
        lf = arrs[0].astype(np.float32)
        if lf.shape[0] > lf.shape[2]:
            lf = np.transpose(lf, (2, 3, 0, 1))
    print(f"lightfield: {lf.shape}")

    mask = border_view_mask((a1, a2), lf.shape[2:])
    sm = interp_fill(lf * mask, mask)

    geom = ProblemGeom(d.shape[3:], k, (a1, a2))
    # fail on garbage inputs HERE, with the file/flag named
    validate.check_solve_data(
        (lf * mask)[None], d, geom, mask=mask[None], smooth_init=sm[None]
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
        (lf * mask)[None],
        d,
        prob,
        cfg,
        mask=mask[None],
        smooth_init=sm[None],
        x_orig=lf[None],
        device=args.device,
    )
    ni = int(res.trace.num_iters)
    rec = res.recon[0].cpu().numpy()
    interior = mask.max(axis=(2, 3)) == 0
    mse_rec = np.mean((rec[interior] - lf[interior]) ** 2)
    mse_warm = np.mean((sm[interior] - lf[interior]) ** 2)
    psnr = 10 * np.log10(1 / max(mse_rec, 1e-12))
    base = 10 * np.log10(1 / max(mse_warm, 1e-12))
    print(
        f"{ni} iterations; interior-view PSNR {psnr:.2f} dB "
        f"(interp baseline {base:.2f} dB)"
    )
    return AppRun(res, float(psnr), float(base), ni)


def main(argv=None):
    """Returns the ReconResult."""
    return run(build_parser().parse_args(argv)).result


if __name__ == "__main__":
    main()
