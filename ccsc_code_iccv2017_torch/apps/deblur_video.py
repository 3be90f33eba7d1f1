"""Video deblurring (torch port of
``ccsc_code_iccv2017_tpu.apps.deblur_video``).

Protocol (reconstruct_subsampling_video.m): a clip (a movie file, or a
synthetic drifting-texture clip from ``--seed``) blurred circularly by
a 3x3x3 temporal-band PSF -> per-frame mean/std normalization -> coding
with the 3D bank, the blur OTF composed into the solve operator and a
prepended dirac channel (lambda_res=1e4, lambda=1/8, max_it=120,
tol=1e-6, gamma 500/1) -> un-normalized, MSE beside the blurred clip's.
The problem is W == 1 over a 3D spectrum: on the card each iteration's
z-solve is one launch of the kernel K1.

    python -m ccsc_code_iccv2017_torch.apps.deblur_video --synthetic \\
        --filters artifacts_family_cpu/bank_3d.mat
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ._common import add_device_arg, add_obs_args, add_perf_args

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--movie", help="mp4/avi input")
    src.add_argument("--synthetic", action="store_true")
    p.add_argument("--filters", required=True, help="3D filter .mat")
    p.add_argument("--psf", default=None, help="grayscale PSF image (snake.png role)")
    p.add_argument("--side", type=int, default=48)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--lambda-residual", type=float, default=10000.0)
    p.add_argument("--lambda-prior", type=float, default=0.125)
    p.add_argument("--max-it", type=int, default=120)
    add_perf_args(p)
    add_obs_args(p)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    return p


def build_psf(psf_img: np.ndarray | None) -> np.ndarray:
    """3x3x3 PSF with the spatial blur in the temporal band
    (reconstruct_subsampling_video.m:28-33). Without a source image,
    use a normalized 3x3 box in each temporal slice weighted 1/4,1/2,1/4.
    """
    if psf_img is not None:
        s = np.asarray(psf_img, np.float32)
        s = s / max(s.sum(), 1e-9)
        # downsample to 3x3
        import cv2

        sp = cv2.resize(s, (3, 3), interpolation=cv2.INTER_AREA)
    else:
        sp = np.ones((3, 3), np.float32)
    sp = sp / max(sp.sum(), 1e-9)
    w = np.array([0.25, 0.5, 0.25], np.float32)
    psf = np.einsum("xy,t->xyt", sp, w)
    return psf / psf.sum()


def run(args: argparse.Namespace):
    """The app on parsed arguments: returns an ``AppRun`` with the
    ReconResult and the PSNRs of the deblurred and the blurred clip
    against the sharp one, peak = the sharp clip's range."""
    from scipy.ndimage import convolve

    from ..config import ProblemGeom, SolveConfig
    from ..data import volumes
    from ..models.reconstruct import ReconstructionProblem, reconstruct
    from ..utils import validate
    from ..utils.io_mat import load_filters_3d
    from ._common import AppRun, refuse_unported

    refuse_unported(args)
    d = load_filters_3d(args.filters)
    if args.synthetic:
        clip = volumes.synthetic_video(
            n=1, side=args.side, frames=args.frames, seed=args.seed
        )[0]
    else:
        clip = volumes.extract_movie(args.movie, side=args.side)[
            :, :, : args.frames
        ]

    psf_img = None
    if args.psf:
        from PIL import Image

        psf_img = np.asarray(Image.open(args.psf).convert("L"), np.float32)
    psf = build_psf(psf_img)

    # blur the clip with the PSF (circular, matching the solve operator)
    blurred = convolve(clip, psf, mode="wrap").astype(np.float32)

    # per-frame mean/std normalization
    mu = blurred.mean(axis=(0, 1), keepdims=True)
    sd = blurred.std(axis=(0, 1), keepdims=True) + 1e-6
    bn = (blurred - mu) / sd

    geom = ProblemGeom(d.shape[1:], d.shape[0])
    # fail on garbage inputs HERE, with the file/flag named
    validate.check_solve_data(bn[None], d, geom)
    validate.check_finite("psf", psf)
    prob = ReconstructionProblem(geom, dirac="prepend")
    cfg = SolveConfig(
        metrics_dir=args.metrics_dir,
        lambda_residual=args.lambda_residual,
        lambda_prior=args.lambda_prior,
        max_it=args.max_it,
        tol=args.tol,
        fft_pad=args.fft_pad,
        fft_impl=args.fft_impl,
        tune=args.tune,
        gamma_factor=500.0,
        gamma_ratio=1.0,
    )
    res = reconstruct(
        bn[None],
        d,
        prob,
        cfg,
        blur_psf=psf,
        x_orig=((clip - mu) / sd)[None],
        device=args.device,
    )
    rec = res.recon[0].cpu().numpy() * sd + mu  # un-normalize
    err_rec = np.mean((rec - clip) ** 2)
    err_blur = np.mean((blurred - clip) ** 2)
    print(
        f"{int(res.trace.num_iters)} iterations; MSE deblurred "
        f"{err_rec:.3e} vs blurred {err_blur:.3e}"
    )
    peak2 = float(clip.max() - clip.min()) ** 2
    return AppRun(
        res,
        float(10 * np.log10(peak2 / max(err_rec, 1e-30))),
        float(10 * np.log10(peak2 / max(err_blur, 1e-30))),
        int(res.trace.num_iters),
    )


def main(argv=None):
    """Returns the ReconResult (the normalized clip's reconstruction)."""
    return run(build_parser().parse_args(argv)).result


if __name__ == "__main__":
    main()
