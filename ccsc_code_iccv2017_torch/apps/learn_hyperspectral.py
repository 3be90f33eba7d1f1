"""Hyperspectral dictionary learning (torch port of
``ccsc_code_iccv2017_tpu.apps.learn_hyperspectral``, the single-device
masked path).

Reference protocol: training cubes -> Gaussian smooth_init (imfilter,
learn_hyperspectral.m:16-17) -> masked ADMM learner with kernel
[11,11,31,100], max_it=40, tol=1e-3 (:30) -> save. The z-solve is the
W = 31 Woodbury solve. The training_data.mat blob is absent:
``--synthetic`` generates demo cubes, ``--mat`` reads a variable 'b'
[x y w n]. ``--streaming`` learns with the consensus streaming learner
on the offset-subtracted cubes instead (parallel.streaming, in
``--streaming-blocks`` blocks; Dz gets the offset back). Runs on
``--device`` (default cuda).

    python -m ccsc_code_iccv2017_torch.apps.learn_hyperspectral \\
        --synthetic [--limit 4 --out f.mat]
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ._common import add_learner_args

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--data", help="folder of band images (groups of --bands)")
    src.add_argument("--mat", help=".mat with variable 'b' [x y w n]")
    src.add_argument("--synthetic", action="store_true")
    p.add_argument("--bands", type=int, default=31)
    p.add_argument("--filters", type=int, default=100)
    p.add_argument("--support", type=int, default=11)
    p.add_argument("--max-it", type=int, default=40)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default="hyperspectral_filters.mat")
    p.add_argument("--init", default=None, help="warm-start filter .mat")
    p.add_argument(
        "--streaming", action="store_true",
        help="host-streaming mode: bounded device memory through the "
        "consensus streaming learner on offset-subtracted cubes. "
        "DIVERGENCE: the consensus objective (zero-padded border "
        "residual) instead of the masked-boundary ADMM, whose n x n "
        "Woodbury inner system couples all images and cannot stream "
        "(admm_learn.m:273-300)",
    )
    p.add_argument("--streaming-blocks", type=int, default=4,
                   help="consensus blocks of --streaming (shrunk to the "
                   "largest divisor of n not above it)")
    add_learner_args(p, masked_carry=True, d_storage=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", default="brief",
                   choices=["none", "brief", "all"])
    return p


def gaussian_smooth_init(b: np.ndarray, sigma: float = 4.773) -> np.ndarray:
    """Per-band Gaussian lowpass (learn_hyperspectral.m:16-17)."""
    from scipy.ndimage import gaussian_filter

    out = np.empty_like(b)
    for n in range(b.shape[0]):
        for w in range(b.shape[1]):
            out[n, w] = gaussian_filter(b[n, w], sigma, mode="nearest")
    return out


def load_data(args: argparse.Namespace) -> np.ndarray:
    """The training cubes [n, bands, X, Y] the arguments name."""
    from ..data import volumes

    if args.synthetic:
        return volumes.synthetic_hyperspectral(
            n=args.limit or 4, bands=args.bands, seed=args.seed
        )
    if args.mat:
        from ..utils.io_mat import _loadmat

        raw = _loadmat(args.mat)["b"]  # [x y w n]
        b = np.transpose(raw, (3, 2, 0, 1)).astype(np.float32)
        return b[: args.limit] if args.limit else b
    return volumes.load_hyperspectral_dir(
        args.data, bands=args.bands, limit=args.limit
    )


def problem(args: argparse.Namespace, b: np.ndarray):
    """(ProblemGeom, LearnConfig) of the arguments and the cubes b, as
    the JAX CLI builds them."""
    from ..config import LearnConfig, ProblemGeom
    from ._common import learner_config_kwargs

    geom = ProblemGeom(
        (args.support, args.support), args.filters, (b.shape[1],)
    )
    cfg = LearnConfig(
        lambda_residual=1.0, lambda_prior=1.0, max_it=args.max_it,
        max_it_d=10, max_it_z=10, tol=args.tol,
        **learner_config_kwargs(args),
    )
    return geom, cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ._common import dispatch_learn, refuse_unported_learner

    refuse_unported_learner(args)
    from ..models.learn_masked import learn_masked
    from ..utils import validate
    from ..utils.device import resolve_device
    from ..utils.io_mat import load_filters_hyperspectral, save_filters

    b = load_data(args)
    print(f"training cubes: {b.shape}")
    sm = gaussian_smooth_init(b)
    geom, cfg = problem(args, b)
    # fail on garbage inputs HERE, with the file/flag named
    validate.check_learn_data(b, geom)
    dev = resolve_device(args.device)
    if args.streaming:
        res = dispatch_learn(
            b, geom, cfg, args.seed, dev, streaming=True,
            stream_mode=args.stream_mode,
            streaming_blocks=args.streaming_blocks, streaming_offset=sm,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            # --streaming swaps in the consensus learner, which has no
            # warm start and no re-transform to carry
            forbidden={"--init": args.init, "--carry-freq": args.carry_freq},
        )
    else:
        res = dispatch_learn(
            b, geom, cfg, args.seed, dev, stream_mode=args.stream_mode,
            solver=learn_masked, smooth_init=sm,
            init_d=load_filters_hyperspectral(args.init) if args.init
            else None,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
        )
    save_filters(args.out, res.d, res.trace, layout="hyperspectral",
                 Dz=res.Dz)
    print(f"saved {tuple(res.d.shape)} filters to {args.out}"
          + (" (streaming)" if args.streaming else ""))
    return res


if __name__ == "__main__":
    main()
