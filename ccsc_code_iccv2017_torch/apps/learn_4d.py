"""4D lightfield dictionary learning (torch port of
``ccsc_code_iccv2017_tpu.apps.learn_4d``, on one device or on
``--mesh N`` ranks, one per GPU: ``block_mesh(N)``, rank 0 writing the
outputs).

Reference protocol: 64 random 50x50x5x5 sub-lightfields
(learn_kernels_4D_extract_patches.m:41-53) -> consensus learner with
kernel [11,11,5,5,49]: the FFT over the two spatial dims only, 2-D code
maps shared across the 5x5 angular views
(admm_learn_conv4D_lightfield.m:18-20,43-47) -> save
4d_filters_lightfield.mat. The z-solve is the W = 25 Woodbury solve.
The lightfield blob is absent: ``--synthetic`` generates a
disparity-shifted lightfield. ``--streaming`` runs the host-streaming
learner (parallel.streaming). Runs on ``--device`` (default cuda).

    python -m ccsc_code_iccv2017_torch.apps.learn_4d --synthetic \\
        --patches 64 --patch-size 50 --blocks 8 [--out f.mat]
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ._common import add_learner_args

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--mat", help=".mat with lightfield [x y a1 a2] or [a1 a2 x y]"
    )
    src.add_argument("--synthetic", action="store_true")
    p.add_argument("--patches", type=int, default=16)
    p.add_argument("--patch-size", type=int, default=24)
    p.add_argument("--views", type=int, default=5)
    p.add_argument("--filters", type=int, default=49)
    p.add_argument("--support", type=int, default=11)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--max-it", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--rho-d", type=float, default=500.0)
    p.add_argument("--rho-z", type=float, default=50.0)
    p.add_argument(
        "--mesh", type=int, default=0,
        help="learn on block_mesh(N): N ranks, one per GPU (gloo ranks "
        "with --device cpu); 0 = one device",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="host-streaming mode: one consensus block on the card at a "
        "time (bounded device memory; parallel.streaming)",
    )
    p.add_argument("--out", default="4d_filters_lightfield.mat")
    add_learner_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", default="brief",
                   choices=["none", "brief", "all"])
    return p


def load_data(args: argparse.Namespace) -> np.ndarray:
    """The patches [n, a1, a2, s, s] the arguments name."""
    from ..data import volumes

    if args.synthetic:
        lf = volumes.synthetic_lightfield(
            views=args.views, side=max(64, args.patch_size + 8),
            seed=args.seed,
        )
    else:
        from ..utils.io_mat import _loadmat

        raw = list(_loadmat(args.mat).items())
        arrs = [v for k, v in raw if hasattr(v, "ndim") and v.ndim == 4]
        if not arrs:
            raise ValueError("no 4-D array found in .mat")
        lf = arrs[0].astype(np.float32)
        if lf.shape[0] > lf.shape[2]:  # [x y a1 a2] -> [a1 a2 x y]
            lf = np.transpose(lf, (2, 3, 0, 1))
    return volumes.random_lightfield_patches(
        lf, args.patches, spatial=args.patch_size, seed=args.seed
    )


def problem(args: argparse.Namespace, b: np.ndarray):
    """(ProblemGeom, LearnConfig) of the arguments and the patches b, as
    the JAX CLI builds them."""
    from ..config import LearnConfig, ProblemGeom
    from ._common import learner_config_kwargs

    geom = ProblemGeom(
        (args.support, args.support), args.filters, (b.shape[1], b.shape[2])
    )
    cfg = LearnConfig(
        max_it=args.max_it, max_it_d=5, max_it_z=10, tol=args.tol,
        rho_d=args.rho_d, rho_z=args.rho_z, num_blocks=args.blocks,
        **learner_config_kwargs(args),
    )
    return geom, cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ._common import (
        app_mesh, dispatch_learn, mesh_result, refuse_unported_learner,
        run_mesh_ranks,
    )

    refuse_unported_learner(args)
    ranks = run_mesh_ranks(__spec__.name, argv, args)
    if ranks is not None:
        return ranks
    from ..utils import validate
    from ..utils.device import resolve_device
    from ..utils.io_mat import save_filters

    b = load_data(args)
    print(f"patches: {b.shape}")
    geom, cfg = problem(args, b)
    # fail on garbage inputs HERE, with the file/flag named
    validate.check_learn_data(b, geom, num_blocks=args.blocks)
    mesh = app_mesh(args)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    res = mesh_result(dispatch_learn(
        b, geom, cfg, args.seed, dev, streaming=args.streaming,
        stream_mode=args.stream_mode, mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    ), mesh)
    if res is None:  # a rank other than 0 of a mesh writes nothing
        return None
    save_filters(args.out, res.d, res.trace, layout="lightfield", Dz=res.Dz)
    print(f"saved {tuple(res.d.shape)} filters to {args.out}")
    return res


if __name__ == "__main__":
    main()
