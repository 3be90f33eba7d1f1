"""3D (video) dictionary learning (torch port of
``ccsc_code_iccv2017_tpu.apps.learn_3d``, on one device or on
``--mesh N`` ranks, one per GPU: ``block_mesh(N)``, rank 0 writing the
outputs).

Reference protocol: the contrast-normalized movie -> 64 random crops of
50^3 (learn_kernels_3D.m:35-44) -> consensus learner with kernel
[11,11,11,49], max_it=20, tol=1e-2, ni=sqrt(n) blocks
(admm_learn_conv3D_large.m:11-12) -> save 3D_video_filters.mat. The
movie blob is absent: ``--synthetic`` generates drifting-texture clips,
``--movie`` extracts crops from a video file. The z-solve of every
inner iteration is K1 over all the clips' codes (W == 1); ``--streaming``
runs the host-streaming learner (parallel.streaming), whose z-solve is K1
over one block's codes. Runs on ``--device`` (default cuda).

    python -m ccsc_code_iccv2017_torch.apps.learn_3d --synthetic \\
        --clips 64 --clip-size 50 --blocks 8 [--out f.mat]
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from ._common import add_learner_args

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--movie", help="mp4/avi to extract frames from")
    src.add_argument("--synthetic", action="store_true")
    p.add_argument("--clips", type=int, default=16)
    p.add_argument("--clip-size", type=int, default=24)
    p.add_argument("--clip-frames", type=int, default=None)
    p.add_argument("--filters", type=int, default=49)
    p.add_argument("--support", type=int, default=11)
    p.add_argument("--support-t", type=int, default=11)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--max-it", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-2)
    p.add_argument("--rho-d", type=float, default=5000.0)
    p.add_argument("--rho-z", type=float, default=1.0)
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
    p.add_argument("--out", default="3D_video_filters.mat")
    add_learner_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", default="brief",
                   choices=["none", "brief", "all"])
    return p


def load_data(args: argparse.Namespace):
    """The clips [n, side, side, frames] the arguments name."""
    from ..data import volumes

    ct = args.clip_frames or args.clip_size
    if args.synthetic:
        return volumes.synthetic_video(
            n=args.clips, side=args.clip_size, frames=ct, seed=args.seed
        )
    vol = volumes.extract_movie(args.movie, side=100, contrast_normalize=True)
    return volumes.random_volume_crops(
        vol, args.clips, (args.clip_size, args.clip_size, ct), args.seed
    )


def problem(args: argparse.Namespace):
    """(ProblemGeom, LearnConfig) of the arguments, as the JAX CLI
    builds them."""
    from ..config import LearnConfig, ProblemGeom
    from ._common import learner_config_kwargs

    geom = ProblemGeom(
        (args.support, args.support, args.support_t), args.filters
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
    print(f"clips: {b.shape}")
    geom, cfg = problem(args)
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
    save_filters(args.out, res.d, res.trace, layout="3d", Dz=res.Dz)
    print(f"saved {tuple(res.d.shape)} filters to {args.out}")
    return res


if __name__ == "__main__":
    main()
