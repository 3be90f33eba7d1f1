"""2D dictionary learning driver (torch port of
``ccsc_code_iccv2017_tpu.apps.learn_2d``: its consensus path, on one
device or on ``--mesh N`` ranks, and its masked path).

Reference protocol: CreateImages(path,'local_cn',1,'gray') -> consensus
learner (kernel [11,11,100], lambda_res=lambda=1.0, max_it=20,
tol=1e-3) -> save Filters_ours_2D_large.mat
(learn_kernels_2D_large.m:8-45). Runs on ``--device`` (default cuda);
``--fused-z`` takes the z inner iteration through the hand-written
kernels K2a/K2b; ``--masked`` learns with the masked-boundary learner
(models.learn_masked at reduce_shape=(), whose z-solve is K1);
``--streaming`` with the host-streaming learner (parallel.streaming: one
consensus block on the card at a time, ``--stream-mode`` its placement
tier; its z-solve is K1, never K2); ``--mesh N`` with ``block_mesh(N)``:
N ranks, one per GPU (gloo ranks with ``--device cpu``), each holding
blocks / N consensus blocks and running K2 on them, rank 0 writing the
outputs.

    python -m ccsc_code_iccv2017_torch.apps.learn_2d --data DIR \\
        [--filters 100 --support 11 --blocks 8 --fused-z --out f.mat]
"""
from __future__ import annotations

import argparse
import time

def build_parser() -> argparse.ArgumentParser:
    from ._common import add_learner_args, add_mat_layout_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="image folder")
    p.add_argument("--filters", type=int, default=100)
    p.add_argument("--support", type=int, default=11)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--max-it", type=int, default=20)
    p.add_argument("--max-it-d", type=int, default=5)
    p.add_argument("--max-it-z", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--lambda-residual", type=float, default=1.0)
    p.add_argument("--lambda-prior", type=float, default=1.0)
    p.add_argument("--rho-d", type=float, default=5000.0)
    p.add_argument("--rho-z", type=float, default=1.0)
    p.add_argument("--contrast", default="local_cn",
                   help="contrast mode of data.images.load_images")
    add_mat_layout_arg(p)
    p.add_argument("--size", type=int, default=None, help="resize side")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument(
        "--mesh", type=int, default=0,
        help="learn on block_mesh(N): N ranks, one per GPU (gloo ranks "
        "with --device cpu); 0 = one device",
    )
    p.add_argument("--out", default="Filters_ours_2D_large.mat")
    p.add_argument(
        "--init-filters", default=None,
        help="warm-start dictionary .mat (e.g. a previous --out)",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="capture a torch.profiler trace of the step loop (Chrome "
        "trace JSON; TensorBoard's PyTorch profiler plugin reads the dir)",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="host-streaming mode: one consensus block on the card at a "
        "time (bounded device memory; parallel.streaming)",
    )
    p.add_argument(
        "--masked", action="store_true",
        help="use the masked-boundary learner (models.learn_masked at "
        "reduce_shape=()): masked border residual, single dictionary, "
        "objective-regression rollback. Unlocks --carry-freq; does not "
        "combine with --streaming/--mesh/--fused-z/--profile-dir",
    )
    p.add_argument(
        "--fused-z", action="store_true",
        help="run the z inner iteration as the hand-written kernels "
        "K2a/K2b (2D, W == 1)",
    )
    add_learner_args(p, masked_carry=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", default="brief",
                   choices=["none", "brief", "all"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.carry_freq and not args.masked:
        # carry_freq is the masked learner's lever
        raise SystemExit("--carry-freq requires --masked")
    if args.masked:
        for flag, val in (
            ("--streaming", args.streaming),
            ("--mesh", args.mesh),
            ("--fused-z", args.fused_z),
            ("--profile-dir", args.profile_dir),
        ):
            if val:
                raise SystemExit(
                    f"--masked does not combine with {flag} "
                    "(consensus-learner mechanisms)"
                )
    from ._common import (
        app_mesh, dispatch_learn, learner_config_kwargs, mesh_result,
        run_mesh_ranks,
    )

    ranks = run_mesh_ranks(__spec__.name, argv, args)
    if ranks is not None:
        return ranks
    from ..config import LearnConfig, ProblemGeom
    from ..data.images import load_images
    from ..models.learn_masked import learn_masked
    from ..utils import validate
    from ..utils.device import resolve_device
    from ..utils.io_mat import load_filters_2d, save_filters

    t0 = time.time()
    size = (args.size, args.size) if args.size else None
    b = load_images(
        args.data,
        contrast_normalize=args.contrast,
        zero_mean=True,
        square=args.size is None,
        size=size,
        limit=args.limit,
        mat_layout=args.mat_layout,
    )
    print(f"loaded {b.shape[0]} images {b.shape[1:]} in "
          f"{time.time() - t0:.1f}s")
    geom = ProblemGeom((args.support, args.support), args.filters)
    # fail on garbage inputs HERE, with the file/flag named; the masked
    # learner never consensus-splits the batch, so --blocks does not
    # constrain it
    validate.check_learn_data(
        b, geom, num_blocks=None if args.masked else args.blocks
    )
    cfg = LearnConfig(
        lambda_residual=args.lambda_residual,
        lambda_prior=args.lambda_prior,
        max_it=args.max_it,
        max_it_d=args.max_it_d,
        max_it_z=args.max_it_z,
        tol=args.tol,
        rho_d=args.rho_d,
        rho_z=args.rho_z,
        num_blocks=args.blocks,
        fused_z=args.fused_z,
        **learner_config_kwargs(args),
    )
    mesh = app_mesh(args)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    init_d = load_filters_2d(args.init_filters) if args.init_filters else None
    res = mesh_result(dispatch_learn(
        b, geom, cfg, args.seed, dev, streaming=args.streaming,
        stream_mode=args.stream_mode,
        solver=learn_masked if args.masked else None, mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        init_d=init_d,
        auto_degrade=args.auto_degrade,
        # the consensus learner's profiler (the masked path refused the
        # flag above)
        **({} if args.masked else {"profile_dir": args.profile_dir}),
        forbidden={"--init-filters": args.init_filters,
                   "--profile-dir": args.profile_dir},
    ), mesh)
    if res is None:  # a rank other than 0 of a mesh writes nothing
        return None
    save_filters(args.out, res.d, res.trace, layout="2d", Dz=res.Dz)
    print(
        f"saved {tuple(res.d.shape)} filters to {args.out}; total "
        f"{time.time() - t0:.1f}s, solver {res.trace['tim_vals'][-1]:.1f}s"
    )
    return res


if __name__ == "__main__":
    main()
