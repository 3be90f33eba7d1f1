"""The flags the reconstruction and learner apps share (the port's
counterpart of the JAX package's ``apps/_dispatch.py`` argument helpers),
the learner CLIs' solver dispatch with its streaming arm
(:func:`dispatch_learn`), their ``--mesh N`` (:func:`run_mesh_ranks`,
:func:`app_mesh`, :func:`mesh_result`), and what a reconstruction app's
``run`` returns.

Every flag of the JAX CLIs parses here with the same name, choices and
default; a non-default value of a feature the port has not ported yet
is refused where the config reads it (``config.SolveConfig`` for
``--fft-impl`` and ``--tune``) or by :func:`refuse_unported`
(``--tune-store``), or for the learners by
:func:`refuse_unported_learner`, naming the ROADMAP.md item that ports
it. ``--metrics-dir`` writes the run's telemetry stream (utils.obs).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np


def add_perf_args(parser: argparse.ArgumentParser, fft_pad: bool = True) -> None:
    """``--fft-pad`` (not for the unpadded problems, where a rounded-up
    FFT domain would change the problem), ``--fft-impl``, ``--tune`` and
    ``--tune-store``."""
    if fft_pad:
        parser.add_argument(
            "--fft-pad", default="none", choices=["none", "pow2", "fast"],
            help="round the FFT domain up to a fast size",
        )
    parser.add_argument(
        "--fft-impl", default="xla",
        choices=["xla", "matmul", "matmul_high", "matmul_bf16"],
        help="FFT strategy; the port runs 'xla' (torch.fft) only",
    )
    parser.add_argument(
        "--tune", default="off", choices=["off", "auto", "sweep"],
        help="knob autotuning; the port runs 'off' only",
    )
    parser.add_argument(
        "--tune-store", default=None, metavar="PATH",
        help="tuned-knob store path (autotuning is not ported yet)",
    )


def add_obs_args(parser: argparse.ArgumentParser) -> None:
    """The shared telemetry flag: --metrics-dir maps to
    LearnConfig.metrics_dir / SolveConfig.metrics_dir (utils.obs)."""
    parser.add_argument(
        "--metrics-dir", default=None,
        help="write a structured JSONL telemetry stream (run metadata, "
        "per-step metrics, kernel-library compile records, roofline, "
        "heartbeats) into this directory; render it with the JAX "
        "package's scripts/obs_report.py",
    )


def add_mat_layout_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--mat-layout", choices=["matlab", "framework"], default=None,
        help="layout of an unnamed .mat image stack: matlab [H,W(,C),n] "
        "or framework [n,H,W(,C)]",
    )


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to solve on (default cuda; 'cpu' for tests)",
    )


def refuse_unported(args: argparse.Namespace) -> None:
    if getattr(args, "tune_store", None) is not None:
        raise NotImplementedError(
            "--tune-store: knob autotuning is not ported yet "
            "(ROADMAP.md Queue 1 item 9)"
        )


def add_learner_args(
    parser: argparse.ArgumentParser,
    masked_carry: bool = False,
    d_storage: bool = True,
) -> None:
    """The flags the learner CLIs share, as the JAX package's
    ``add_perf_args(chunk=True, masked_carry=...)``,
    ``add_resilience_args`` and ``add_obs_args`` define them, plus the
    storage dtypes and ``--device``. Those whose mechanisms are not
    ported parse here and are refused by :func:`refuse_unported_learner`."""
    add_perf_args(parser)
    parser.add_argument(
        "--outer-chunk", type=int, default=1,
        help="outer iterations per chunk (chunked outer steps are not "
        "ported yet)",
    )
    parser.add_argument(
        "--donate-state", action="store_true",
        help="donate the state to the chunked step (not ported yet)",
    )
    parser.add_argument(
        "--stream-mode", default=None,
        choices=["auto", "device", "kern", "paged"],
        help="placement tier of --streaming's block state: auto picks "
        "by the CCSC_STREAM_RESIDENT_GB byte budget (default: the "
        "CCSC_STREAM_MODE knob, else auto)",
    )
    if masked_carry:
        parser.add_argument(
            "--carry-freq", action="store_true",
            help="carry the frequency-domain iterate across the masked "
            "learner's inner iterations instead of re-transforming it "
            "(LearnConfig.carry_freq; masked learner only)",
        )
    parser.add_argument(
        "--max-recoveries", type=int, default=0,
        help="divergence recoveries per run: on non-finite metrics keep "
        "the last good state, back off rho by --rho-backoff and retry",
    )
    parser.add_argument(
        "--rho-backoff", type=float, default=0.5,
        help="multiplicative rho backoff per recovery",
    )
    parser.add_argument(
        "--watchdog", action="store_true",
        help="the dispatch-fence watchdog (not ported yet)",
    )
    parser.add_argument("--watchdog-slack", type=float, default=20.0)
    parser.add_argument(
        "--auto-degrade", action="store_true",
        help="the out-of-memory downgrade ladder (not ported yet)",
    )
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=5)
    add_obs_args(parser)
    parser.add_argument(
        "--storage-dtype", default="float32",
        choices=["float32", "bfloat16"],
        help="storage dtype of the code state",
    )
    if d_storage:
        parser.add_argument(
            "--d-storage-dtype", default="float32",
            choices=["float32", "bfloat16"],
            help="storage dtype of the per-block dictionary state",
        )
    add_device_arg(parser)


# learner flags of the JAX CLIs whose mechanisms are not ported yet:
# (argparse dest, the value that asks for nothing, what it is, the
# ROADMAP.md Queue 1 item that ports it)
_LEARNER_NOT_PORTED = (
    ("tune", "off", "--tune (knob autotuning)", "9"),
    ("tune_store", None, "--tune-store (knob autotuning)", "9"),
    ("fft_impl", "xla", "--fft-impl (the matmul-DFT tiers)", "9"),
    ("outer_chunk", 1, "--outer-chunk (chunked outer steps)", "9"),
    ("donate_state", False, "--donate-state (chunked outer steps)", "9"),
    ("auto_degrade", False, "--auto-degrade (the OOM downgrade ladder)",
     "10"),
    ("watchdog", False, "--watchdog (the dispatch-fence watchdog)", "10"),
)


def refuse_unported_learner(args: argparse.Namespace) -> None:
    """Exit naming the ROADMAP.md item of the first learner flag set
    whose mechanism is not ported yet."""
    for dest, idle, what, item in _LEARNER_NOT_PORTED:
        if getattr(args, dest, idle) != idle:
            raise SystemExit(
                f"not ported yet: {what}: ROADMAP.md Queue 1 item {item}"
            )


def learner_config_kwargs(args: argparse.Namespace) -> dict:
    """The LearnConfig fields the shared learner flags set."""
    kw = dict(
        verbose=args.verbose, fft_pad=args.fft_pad,
        storage_dtype=args.storage_dtype,
        max_recoveries=args.max_recoveries, rho_backoff=args.rho_backoff,
        watchdog_slack=args.watchdog_slack, metrics_dir=args.metrics_dir,
    )
    if hasattr(args, "d_storage_dtype"):
        kw["d_storage_dtype"] = args.d_storage_dtype
    if hasattr(args, "carry_freq"):
        kw["carry_freq"] = args.carry_freq
    return kw


def _refuse_mesh_flags(args: argparse.Namespace) -> None:
    if getattr(args, "streaming", False):
        raise SystemExit(
            "--streaming is single-device and does not combine with --mesh"
        )
    if getattr(args, "stream_mode", None):
        raise SystemExit("--stream-mode requires --streaming")


def _app_rank(rank: int, module: str, argv: list):
    """One rank of a learner CLI's ``--mesh N``: the app's ``main`` inside
    the process group; rank 0's result comes back."""
    import importlib

    res = importlib.import_module(module).main(argv)
    return res if rank == 0 else None


def run_mesh_ranks(module: str, argv, args: argparse.Namespace):
    """A learner CLI's ``--mesh N`` from outside a process group: start N
    ranks (``parallel.distributed.launch`` on ``--device``: N GPUs with
    NCCL on "cuda", refused when fewer are visible; ``gloo`` ranks on
    "cpu"), each running ``module``'s ``main(argv)``, which joins the
    group and learns on ``block_mesh(N)``; rank 0 writes the outputs.
    Returns rank 0's result, or None when this process is a rank already
    (inside ``launch``, or a ``torchrun`` rank, which joins its group
    here) or no mesh is asked for: the caller then runs the solve
    itself."""
    import os
    import sys

    import torch.distributed as dist

    if not getattr(args, "mesh", 0) or dist.is_initialized():
        return None
    _refuse_mesh_flags(args)
    from ..parallel import distributed

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # a torchrun rank: join the group the launcher describes
        try:
            distributed.initialize(device=args.device)
        except ValueError as e:  # more ranks than GPUs
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        return None

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return distributed.launch(
            _app_rank, args.mesh, args=(module, argv), device=args.device,
            threads=None, timeout=distributed.DEFAULT_TIMEOUT_S,
            join_timeout=24 * 3600.0,
        )[0]
    except ValueError as e:  # more ranks than GPUs
        raise SystemExit(f"--mesh {args.mesh}: {e}")


def app_mesh(args: argparse.Namespace):
    """Inside a rank: the learner CLIs' ``block_mesh(--mesh)``, as the JAX
    CLIs build it (None without ``--mesh``)."""
    if not getattr(args, "mesh", 0):
        return None
    _refuse_mesh_flags(args)
    from ..parallel.mesh import block_mesh

    return block_mesh(args.mesh)


def mesh_result(res, mesh):
    """A rank's learner result as the app hands it on: with a mesh, Dz
    gathered to rank 0 (its z stays rank 0's blocks) and None on the
    other ranks, which write nothing."""
    if mesh is None:
        return res
    from ..parallel.mesh import gather_blocks

    Dz = gather_blocks(res.Dz.contiguous(), mesh)
    return res._replace(Dz=Dz) if mesh.rank == 0 else None


def dispatch_learn(
    b, geom, cfg, seed: int, device, *, streaming: bool = False,
    stream_mode: Optional[str] = None, solver=None,
    streaming_blocks: Optional[int] = None, streaming_offset=None,
    forbidden: Optional[dict] = None, mesh=None, **kwargs,
):
    """Run a learner CLI's solve: ``solver`` (default the consensus
    learner, parallel.consensus.learn) with ``kwargs`` (and ``mesh``),
    or with ``streaming`` the host-streaming learner (the port of the
    JAX package's ``apps/_dispatch.py::dispatch_learn`` without its
    tuning and degrade arms; streaming refuses a mesh as JAX does). The
    random init draws from ``seed``: on ``device`` for the in-memory
    solvers, on the host for the streaming learner, whose state lives
    there.

    The streaming arm takes ``checkpoint_dir`` / ``checkpoint_every``
    and nothing else: a truthy ``forbidden`` entry ({"--cli-flag":
    value}) or a non-None extra keyword is refused by name.
    ``streaming_offset`` is subtracted from the data before the run and
    added back to Dz after it (the hyperspectral app's smooth_init, so
    Dz is the full reconstruction, as the masked learner's);
    ``streaming_blocks`` becomes cfg.num_blocks, shrunk to the largest
    divisor of n not above it."""
    import torch

    if stream_mode and not streaming:
        raise SystemExit("--stream-mode requires --streaming")
    if streaming and mesh is not None:
        raise SystemExit(
            "--streaming is single-device and does not combine with --mesh"
        )
    if not streaming:
        if solver is None:
            from ..parallel.consensus import learn as solver
        return solver(
            b, geom, cfg, device=device,
            generator=torch.Generator(device=device).manual_seed(seed),
            mesh=mesh, **kwargs,
        )
    checkpoint_dir = kwargs.pop("checkpoint_dir", None)
    checkpoint_every = kwargs.pop("checkpoint_every", 5)
    set_flags = [k for k, v in (forbidden or {}).items() if v]
    if set_flags:
        raise SystemExit(
            "--streaming does not combine with " + "/".join(set_flags)
        )
    # an unset option rides the shared call as None; `is not None`
    # because values can be arrays
    extra = sorted(k for k, v in kwargs.items() if v is not None)
    if extra:
        raise SystemExit("--streaming does not combine with "
                         + "/".join(extra))
    from ..parallel.streaming import learn_streaming

    b = np.asarray(b, np.float32)
    if streaming_offset is not None:
        streaming_offset = np.asarray(streaming_offset, np.float32)
        b = b - streaming_offset
    if streaming_blocks is not None:
        n = b.shape[0]
        blocks = max(1, min(streaming_blocks, n))
        while n % blocks:
            blocks -= 1
        cfg = dataclasses.replace(cfg, num_blocks=blocks)
    res = learn_streaming(
        b, geom, cfg, generator=torch.Generator().manual_seed(seed),
        stream_mode=stream_mode, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, device=device,
    )
    if streaming_offset is not None:
        # the streaming learner codes the offset-subtracted data
        res = res._replace(Dz=res.Dz + torch.from_numpy(streaming_offset))
    return res


class AppRun(NamedTuple):
    """What an app's ``run`` returns: the solve's result (a list of them
    for the Poisson app, one per image), the app's quality number and
    its baseline as the app prints them, and the iterations run (summed
    over the Poisson app's images)."""

    result: Any
    psnr_db: float
    baseline_psnr_db: float
    iters: int
