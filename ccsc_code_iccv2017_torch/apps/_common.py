"""The flags the reconstruction and learner apps share (the port's
counterpart of the JAX package's ``apps/_dispatch.py`` argument helpers),
the learner CLIs' solver dispatch with its streaming arm and its
out-of-memory downgrade ladder (:func:`dispatch_learn`), their ``--mesh N`` (:func:`run_mesh_ranks`,
:func:`app_mesh`, :func:`mesh_result`), and what a reconstruction app's
``run`` returns.

Every flag of the JAX CLIs parses here with the same name, choices and
default. ``--fft-impl`` picks the transform tier, ``--outer-chunk`` /
``--donate-state`` the chunked learner driver, ``--tune`` the knob
autotuner (resolved once before a learner runs, :func:`dispatch_learn`)
and ``--tune-store`` its store (it sets ``CCSC_TUNE_STORE``).
``--metrics-dir`` writes the run's telemetry stream (utils.obs);
``--watchdog`` arms the dispatch-fence watchdog (utils.watchdog) and
``--auto-degrade`` the downgrade ladder.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np


class _TuneStoreAction(argparse.Action):
    """``--tune-store PATH`` is ``CCSC_TUNE_STORE=PATH`` for this process:
    every store reader (the learners' resolution, ``reconstruct``'s inline
    resolution, the engine) reads the knob, so the flag sets it at parse
    time, as the JAX flag does."""

    def __call__(self, parser, namespace, values, option_string=None):
        import os

        os.environ["CCSC_TUNE_STORE"] = values
        setattr(namespace, self.dest, values)


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
        help="FFT strategy: 'xla' (torch.fft) or a matmul-DFT tier "
        "(float32, 3-pass bf16, 1-pass bf16 products)",
    )
    parser.add_argument(
        "--tune", default="off", choices=["off", "auto", "sweep"],
        help="knob autotuning (tune/): 'auto' applies the measured-"
        "fastest arm for this card + shape bucket from the tuned store "
        "(behind a trajectory-parity numerics guard; a failing arm is "
        "demoted and the next-best applied); 'sweep' times the "
        "candidate arms on this card first and persists the ranking; "
        "'off' (default) runs exactly the flags given",
    )
    parser.add_argument(
        "--tune-store", default=None, action=_TuneStoreAction,
        metavar="PATH",
        help="tuned-knob store path (sets CCSC_TUNE_STORE; default: "
        "$CCSC_COMPILE_CACHE/ccsc_tuned_knobs.json, else the port's "
        "build/ccsc_tuned_knobs.json)",
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


def add_learner_args(
    parser: argparse.ArgumentParser,
    masked_carry: bool = False,
    d_storage: bool = True,
) -> None:
    """The flags the learner CLIs share, as the JAX package's
    ``add_perf_args(chunk=True, masked_carry=...)``,
    ``add_resilience_args`` and ``add_obs_args`` define them, plus the
    storage dtypes and ``--device``."""
    add_perf_args(parser)
    parser.add_argument(
        "--outer-chunk", type=int, default=1,
        help="outer iterations per chunk: one host read a chunk, the "
        "divergence guard and the tol stop on the device; bitwise the "
        "per-step run (LearnConfig.outer_chunk)",
    )
    parser.add_argument(
        "--donate-state", action="store_true",
        help="adopt each chunked step into the input state's storage, "
        "so a chunk holds one state fewer (LearnConfig.donate_state; "
        "implies the chunked driver; not with --streaming)",
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
        help="arm the dispatch-fence watchdog: a step whose host read "
        "exceeds its roofline-derived deadline emits a `stall` record "
        "and (CCSC_WATCHDOG_ACTION=abort, the default) hard-exits with "
        "code 87 so a supervisor can restart from the last checkpoint "
        "(LearnConfig.watchdog; utils.watchdog)",
    )
    parser.add_argument(
        "--watchdog-slack", type=float, default=20.0,
        help="slack multiplier on the roofline-derived per-iteration "
        "time before a fence is declared hung (LearnConfig.watchdog_slack)",
    )
    parser.add_argument(
        "--auto-degrade", action="store_true",
        help="on a preflight memory overflow (CCSC_INMEM_HBM_GB, else the "
        "card's free memory) or a torch.OutOfMemoryError in the first "
        "step, step down donate -> --outer-chunk 1 -> --streaming "
        "instead of erroring; every downgrade is a `degrade` record "
        "and in trace['degrades']",
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


def learner_config_kwargs(args: argparse.Namespace) -> dict:
    """The LearnConfig fields the shared learner flags set."""
    kw = dict(
        verbose=args.verbose, fft_pad=args.fft_pad,
        storage_dtype=args.storage_dtype,
        max_recoveries=args.max_recoveries, rho_backoff=args.rho_backoff,
        watchdog=args.watchdog, watchdog_slack=args.watchdog_slack,
        metrics_dir=args.metrics_dir, fft_impl=args.fft_impl,
        outer_chunk=args.outer_chunk, donate_state=args.donate_state,
        tune=args.tune,
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


def _retry_discards_progress(metrics_dir, checkpoint_dir, t_start) -> bool:
    """Whether re-running the solver after a runtime OOM would discard
    completed work: with a checkpoint dir the retry resumes, and an
    attempt that recorded no step died before its first step, the
    ladder's target. Only a checkpoint-less attempt with recorded steps
    (a late OOM) must surface the error instead of silently starting the
    learn over."""
    if checkpoint_dir:
        return False
    if metrics_dir is None:
        return False  # no evidence either way; a first-step OOM is the norm
    from ..utils import obs

    return any(
        e.get("type") == "step" and e.get("t", 0.0) >= t_start
        for e in obs.read_events(metrics_dir)
    )


def _looks_oom(e: BaseException) -> bool:
    """A device-memory failure (``torch.OutOfMemoryError``; the shared
    recognizer utils.memwatch.is_oom)."""
    from ..utils import memwatch

    return memwatch.is_oom(e)


def _can_stream(mesh, solver, forbidden, kwargs) -> bool:
    """Whether the streaming rung is open from this call: the streaming
    learner is single-device consensus and takes only the checkpoint
    options, and an existing checkpoint must not be the in-memory
    learner's (its fingerprint differs, so the streaming learner would
    refuse to resume it; stopping here keeps the OOM as the error)."""
    import os

    if mesh is not None or solver is not None:
        return False
    if any(v for v in (forbidden or {}).values()):
        return False
    # `is not None`: option values can be arrays
    if any(v is not None for k, v in kwargs.items()
           if k not in ("checkpoint_dir", "checkpoint_every")):
        return False
    ckdir = kwargs.get("checkpoint_dir")
    if ckdir and any(
        os.path.exists(os.path.join(ckdir, f))
        for f in ("ccsc_state.npz", "ccsc_state.prev.npz")
    ):
        return False
    return True


def _next_rung(cfg, streaming, mesh, solver, forbidden, kwargs,
               runtime=False):
    """The next downgrade, ``(new_cfg, new_streaming, rung_name)``, or
    None when the ladder is exhausted. JAX's order: ``donate`` (the
    chunk adopts into the input state's storage: one state fewer),
    ``chunk`` (runtime only: outer_chunk=1), then ``streaming``
    (host-resident state, bounded device memory)."""
    if streaming:
        return None
    if not cfg.donate_state:
        return dataclasses.replace(cfg, donate_state=True), False, "donate"
    if runtime and cfg.outer_chunk > 1:
        return dataclasses.replace(cfg, outer_chunk=1), False, "chunk"
    if _can_stream(mesh, solver, forbidden, kwargs):
        # the streaming learner refuses donate_state
        return dataclasses.replace(cfg, donate_state=False), True, "streaming"
    return None


class _DegradeLog:
    """The ladder's downgrade records, mirrored into the obs stream: the
    learner's run is not open at preflight (and is closed when its OOM
    reaches the ladder), so they go to their own
    ``events-pNNNNN-dispatch.jsonl`` in the same metrics dir, which
    ``utils.obs.read_events`` merges into the run's stream."""

    def __init__(self, metrics_dir: Optional[str]):
        import os

        from ..utils import obs

        self.events: list = []
        self._writer = None
        self._host = obs._process_index()
        if metrics_dir is not None:
            self._writer = obs.EventWriter(os.path.join(
                metrics_dir, f"events-p{self._host:05d}-dispatch.jsonl"))

    def record(self, rung: str, stage: str, **fields) -> None:
        import time

        ev = {"rung": rung, "stage": stage, **fields}
        self.events.append(ev)
        print(f"auto-degrade [{stage}]: stepping down to '{rung}' "
              + ", ".join(f"{k}={v}" for k, v in fields.items()),
              flush=True)
        if self._writer is not None:
            self._writer.write({"t": time.time(), "type": "degrade",
                                "host": self._host, **ev})

    def oom_forensics(self, e: BaseException, metrics_dir) -> None:
        """The utils.memwatch OOM dump (every device's memory stats and
        the error) beside the stream, and its ``mem_oom_dump`` record in
        the dispatch file: the learner's own run is already closed."""
        import time

        from ..utils import memwatch

        path = memwatch.oom_dump(e, dump_dir=metrics_dir)
        if path is None:
            return
        print(f"auto-degrade: OOM forensic dump written to {path}",
              flush=True)
        if self._writer is not None:
            self._writer.write({"t": time.time(), "type": "mem_oom_dump",
                                "host": self._host, "path": path,
                                "error": str(e)[:300]})

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def dispatch_learn(
    b, geom, cfg, seed: int, device, *, streaming: bool = False,
    stream_mode: Optional[str] = None, solver=None,
    streaming_blocks: Optional[int] = None, streaming_offset=None,
    forbidden: Optional[dict] = None, mesh=None, auto_degrade: bool = False,
    **kwargs,
):
    """Run a learner CLI's solve: ``solver`` (default the consensus
    learner, parallel.consensus.learn) with ``kwargs`` (and ``mesh``),
    or with ``streaming`` the host-streaming learner (the port of the
    JAX package's ``apps/_dispatch.py::dispatch_learn``; streaming
    refuses a mesh as JAX does). A ``cfg.tune`` other than 'off' is
    resolved first, once (:func:`_resolve_tune`), so the ladder sees the
    knobs that will run. The random init
    draws from ``seed``: on ``device`` for the in-memory solvers, on the
    host for the streaming learner, whose state lives there.

    The streaming arm takes ``checkpoint_dir`` / ``checkpoint_every``
    and nothing else: a truthy ``forbidden`` entry ({"--cli-flag":
    value}) or a non-None extra keyword is refused by name.
    ``streaming_offset`` is subtracted from the data before the run and
    added back to Dz after it (the hyperspectral app's smooth_init, so
    Dz is the full reconstruction, as the masked learner's);
    ``streaming_blocks`` becomes cfg.num_blocks, shrunk to the largest
    divisor of n not above it.

    ``auto_degrade`` (``--auto-degrade``) arms JAX's downgrade ladder:
    when the preflight estimate (utils.perfmodel.inmem_learn_estimate)
    exceeds the device budget, or the solver raises
    ``torch.OutOfMemoryError``, the run steps down a rung and retries;
    each downgrade is a ``degrade`` record (and each OOM a forensic dump
    and its ``mem_oom_dump`` record) in the stream's
    ``events-pNNNNN-dispatch.jsonl`` and lands in ``trace['degrades']``.
    The rungs are JAX's: donate, chunk (runtime only), streaming.
    Default off: an explicit OOM beats a silent strategy change."""
    if stream_mode and not streaming:
        raise SystemExit("--stream-mode requires --streaming")
    if streaming and mesh is not None:
        raise SystemExit(
            "--streaming is single-device and does not combine with --mesh"
        )
    if cfg.tune != "off":
        cfg = _resolve_tune(cfg, b, geom, streaming, solver, device)
    once = functools.partial(
        _dispatch_once, b, geom, seed, device, stream_mode=stream_mode,
        solver=solver, streaming_blocks=streaming_blocks,
        streaming_offset=streaming_offset, forbidden=forbidden, mesh=mesh)
    if not auto_degrade:
        return once(cfg, streaming, kwargs)

    import gc
    import time

    import torch

    log = _DegradeLog(cfg.metrics_dir)
    try:
        if not streaming and solver is None:
            # the estimate models the consensus learner's working set; a
            # custom solver (the masked learner) takes only the runtime
            # rung below
            from ..utils import perfmodel

            est, budget = perfmodel.inmem_learn_estimate(
                np.shape(b), geom, cfg, device=device)
            while est > budget:
                rung = _next_rung(cfg, streaming, mesh, solver, forbidden,
                                  kwargs)
                if rung is None:
                    break  # ladder exhausted; run as configured
                cfg, streaming, name = rung
                log.record(name, "preflight", est_gb=round(est / 1e9, 2),
                           budget_gb=round(budget / 1e9, 2))
                if streaming:
                    break  # host-resident state: bounded by design
                est, budget = perfmodel.inmem_learn_estimate(
                    np.shape(b), geom, cfg, device=device)
        while True:
            t_attempt = time.time()
            try:
                res = once(cfg, streaming, dict(kwargs))
                break
            except Exception as e:
                if not _looks_oom(e):
                    raise
                # forensics first: whatever the ladder decides, the OOM
                # leaves a device-memory post-mortem
                log.oom_forensics(e, cfg.metrics_dir)
                if _retry_discards_progress(
                        cfg.metrics_dir, kwargs.get("checkpoint_dir"),
                        t_attempt):
                    print("auto-degrade: a late OOM interrupted completed "
                          "iterations and no --checkpoint-dir is set — "
                          "surfacing the error instead of silently "
                          "restarting the learn from scratch", flush=True)
                    raise
                rung = _next_rung(cfg, streaming, mesh, solver, forbidden,
                                  kwargs, runtime=True)
                if rung is None:
                    raise
                cfg, streaming, name = rung
                log.record(name, "dispatch", error=str(e)[:300])
            # the failed attempt's tensors died with its frames: hand the
            # cached blocks back before the next rung allocates
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        log.close()
    if log.events and isinstance(res.trace, dict):
        res.trace["degrades"] = log.events
    return res


def _resolve_tune(cfg, b, geom, streaming, solver, device):
    """The learner CLIs' knob resolution (``--tune``), once, before the
    ladder's preflight (JAX ``apps/_dispatch.py::_resolve_tune``). The
    workload token gates which knobs an arm may set (a consensus-measured
    fused_z never configures the masked or streaming learner) and scopes
    the store key; records go to ``events-pNNNNN-tune.jsonl`` in the
    metrics dir (the learner's run is not open yet)."""
    import os
    import time

    from ..tune import autotune, store as tune_store
    from ..utils import obs

    algo = ("masked" if solver is not None
            else ("streaming" if streaming else "consensus"))
    workload = tune_store.learn_workload(geom, algo)
    writer = emit = None
    if cfg.metrics_dir is not None:
        host = obs._process_index()
        writer = obs.EventWriter(os.path.join(
            cfg.metrics_dir, f"events-p{host:05d}-tune.jsonl"))

        def emit(type_, _w=writer, _h=host, **fields):
            _w.write({"t": time.time(), "type": type_, "host": _h,
                      **fields})

    try:
        cfg, _ = autotune.resolve_learn(
            cfg, geom, tuple(np.shape(b)), workload=workload, emit=emit,
            device=device,
        )
    finally:
        if writer is not None:
            writer.close()
    return cfg


def _dispatch_once(b, geom, seed, device, cfg, streaming, kwargs, *,
                   stream_mode, solver, streaming_blocks, streaming_offset,
                   forbidden, mesh):
    """One attempt of :func:`dispatch_learn` with ``cfg`` (the in-memory
    solver, or with ``streaming`` the host-streaming learner)."""
    import torch

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
