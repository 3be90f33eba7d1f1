"""Reconstruction serving CLI (torch port of
``ccsc_code_iccv2017_tpu.apps.serve``) — the production replacement for
the reference's per-image loop (reconstruct_2D_subsampling.m:35-60).

Loads a 2D filter bank once, builds a serve.CodecEngine (per-bank
plans, shape buckets warmed at startup, micro-batched dispatch) on
``--device`` (default cuda), and serves a stream of inpainting
observations: every image in --data, or file paths streamed one per
line on stdin (--stdin). Each request gets the reference protocol —
random --keep mask, normalized-convolution smooth fill, masked coding
against the pinned bank — and per-request PSNR + latency are reported,
with p50/p99 and bucket occupancy at the end.

--replicas N (or --max-queue-depth, or --tenant) serves through the
fault-tolerant fleet instead (serve.ServeFleet): N engine replicas
behind one front queue, health-driven requeue of a crashed/stalled
replica's requests, and admission control — an Overloaded refusal here
backs off for the fleet's (jittered) retry-after hint with exponential
escalation on consecutive same-class refusals (ResubmitBackoff) and
resubmits.

--min-replicas/--max-replicas put the fleet under the SLO-feedback
capacity controller (serve.CapacityController), which grows and shrinks
it inside the bounds. --federate [DIR] runs this process as one host of
a cross-process serving pool instead (serve.FederatedHost): it drains
the durable queue at DIR (default: the CCSC_DQUEUE_DIR env knob, which
``python -m ccsc_code_iccv2017_torch.supervise --federate DIR`` exports)
until a frontend seals it, under the --host-id identity.

--compile-cache DIR keeps the kernel libraries built in DIR, so a
restarted server loads them instead of running nvcc; --artifact-store
DIR shares them between hosts (serve.artifacts: a joining host fetches
the library another built); --staged-warmup serves the hottest bucket
while the others warm (serve.engine).

Usage:
    python -m ccsc_code_iccv2017_torch.apps.serve --filters f.mat \
        --data DIR [--bucket 64 --bucket 128:8] [--replicas 2]
    python -m ccsc_code_iccv2017_torch.apps.serve --filters f.mat \
        --federate QUEUE_DIR [--host-id H] [--bucket 256]
    ls imgs/*.png | python -m ccsc_code_iccv2017_torch.apps.serve \
        --filters f.mat --stdin
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


class ResubmitBackoff:
    """Escalating backoff for the resubmit loop, with SEPARATE
    consecutive-refusal counters per refusal class: ``BucketCold``
    (staged warmup still building a bucket's program — routine and
    transient while the capacity controller grows the fleet) and
    ``Overloaded`` (the admission ceiling) escalate independently, so
    a cold-bucket refusal during scale-up cannot inflate the overload
    backoff into minute-long sleeps (and vice versa). Each refusal
    honors the fleet's own (jittered) ``retry_after_s`` hint, doubled
    per consecutive same-class refusal up to ``2**MAX_DOUBLINGS`` and
    capped at ``CAP_S``."""

    CAP_S = 60.0
    MAX_DOUBLINGS = 5

    def __init__(self):
        self._consec: dict = {}

    def delay_for(self, exc) -> float:
        """Record one refusal and return how long to sleep before
        resubmitting. ``exc`` must carry ``retry_after_s``."""
        kind = type(exc).__name__
        n = self._consec.get(kind, 0) + 1
        self._consec[kind] = n
        return min(
            float(exc.retry_after_s)
            * (2 ** min(n - 1, self.MAX_DOUBLINGS)),
            self.CAP_S,
        )

    def consec(self, kind: str) -> int:
        return self._consec.get(kind, 0)

    def reset(self) -> None:
        """An admitted request clears all escalation."""
        self._consec.clear()


def build_parser() -> argparse.ArgumentParser:
    from ._common import (
        add_device_arg, add_mat_layout_arg, add_obs_args, add_perf_args,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--filters", default=None,
        help=".mat/.npz filter bank (or load one from a registry "
        "with --bank-registry/--bank-id)",
    )
    p.add_argument(
        "--bank-registry", default=None, metavar="DIR",
        help="durable bank registry (serve.registry.BankRegistry): "
        "--bank-id loads the served bank from it and --publish-bank "
        "publishes more banks onto the engine/fleet for "
        "bank-id-routed requests. Default: the CCSC_BANK_REGISTRY "
        "env knob",
    )
    p.add_argument(
        "--bank-id", default=None,
        help="serve this registry bank as the default bank instead "
        "of --filters (newest manifest wins — the registry's "
        "hot-swap convention)",
    )
    p.add_argument(
        "--publish-bank", action="append", default=None,
        metavar="ID",
        help="also publish this registry bank id onto the "
        "engine/fleet (repeatable): requests carrying bank_id route "
        "to it, and re-running with a re-published registry entry "
        "hot-swaps it with zero downtime",
    )
    p.add_argument(
        "--tenant", action="append", default=None, metavar="SPEC",
        help="declare a serving tenant (repeatable; fleet mode): "
        "NAME[:key=value,...] with keys bank, p50, p99, quota, "
        "weight — e.g. 'mobile:bank=bank-mobile,p99=250,quota=16,"
        "weight=2'. Tenants get weighted-fair admission, per-tenant "
        "quotas (explicit Overloaded refusals for a bursting tenant "
        "only), and per-tenant SLO histograms (serve.tenancy)",
    )
    p.add_argument(
        "--request-tenant", default=None, metavar="NAME",
        help="submit this CLI's own request stream under the named "
        "declared tenant (it then routes to the tenant's bank and "
        "counts against its quota and SLO histogram); default: "
        "untenanted traffic",
    )
    p.add_argument(
        "--deadline-ms", type=float, default=None,
        help="end-to-end per-request deadline budget in ms: requests "
        "still undelivered past it resolve as DeadlineExceeded "
        "instead of waiting (terminal — the loop never resubmits an "
        "expired request). Default: the tenant's deadline= spec, "
        "else CCSC_REQ_DEADLINE_MS, unset = unbounded",
    )
    src = p.add_mutually_exclusive_group()
    src.add_argument("--data", help="serve every image in this folder")
    src.add_argument(
        "--stdin", action="store_true",
        help="serve image paths streamed one per line on stdin",
    )
    src.add_argument(
        "--federate", nargs="?", const="", default=None,
        metavar="DIR",
        help="run as a federated host: drain the shared durable "
        "queue at DIR (serve.FederatedHost) until a frontend seals "
        "it, instead of serving --data/--stdin. With no DIR, the "
        "CCSC_DQUEUE_DIR env knob (supervise --federate exports it)",
    )
    p.add_argument(
        "--host-id", default=None,
        help="federated host identity: the name of this host's lease "
        "dir and heartbeat record in the queue (default: "
        "<hostname>-<pid>)",
    )
    p.add_argument(
        "--bucket", action="append", default=None, metavar="SIDE[:SLOTS]",
        help="shape bucket: spatial side and optional concurrent "
        "request slots (default slots 4; repeatable; default buckets "
        "64 and 128). Requests are padded to the smallest bucket that "
        "fits, mask-excluded so valid-region results are unchanged.",
    )
    p.add_argument(
        "--max-wait-ms", type=float, default=5.0,
        help="micro-batch flush deadline: a bucket dispatches when "
        "full or when its oldest request has waited this long",
    )
    p.add_argument(
        "--mesh", default=None, metavar="BATCH[xFREQ]",
        help="serve each bucket from a device MESH "
        "(ServeConfig.mesh_shape): the bucket's slots are sharded "
        "over BATCH devices (each device solves "
        "slots/BATCH independent requests — same-bucket results "
        "bit-identical to a single-device engine), optionally x FREQ "
        "frequency-parallel devices per slot (e.g. '4' or '4x2'; "
        "every bucket's slots must divide by BATCH). Default: the "
        "CCSC_SERVE_MESH env knob, unset = single-device. With "
        "--replicas every replica serves from its own mesh "
        "(disjoint device slices while the pool lasts)",
    )
    p.add_argument(
        "--compile-cache", default=None,
        help="directory the kernel libraries are built into and kept "
        "in (CCSC_COMPILE_CACHE env equivalent): a warm restart loads "
        "them instead of running nvcc",
    )
    p.add_argument(
        "--replicas", type=int, default=1,
        help="serve through a fault-tolerant fleet of N engine "
        "replicas (serve.ServeFleet): health-driven requeue on a "
        "crashed or stalled replica, idempotent delivery, admission "
        "control with a predictable overload ladder. 1 (default) = a "
        "single bare engine",
    )
    p.add_argument(
        "--min-replicas", type=int, default=None,
        help="capacity-controller replica floor: with "
        "--max-replicas, serve through a fleet that "
        "serve.CapacityController grows and shrinks inside the "
        "bounds on queue pressure and SLO breaches",
    )
    p.add_argument(
        "--max-replicas", type=int, default=None,
        help="capacity-controller replica ceiling (see "
        "--min-replicas; both or neither)",
    )
    p.add_argument(
        "--max-queue-depth", type=int, default=None,
        help="fleet admission ceiling on queued requests (implies the "
        "fleet path even with --replicas 1); default: derived live "
        "from perfmodel.fleet_serving_bound",
    )
    p.add_argument(
        "--no-aot", action="store_true",
        help="skip the startup AOT warmup (buckets compile lazily on "
        "first use)",
    )
    p.add_argument(
        "--artifact-store", default=None,
        help="shared library store dir (serve.artifacts; "
        "CCSC_ARTIFACT_STORE env equivalent): warmup fetches the kernel "
        "library another host built, keyed by source, flags, compiler "
        "and chip, instead of building it, and publishes what it had to "
        "build",
    )
    p.add_argument(
        "--staged-warmup", action="store_true",
        help="staged warmup (CCSC_SERVE_STAGED env equivalent): serve "
        "the hottest bucket as soon as it is warm while the others warm "
        "in the background; requests for a still-cold bucket are "
        "refused with a BucketCold retry-after",
    )
    p.add_argument(
        "--slo-p50-ms", type=float, default=None,
        help="declared p50 submit->result latency target in ms "
        "(serve.slo): breaches emit slo_breach obs events live "
        "(default: CCSC_SLO_P50_MS env, unset = no p50 SLO)",
    )
    p.add_argument(
        "--slo-p99-ms", type=float, default=None,
        help="declared p99 latency target in ms (see --slo-p50-ms)",
    )
    p.add_argument(
        "--metricsd-port", type=int, default=None,
        help="serve a stdlib Prometheus-text metrics endpoint on "
        "127.0.0.1:PORT (serve.metricsd; 0 = an ephemeral port, "
        "printed at startup). Default: CCSC_METRICSD_PORT env, "
        "unset = no endpoint",
    )
    p.add_argument(
        "--metricsd-snapshot", default=None,
        help="also write the metrics exposition atomically to this "
        "file every few seconds (scrape-less environments)",
    )
    p.add_argument(
        "--probe-dir", default=None, metavar="DIR",
        help="golden-probe store (serve.quality.ProbeSet): "
        "deterministic probe requests with content-addressed "
        "reference outcomes, scheduled through idle replicas every "
        "--probe-interval-s; a probe regression emits "
        "quality_probe_breach + an advisory demotion signal. "
        "Default: CCSC_PROBE_DIR env; '' disables",
    )
    p.add_argument(
        "--probe-interval-s", type=float, default=None,
        help="seconds between golden-probe sweeps (fleet mode; "
        "default CCSC_PROBE_INTERVAL_S env, unset/0 = probes off)",
    )
    p.add_argument(
        "--capture-dir", default=None,
        help="durably record every admitted request (arrival time, "
        "payloads content-addressed by sha256, outcome digest + PSNR "
        "+ latency) under this directory for deterministic replay "
        "(serve.capture). Default: the "
        "CCSC_CAPTURE_DIR env knob, unset = capture off",
    )
    p.add_argument("--keep", type=float, default=0.5,
                   help="observed fraction of each request")
    p.add_argument("--lambda-residual", type=float, default=5.0)
    p.add_argument("--lambda-prior", type=float, default=2.0)
    p.add_argument("--max-it", type=int, default=100)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out-dir", default=None, help="write 16-bit PNGs here")
    p.add_argument("--seed", type=int, default=0)
    add_perf_args(p)
    add_obs_args(p)
    add_mat_layout_arg(p)
    add_device_arg(p)
    return p


def _parse_buckets(specs, default_slots=4):
    if not specs:
        specs = ["64", "128"]
    out = []
    for spec in specs:
        side, _, slots = spec.partition(":")
        out.append(
            (int(slots) if slots else default_slots,
             (int(side), int(side)))
        )
    return tuple(out)


def _fleet_cfg(args, replicas, metrics_dir, tenants):
    """The fleet's configuration from the CLI's flags."""
    from ..config import FleetConfig

    return FleetConfig(
        replicas=replicas,
        max_queue_depth=args.max_queue_depth,
        metrics_dir=metrics_dir,
        slo_p50_ms=args.slo_p50_ms,
        slo_p99_ms=args.slo_p99_ms,
        metricsd_port=args.metricsd_port,
        metricsd_snapshot=args.metricsd_snapshot,
        capture_dir=args.capture_dir,
        tenants=tenants,
        probe_dir=args.probe_dir,
        probe_interval_s=args.probe_interval_s,
    )


def _serve_federated(args, queue_dir, d, prob, cfg, scfg, tenants):
    """``--federate``: this process is one host of the pool — its fleet
    drains the durable queue until a frontend seals it and every item
    is resolved somewhere in the pool. Returns the requests it
    served."""
    from ..ops.kernels import solve_z_rank1
    from ..serve.federation import FederatedHost

    host = FederatedHost(
        queue_dir, d, prob, cfg, scfg,
        # the fleet's stream nests under the host's metrics dir
        _fleet_cfg(args, args.replicas, None, tenants),
        host=args.host_id,
        metrics_dir=args.metrics_dir,
        device=args.device,
    )
    print(
        f"federated host {host.host} (epoch {host.epoch}) "
        f"joined {queue_dir} — draining until sealed",
        flush=True,
    )
    try:
        while not host.serve_until_sealed(timeout=5.0):
            pass
    except KeyboardInterrupt:
        print("interrupted — leaving the pool cleanly")
    finally:
        host.close()
    print(
        f"host {host.host} served {host.served} request(s), "
        f"left the pool (K1 launches {solve_z_rank1.launches})",
        flush=True,
    )
    return host.served


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..config import ProblemGeom, ServeConfig, SolveConfig
    from ..data.images import load_image_list
    from ..data.native import smooth_fill_batch
    from ..models.reconstruct import ReconstructionProblem
    from ..serve import (
        BucketCold,
        CodecEngine,
        DeadlineExceeded,
        Overloaded,
        ServeFleet,
    )
    from ..utils import env as _env
    from ..utils.io_mat import load_filters_2d

    federate_dir = args.federate
    if federate_dir == "":
        federate_dir = _env.env_str("CCSC_DQUEUE_DIR")
        if not federate_dir:
            raise SystemExit(
                "--federate with no DIR needs CCSC_DQUEUE_DIR set "
                "(python -m ccsc_code_iccv2017_torch.supervise "
                "--federate exports it)"
            )
    if federate_dir is None and not (args.data or args.stdin):
        raise SystemExit(
            "one of --data, --stdin or --federate is required"
        )

    # bank source: an explicit filter file, or the durable registry
    # (serve.registry) — the registry's newest manifest wins, which
    # is how a re-published bank reaches a restarted server
    from ..serve.registry import BankRegistry, resolve_registry_dir

    reg_dir = resolve_registry_dir(args.bank_registry)
    registry = None
    if args.bank_id or args.publish_bank:
        if not reg_dir:
            raise SystemExit(
                "--bank-id/--publish-bank need a registry: pass "
                "--bank-registry DIR or set CCSC_BANK_REGISTRY"
            )
    if reg_dir:
        registry = BankRegistry(reg_dir)
    if args.bank_id:
        d, manifest = registry.load(args.bank_id)
        from ..serve.registry import render_manifest

        print(f"serving registry bank {render_manifest(manifest)}")
    elif args.filters:
        d = load_filters_2d(args.filters)
    else:
        raise SystemExit(
            "one of --filters or --bank-registry + --bank-id is "
            "required"
        )
    tenants = None
    if args.tenant:
        from ..serve.tenancy import parse_tenant_spec

        try:
            tenants = tuple(
                parse_tenant_spec(s) for s in args.tenant
            )
        except ValueError as e:
            raise SystemExit(f"--tenant: {e}")
    if args.request_tenant is not None and not (
        tenants
        and any(s.tenant == args.request_tenant for s in tenants)
    ):
        raise SystemExit(
            f"--request-tenant {args.request_tenant!r} must name a "
            "tenant declared with --tenant"
        )
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    from ..utils import validate

    # fail on a garbage bank HERE, with the file named, before an
    # engine builds; per-request data is re-checked by the
    # engine's cheap submit-time boundary (validate.check_serve_request)
    validate.check_filters(d, geom)
    cfg = SolveConfig(
        lambda_residual=args.lambda_residual,
        lambda_prior=args.lambda_prior,
        max_it=args.max_it,
        tol=args.tol,
        fft_pad=args.fft_pad,
        fft_impl=args.fft_impl,
        verbose="none",
        track_objective=True,
        track_psnr=True,
    )
    mesh_shape = None
    if args.mesh is not None:
        from ..serve.engine import parse_mesh_shape

        try:
            mesh_shape = parse_mesh_shape(args.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")
    scfg = ServeConfig(
        buckets=_parse_buckets(args.bucket),
        max_wait_ms=args.max_wait_ms,
        compile_cache=args.compile_cache,
        aot_warmup=not args.no_aot,
        mesh_shape=mesh_shape,
        metrics_dir=args.metrics_dir,
        slo_p50_ms=args.slo_p50_ms,
        slo_p99_ms=args.slo_p99_ms,
        tune=args.tune,
        tune_store=args.tune_store,
        capture_dir=args.capture_dir,
        artifact_store=args.artifact_store,
        staged_warmup=True if args.staged_warmup else None,
    )
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if (args.min_replicas is None) != (args.max_replicas is None):
        raise SystemExit(
            "--min-replicas and --max-replicas must be given together"
        )
    ctrl_bounds = None
    if args.min_replicas is not None:
        if (
            args.min_replicas < 1
            or args.max_replicas < args.min_replicas
        ):
            raise SystemExit(
                "need 1 <= --min-replicas <= --max-replicas, got "
                f"{args.min_replicas}..{args.max_replicas}"
            )
        ctrl_bounds = (args.min_replicas, args.max_replicas)
    if federate_dir is not None:
        if ctrl_bounds is not None:
            raise SystemExit(
                "--min-replicas/--max-replicas are not supported in "
                "--federate mode (the controller manages a local "
                "fleet; host-level elasticity is "
                "serve.FederatedHostPool)"
            )
        if args.publish_bank:
            raise SystemExit(
                "--publish-bank is not supported in --federate mode "
                "yet (the queue protocol carries no bank ids)"
            )
        return _serve_federated(
            args, federate_dir, d, ReconstructionProblem(geom), cfg,
            scfg, tenants,
        )
    fleet_mode = (
        args.replicas > 1
        or args.max_queue_depth is not None
        # declared tenants need the fleet's admission layer (quotas,
        # weighted-fair lanes, per-tenant SLOs live there)
        or tenants is not None
        # the capacity controller is a fleet actuator
        or ctrl_bounds is not None
    )
    # controller-managed fleets start at the floor (the controller
    # grows from there on pressure); an explicit --replicas inside
    # the bounds is honored as the starting point
    n_replicas = args.replicas
    if ctrl_bounds is not None:
        n_replicas = min(
            max(n_replicas, ctrl_bounds[0]), ctrl_bounds[1]
        )
    metricsd = None  # standalone-engine endpoint (the fleet owns its own)
    ctrl = None
    t0 = time.perf_counter()
    if fleet_mode:
        engine = ServeFleet(
            d, ReconstructionProblem(geom), cfg, scfg,
            _fleet_cfg(args, n_replicas, args.metrics_dir, tenants),
            device=args.device,
        )
        print(
            f"fleet ready in {time.perf_counter() - t0:.2f}s "
            f"({n_replicas} replica(s), {engine.total_devices} "
            f"device(s), {len(scfg.buckets)} "
            f"bucket(s), queue ceiling {engine.queue_ceiling})"
        )
        if ctrl_bounds is not None:
            from .. import ControllerConfig
            from ..serve.controller import CapacityController
            from ..utils.memwatch import MemWatch

            ctrl = CapacityController(
                engine,
                ControllerConfig(
                    min_replicas=ctrl_bounds[0],
                    max_replicas=ctrl_bounds[1],
                ),
                memwatch=MemWatch(),
            ).start()
            print(
                "capacity controller active "
                f"({ctrl_bounds[0]}..{ctrl_bounds[1]} replicas, "
                f"tick {ctrl.interval_s}s)"
            )
    else:
        engine = CodecEngine(d, ReconstructionProblem(geom), cfg, scfg,
                             device=args.device)
        print(
            f"engine ready in {time.perf_counter() - t0:.2f}s "
            f"({len(scfg.buckets)} bucket(s)"
            + (
                f", mesh {'x'.join(str(a) for a in engine.mesh_shape)}"
                f" over {engine.devices} devices"
                if engine.mesh_shape
                else ""
            )
            + ")"
        )
        from ..serve.metricsd import MetricsD, resolve_endpoint

        md_port, snap = resolve_endpoint(
            args.metricsd_port, args.metricsd_snapshot,
            args.metrics_dir,
        )
        if md_port is not None or snap is not None:
            # best-effort, like the fleet's _start_metricsd: a bound
            # or privileged port must not crash the CLI after the
            # expensive engine warmup (and leak the unclosed engine).
            # A snapshot without a port is snapshot-only mode.
            try:
                metricsd = MetricsD(
                    engine.metrics, port=md_port, snapshot_path=snap,
                    run_id=f"serve-{os.getpid()}-{int(time.time())}",
                ).start()
            except Exception as e:
                metricsd = None
                print(
                    f"metrics endpoint failed to start "
                    f"({type(e).__name__}: {e}) — serving without it"
                )
            else:
                print(
                    "metrics "
                    + (
                        f"endpoint http://127.0.0.1:{metricsd.port}"
                        "/metrics"
                        if metricsd.port is not None
                        else "snapshot-only"
                    )
                    + (f", snapshot {snap}" if snap else "")
                )

    if args.publish_bank:
        # multi-bank serving: publish the named registry banks onto
        # the engine/fleet — bank_id-routed requests (and a later
        # re-publish under a new digest) hot-swap with zero downtime
        from ..serve.registry import render_manifest as _render_man

        for bid in args.publish_bank:
            arr, man = registry.load(bid)
            engine.publish_bank(bid, arr, tenant=man.get("tenant"))
            print(f"published {_render_man(man)}")

    rng = np.random.default_rng(args.seed)
    n_skipped = 0
    n_overloaded = 0
    n_deadline = 0

    def _submit(x, label):
        nonlocal n_skipped, n_overloaded, n_deadline
        mask = (rng.random(x.shape) < args.keep).astype(np.float32)
        sm = smooth_fill_batch(x[None], mask[None])[0]
        backoff = ResubmitBackoff()
        while True:
            try:
                fut = engine.submit(
                    x * mask, mask=mask, smooth_init=sm, x_orig=x,
                    tenant=args.request_tenant,
                    deadline_ms=args.deadline_ms,
                )
            except DeadlineExceeded as e:
                # TERMINAL, unlike the retryable pair below: an
                # expired budget cannot be fixed by backing off —
                # a resubmit would only arrive deader. Count it and
                # move to the next request.
                print(f"  {label}: DEADLINE EXCEEDED ({e})")
                n_deadline += 1
                return None
            except (Overloaded, BucketCold) as e:
                # explicit backpressure: the fleet told us how long
                # to back off — honor the (already jittered,
                # CCSC_FED_RETRY_JITTER) hint instead of dropping the
                # request, escalating exponentially on CONSECUTIVE
                # same-class refusals: a hint computed at the
                # admission ceiling describes the queue as it was,
                # and N producers re-colliding on it forever is the
                # thundering herd the jitter + escalation exist to
                # break up. BucketCold (staged warmup still building
                # this bucket's program — routine mid-scale-up) rides
                # its OWN counter so a cold bucket never inflates the
                # overload backoff (ResubmitBackoff).
                n_overloaded += 1
                delay = backoff.delay_for(e)
                why = (
                    "bucket cold"
                    if isinstance(e, BucketCold)
                    else "overloaded"
                )
                print(
                    f"  {label}: {why}, retrying in "
                    f"{delay:.2f}s"
                )
                time.sleep(delay)
                continue
            except validate.CCSCInputError as e:
                # one bad request (oversize for every bucket, NaN
                # pixels) must not abort a live serving stream —
                # report and move on
                print(f"  {label}: SKIPPED ({e})")
                n_skipped += 1
                return None
            return label, fut

    outs = []  # (label, result) kept only when PNGs are written
    n_done = 0

    def _finish(label, res):
        nonlocal n_done
        n_done += 1
        if args.out_dir:
            outs.append((label, res))
        psnr = f"{res.psnr:.2f} dB" if res.psnr is not None else "—"
        print(
            f"  {label}: bucket {res.bucket}, "
            f"{int(res.trace.num_iters)} iters, PSNR {psnr}, "
            f"latency {res.latency_s * 1e3:.1f} ms "
            f"(queued {res.wait_s * 1e3:.1f} ms)"
        )

    pending = []

    def _settle(label, fut):
        # a deadline expiry lands ON THE FUTURE (the serving side
        # resolved the request without solving it) — terminal for
        # this request, not for the stream
        nonlocal n_deadline
        try:
            res = fut.result(timeout=600)
        except DeadlineExceeded as e:
            print(f"  {label}: DEADLINE EXCEEDED ({e})")
            n_deadline += 1
            return
        _finish(label, res)

    def _drain(block=False):
        # print results AS THEY COMPLETE: a long-lived stdin producer
        # must see live output, and holding every Future (+ recon)
        # until EOF would grow without bound
        while pending and (block or pending[0][1].done()):
            label, fut = pending.pop(0)
            _settle(label, fut)

    MAX_IN_FLIGHT = 32
    try:
        if args.data:
            # per-image list, not a stacked batch: a serving folder
            # holds MIXED sizes (the reason shape buckets exist) and
            # each image is its own request anyway
            imgs = load_image_list(
                args.data, limit=args.limit, mat_layout=args.mat_layout
            )
            for i, img in enumerate(imgs):
                p = _submit(img.astype(np.float32), f"img{i}")
                if p is not None:
                    pending.append(p)
                _drain()
        else:
            # stdin streaming: one path per line; requests enter the
            # queue as they arrive so micro-batching works on live
            # traffic
            from PIL import Image

            n = 0
            for line in sys.stdin:
                path = line.strip()
                if not path:
                    continue
                try:
                    img = np.asarray(
                        Image.open(path).convert("L"), np.float32
                    ) / 255.0
                except Exception as e:
                    # a deleted/corrupt file in a live stream is a bad
                    # REQUEST, not a reason to kill the service — same
                    # skip-and-continue contract as _submit's checks
                    print(f"  {os.path.basename(path)}: SKIPPED ({e})")
                    n_skipped += 1
                    continue
                p = _submit(img, os.path.basename(path))
                if p is not None:
                    pending.append(p)
                _drain()
                if len(pending) >= MAX_IN_FLIGHT:
                    label, fut = pending.pop(0)
                    _settle(label, fut)
                n += 1
                if args.limit and n >= args.limit:
                    break
        _drain(block=True)
    finally:
        # the engine must always close (flushes queued dispatches,
        # writes the telemetry summary) — even when a mid-stream
        # failure aborts the submit loop. The controller stops first:
        # it is advisory, and must not resize a closing fleet
        if ctrl is not None:
            ctrl.close()
        if metricsd is not None:
            metricsd.stop()
        engine.close()
        try:
            _drain(block=True)  # results the close-flush completed
        except Exception:
            pass
    stats = engine.stats()
    if fleet_mode and stats["n_requests"]:
        print(
            f"{stats['n_requests']} requests over "
            f"{engine.replica_target} replica(s), "
            f"{stats['n_requeued']} requeued, "
            f"{n_overloaded} overload backoff(s), "
            f"{n_deadline} deadline-expired, p50 "
            f"{stats['p50_latency_s'] * 1e3:.1f} ms, p99 "
            f"{stats['p99_latency_s'] * 1e3:.1f} ms"
        )
    elif stats["n_requests"]:
        print(
            f"{stats['n_requests']} requests, "
            f"{stats['n_dispatches']} dispatch(es), mean occupancy "
            f"{100 * stats['mean_occupancy']:.0f}%, p50 "
            f"{stats['p50_latency_s'] * 1e3:.1f} ms, p99 "
            f"{stats['p99_latency_s'] * 1e3:.1f} ms"
        )

    if args.out_dir and outs:
        os.makedirs(args.out_dir, exist_ok=True)
        from PIL import Image

        for label, res in outs:
            arr = np.clip(res.recon, 0.0, 1.0)
            Image.fromarray((arr * 65535.0).astype(np.uint16)).save(
                os.path.join(args.out_dir, f"recon_{label}.png")
            )
        print(f"wrote {len(outs)} PNGs to {args.out_dir}")
    return n_done


if __name__ == "__main__":
    main()
