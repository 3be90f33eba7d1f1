"""Fault-tolerant serving fleet: replicated engines behind one queue
(the torch port of ``ccsc_code_iccv2017_tpu.serve.fleet``, in one
process).

One :class:`~.engine.CodecEngine` has no survival story: an engine
stall or crash loses every queued request, and overload has no
admission path short of running out of memory. :class:`ServeFleet` is
the fleet layer — N engine replicas that share NOTHING but a front
queue (the MPAX fleet of solver instances over pinned problem
structure, PAPERS.md arXiv:2412.09734; the batch of independent n=1
solves means replicas need no coordination beyond request ownership):

1. **Durable front queue + idempotency keys.** Durability is against
   REPLICA failure: every request carries an idempotency key, a
   replica owns the requests it has taken, and when a replica dies or
   stalls its undelivered requests are requeued (at the front — they
   already waited their turn) onto survivors. Delivery is
   at-most-once (a recovered straggler's late result for an
   already-delivered key is suppressed, counted as
   ``fleet_duplicate_suppressed``) and each request resolves
   exactly-once-or-error: after ``FleetConfig.max_attempts`` failed
   ownerships the future gets an explicit error instead of silent
   retry-forever.
2. **Health-driven drain.** Each replica worker arms a per-replica
   :class:`~..utils.watchdog.DispatchWatchdog` (event mode + the
   ``on_stall`` authority hook) around its dispatch fence — the same
   deadline rules as the learners' fences (MIN_S floor, first-fence
   allowance, self-calibration against observed clean fences). A
   stalled or dead replica is retired, its requests are requeued, and
   a replacement engine is rebuilt in the same process under a
   per-replica restart budget with exponential backoff (the kernel
   library is already loaded, so a restart builds plans and nothing
   else). Injected chaos (``CCSC_FAULT_ENGINE_KILL_REQ`` /
   ``CCSC_FAULT_ENGINE_HANG_REQ``, utils.faults, fire-once per
   replica) makes both paths provable on the CPU
   (tests/test_torch_fleet.py).
3. **Admission control + predictable overload.** ``submit`` refuses
   work beyond a queue-depth ceiling — explicit
   (``FleetConfig.max_queue_depth``) or derived live from
   ``utils.perfmodel.fleet_serving_bound`` x ``max_queue_s`` —
   raising :class:`Overloaded` with a retry-after hint instead of
   growing the queue without bound. Below the ceiling a three-rung
   ladder keeps latency predictable: rung 1 sheds the ``max_wait_ms``
   micro-batch waiting (``set_max_wait_ms(0)``), rung 2 rejects new
   requests, rung 3 (sustained rejection) recycles replicas onto a
   degraded solve budget (``max_it`` x ``degrade_max_it_factor``,
   each transition a ``degrade`` obs event).

Devices: ``ServeFleet(..., device="cuda")`` passes its device to every
replica engine. Unmeshed replicas share that one device; mesh replicas
(``FleetConfig.replica_meshes`` / ``ServeConfig.mesh_shape``) get
disjoint slices of the pool — ``ServeConfig.mesh_devices`` when pinned,
else the ``torch.cuda.device_count()`` visible cards — or the
``CCSC_SERVE_MESH_STRICT`` refusal. On the CPU every position is the
CPU, so the pool is as large as the meshes ask.

Telemetry: the fleet stream (``FleetConfig.metrics_dir``) carries
``fleet_heartbeat`` (per replica: state/served/inflight — the
liveness signal ``utils.watchdog.check_replicas`` and the JAX
package's ``scripts/obs_report.py`` FLEET section read),
``fleet_request`` / ``fleet_requeue`` / ``fleet_duplicate_suppressed``,
replica lifecycle (``fleet_replica_dead`` / ``_restart`` / ``_ready`` /
``_abandoned``), ``fleet_admission_reject``, ``fleet_ceiling`` and
``fleet_overload`` rung transitions; every record carries a
``replica_id`` field (None for fleet-scope records). Each replica
engine's own serve_* stream lands in a ``replica-NN/`` subdir
(``obs.read_events(recursive=True)`` merges them).

Exactness: replicas are built from the same pinned
(bank, problem, SolveConfig, ServeConfig), and a slot's solve does not
depend on its slot index or its batch-mates, so a request served by
ANY replica — including after a mid-stream handoff — is bit-identical
to a single unfaulted engine's serve of the same request. Only rung 3
trades solve budget for latency, and it announces itself in the
stream.

Multi-tenancy (serve.registry / serve.tenancy): ``submit`` routes by
``bank_id`` (explicit, or the tenant's declared default) and binds
the bank's DIGEST at admission; ``publish_bank`` hot-swaps a bank id
to a new digest with zero downtime (staggered per-replica plan
builds, one atomic route flip, a ``bank_swap`` event with both
digests — in-flight requests finish on their admission-time plan).
With ``FleetConfig.tenants`` declared, the front queue becomes
weighted-fair per-tenant lanes, admission enforces per-tenant quotas
(``tenant_reject`` + :class:`Overloaded` for the bursting tenant
only), and each tenant's submit->result latency streams into its own
SLO histogram judged against its own declared targets
(serve.slo.TenantSlos).
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..config import FleetConfig, ServeConfig, SolveConfig
from ..utils import env as _env
from ..utils import trace as trace_util
from ..utils.device import resolve_device
from . import capture as _capture
from . import metricsd as _metricsd_mod
from . import quality as _quality
from . import registry as _registry
from . import slo as _slo
from . import tenancy as _tenancy
from .engine import (
    BucketCold,
    CodecEngine,
    DeadlineExceeded,
    ServedResult,
    _bucket_name,
    _device_pool,
    parse_mesh_shape,
    pick_bucket,
)

__all__ = [
    "ServeFleet", "Overloaded", "BucketCold", "DeadlineExceeded",
    "RUNGS",
]

# the overload ladder, least to most drastic
RUNGS = ("normal", "shed_batching", "reject", "degrade")


def _ms_to_s(v):
    return None if v is None else v / 1e3


class Overloaded(RuntimeError):
    """Admission refusal: the fleet's queue is at its ceiling. Carries
    ``retry_after_s`` — the caller should back off that long before
    resubmitting (explicit backpressure instead of silent queue growth
    and eventual OOM)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass
class _FleetRequest:
    key: str
    b: np.ndarray
    mask: Optional[np.ndarray]
    smooth_init: Optional[np.ndarray]
    x_orig: Optional[np.ndarray]
    future: Future
    t_submit: float
    attempts: int = 0  # ownerships so far (incremented at take)
    # -- multi-tenant routing (serve.registry / serve.tenancy): the
    # tenant the request was admitted under (its weighted-fair lane,
    # quota and SLO accounting), the effective bank id, and the bank
    # DIGEST bound at admission — a hot-swap republishing the bank id
    # mid-queue must never retarget already-admitted requests, and a
    # requeued casualty re-serves against the SAME digest on any
    # replica (every replica retains every published bank's plans)
    tenant: Optional[str] = None
    bank_id: Optional[str] = None
    digest: str = ""
    # -- request-level tracing (utils.trace). The span context RIDES
    # the request through every requeue, so one trace survives
    # replica kills/restarts: root_span covers submit->resolution,
    # queue_span the open queue episode (re-opened per requeue),
    # attempt_span the open replica ownership. Ids are assigned under
    # the fleet lock; emission always happens OUTSIDE it. trace_id
    # None (white-box-constructed requests) disables span emission.
    trace_id: Optional[str] = None
    root_span: Optional[str] = None  # assigned once, never cleared
    # claim-to-emit pointers: a path that will emit the span_end
    # first CLAIMS the id under the lock (reads it and clears the
    # field / sets root_done), so racing paths can never double-end
    queue_span: Optional[str] = None
    attempt_span: Optional[str] = None
    # owning replica of the OPEN attempt span: a straggler that wins
    # the delivery race after a requeue would otherwise end the NEW
    # owner's span as its own ok (misattributing the solve in the
    # reassembled story)
    attempt_rep: Optional[int] = None
    root_done: bool = False
    t_wall: float = 0.0  # wall-clock submit time (span timestamps)
    queue_t: float = 0.0  # wall-clock start of the open queue episode
    attempt_t: float = 0.0  # wall-clock start of the open ownership
    # -- request lifecycle. deadline is the ABSOLUTE
    # end-to-end budget (wall-clock epoch seconds) stamped at
    # admission; None = unbounded. A hedged request exists as TWO
    # _FleetRequest instances sharing key, future, trace_id, root_span:
    # the original (hedged=True once its clone is queued) and the
    # clone (hedge_of=True), each with its own queue/attempt span
    # slots so both attempts are visible in the reassembled trace.
    # `primary` points the clone at the original — the shared
    # root-span claim (root_done) lives on ONE instance so the two
    # delivery races can never double-end the root. `not_replica`
    # excludes the clone from the replica whose slow attempt it
    # hedges against (first result wins through the _delivered
    # fencing; the loser ends its attempt span `hedge_lost`).
    deadline: Optional[float] = None
    hedged: bool = False
    hedge_of: bool = False
    not_replica: Optional[int] = None
    primary: Optional["_FleetRequest"] = None


class _Replica:
    """One engine replica: identity, worker thread, health state.

    ``state``: 'live' -> ('dead' | 'stalled' | 'recycling') ->
    replaced by a fresh _Replica of the same id (generation + 1).
    ``retired`` flags the worker to stop taking work; a wedged worker
    that later wakes finds it set and exits after its (suppressed)
    deliveries."""

    def __init__(self, rid: int, generation: int, engine: CodecEngine,
                 watchdog, degraded: bool = False) -> None:
        self.id = rid
        self.generation = generation
        self.engine = engine
        self.watchdog = watchdog
        self.degraded = degraded  # built on the reduced solve budget?
        self.state = "live"
        self.retired = False
        # the casualty handoff (requeue + replacement scheduling) has
        # run for this replica — exactly one of the stall handler, the
        # death handler, or the worker's clean recycle exit performs
        # it (a recycle marks `retired` without handing off, so the
        # handoff is still owed if the worker then crashes or stalls)
        self.reaped = False
        self.req_seq = 0  # requests taken, lifetime of this generation
        self.served = 0
        self.assigned: List[_FleetRequest] = []
        self.thread: Optional[threading.Thread] = None


class ServeFleet:
    """N replicated CodecEngines behind one durable front queue.

    API mirrors :class:`~.engine.CodecEngine` — ``submit`` returns a
    Future of :class:`~.engine.ServedResult`, plus ``reconstruct`` /
    ``serve_many`` / ``stats`` / ``close`` / context manager — with
    two additions: ``submit`` takes an optional idempotency ``key``
    and may raise :class:`Overloaded`. ``device`` (default ``"cuda"``)
    is every replica engine's device; it raises when CUDA is absent.
    """

    def __init__(self, d, prob, cfg: SolveConfig,
                 serve_cfg: ServeConfig, fleet_cfg: FleetConfig,
                 blur_psf=None, device="cuda"):
        from ..utils import obs, validate

        self._close_lock = threading.Lock()
        self._close_started = False
        self._close_done = threading.Event()
        # set by close(): wakes restart threads out of their backoff
        # sleep so they can be joined instead of left running engine
        # construction (a daemon thread still building an engine at
        # interpreter exit would tear CUDA down under it)
        self._closing = threading.Event()
        self._restart_threads: List[threading.Thread] = []
        self._recycle_thread: Optional[threading.Thread] = None

        self._device = resolve_device(device)
        # fail on a garbage bank/config ONCE, before N engines build
        validate.check_solve_config(cfg)
        validate.check_filters(d, prob.geom)
        self.geom = prob.geom
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.fleet_cfg = fleet_cfg
        self._d = d
        self._prob = prob
        self._blur_psf = blur_psf
        # already normalized + volume-sorted by ServeConfig.__post_init__
        self.buckets = serve_cfg.buckets
        self._total_slots = sum(s for s, _ in self.buckets)
        self._take_cap = max(s for s, _ in self.buckets)

        # heterogeneous replica shapes (FleetConfig.replica_meshes:
        # per-replica mesh shape or None; default = every replica
        # inherits ServeConfig.mesh_shape, resolving the
        # CCSC_SERVE_MESH env fallback HERE — N engines each
        # resolving the knob themselves would all land on the same
        # default device prefix while the capacity math counted them
        # as distinct hardware). Entries are normalized to a concrete
        # shape or () (the explicit single-device pin), so replica
        # topology is frozen at fleet construction and restarts
        # rebuild exactly it. Mesh replicas get DISJOINT device
        # slices — a pool that cannot supply them is refused up
        # front (CCSC_SERVE_MESH_STRICT, default on): overlapping
        # slices would let capacity_hint / the derived admission
        # ceiling credit devices that do not exist.
        import math as _math

        default_mesh = serve_cfg.mesh_shape
        env_malformed = False
        if default_mesh is None:
            spec = _env.env_str("CCSC_SERVE_MESH")
            if spec:
                try:
                    default_mesh = parse_mesh_shape(spec)
                except ValueError:
                    # keep the entries None (NOT the () pin) so each
                    # engine's own resolution re-parses the malformed
                    # spec and refuses with the named CCSCInputError
                    # — a typo'd knob must error, never silently
                    # serve at 1/prod(mesh) capacity
                    env_malformed = True
        if fleet_cfg.replica_meshes is not None:
            self._replica_mesh = [
                tuple(m) if m else () for m in fleet_cfg.replica_meshes
            ]
        elif env_malformed:
            self._replica_mesh = [None] * fleet_cfg.replicas
        else:
            self._replica_mesh = [
                tuple(default_mesh) if default_mesh else ()
            ] * fleet_cfg.replicas
        # the shape a replica GROWN past the startup set inherits
        # (set_replica_count): the same default every startup replica
        # would get — None propagates the malformed-spec refusal
        self._default_mesh_entry = (
            None if env_malformed
            else (tuple(default_mesh) if default_mesh else ())
        )
        self._replica_devices: List[Optional[tuple]] = (
            [None] * fleet_cfg.replicas
        )
        # device-slice allocation survives growth: the pool and the
        # high-water offset persist so a replica grown later still
        # gets a DISJOINT slice (or the strict refusal)
        self._mesh_pool: Optional[List[int]] = None
        self._mesh_off = 0
        if any(m for m in self._replica_mesh):
            # the allocation POOL: an operator-pinned
            # ServeConfig.mesh_devices (e.g. steering the fleet off
            # devices a colocated learner owns) is honored as the
            # pool the slices are cut from — a standalone engine
            # honors the pin, so moving to a fleet must not silently
            # change which silicon serves
            if serve_cfg.mesh_devices is not None:
                pool = list(serve_cfg.mesh_devices)
            else:
                pool = self._device_positions(sum(
                    _math.prod(m) for m in self._replica_mesh if m))
            self._mesh_pool = pool
            off = 0
            short: List[int] = []
            for rid, shape in enumerate(self._replica_mesh):
                if not shape:
                    continue
                need = _math.prod(shape)
                if off + need <= len(pool):
                    self._replica_devices[rid] = tuple(
                        pool[off:off + need]
                    )
                    off += need
                else:
                    short.append(rid)
            self._mesh_off = off
            if short and _env.env_flag("CCSC_SERVE_MESH_STRICT"):
                from ..utils import validate

                total_need = sum(
                    _math.prod(m)
                    for m in self._replica_mesh
                    if m
                )
                pool_desc = (
                    f"the pinned mesh_devices pool {tuple(pool)}"
                    if serve_cfg.mesh_devices is not None
                    else f"the {len(pool)} visible device(s)"
                )
                raise validate.CCSCInputError(
                    f"replica meshes "
                    f"{[m or None for m in self._replica_mesh]} need "
                    f"{total_need} device(s) for disjoint slices but "
                    f"{pool_desc} cannot supply them (replica(s) "
                    f"{short} left without a slice) — shrink the "
                    "meshes or replica count, pin a pool that repeats "
                    "a card (ServeConfig.mesh_devices), or set "
                    "CCSC_SERVE_MESH_STRICT=0 to let slices overlap "
                    "(the admission ceiling then over-credits the "
                    "shared devices)"
                )
            # non-strict: the short replicas fall back to the engine's
            # default device prefix (overlapping a sibling)

        self._cv = threading.Condition()
        # multi-tenant admission (serve.tenancy): declared tenants
        # get their own weighted-fair lanes, quotas, and SLO
        # monitors; with no tenants declared the scheduler degrades
        # to the historical single FIFO exactly
        self._tenants = _tenancy.TenantTable(fleet_cfg.tenants)
        self._queue = _tenancy.WeightedFairScheduler(self._tenants)
        self._tenant_slos = _slo.TenantSlos(fleet_cfg.tenants)
        self._tenant_delivered: Dict[str, int] = {}
        self._tenant_rejects: Dict[str, int] = {}
        # bank routing (serve.registry): bank_id -> digest, flipped
        # atomically by publish_bank (the fleet-wide hot-swap);
        # retained bank bytes let a restarted replica republish every
        # bank before it takes work
        default_digest = _registry.bank_digest(d)
        self._bank_routes: Dict[Optional[str], str] = {
            None: default_digest
        }
        self._bank_arrays: Dict[str, np.ndarray] = {
            default_digest: np.asarray(d)
        }
        self._index: Dict[str, _FleetRequest] = {}  # queued/assigned
        # served / failed idempotency keys, BOUNDED to the newest
        # FleetConfig.key_window each (insertion order = eviction
        # order): a long-lived fleet must not grow per-request state
        # forever — suppression and resubmit refusal hold within the
        # window, which only a straggler delayed by key_window
        # requests can outlive
        self._delivered: "OrderedDict[str, None]" = OrderedDict()
        # keys whose future got an error (max_attempts / no capacity):
        # a late straggler result for one is suppressed, and the key is
        # spent — exactly-once-OR-error, never both
        self._failed_keys: "OrderedDict[str, None]" = OrderedDict()
        # replica ids whose restart budget is exhausted — these never
        # come back; every OTHER retired replica has a restart pending
        self._abandoned: set = set()
        # latency sample for the stats percentiles, newest
        # latency_window deliveries (the delivered COUNT is
        # _n_delivered, which never truncates)
        self._latencies: Deque[float] = deque(
            maxlen=fleet_cfg.latency_window
        )
        self._n_delivered = 0
        self._seq = 0
        self._n_requeued = 0
        self._n_duplicates = 0
        self._n_rejected = 0
        self._n_failed = 0
        # -- request lifecycle: deadline/cancel/hedge
        # counters; per-replica recent-latency histograms (engine-
        # side solve latency, so fleet queueing noise — identical
        # across replicas — can't mask a gray one) feeding the
        # adaptive hedge_after quantile and the gray-failure scores
        self._n_admitted = 0
        self._n_deadline = 0
        self._n_cancelled = 0
        self._n_hedges = 0
        self._n_hedge_wins = 0
        self._lat_hist = _slo.Histogram()
        self._rep_hist: Dict[int, _slo.Histogram] = {}
        # replica ids currently judged gray (sustained latency
        # outlier vs the fleet median — slow-but-alive, DISTINCT from
        # the watchdog's stall detector) + their latest factor; the
        # fleet_gray_replica advisory fires once per excursion
        self._gray_now: set = set()
        self._gray_score: Dict[int, float] = {}
        self._restarts: Dict[int, int] = {}
        self._replicas: List[Optional[_Replica]] = [None] * (
            fleet_cfg.replicas
        )
        # -- elasticity (serve.controller / set_replica_count): the
        # fleet's replica count is a TARGET, not a constant. The list
        # above only ever grows; a slot retired by scale-down lands in
        # _scaled_down (excluded from capacity math and the dead-fleet
        # checks) until a later grow resurrects it. _slot_gen remembers
        # the last generation a drained slot served at, so a
        # resurrection keeps the per-slot generation monotonic (the
        # recycle walker's replacement test relies on it).
        self._replica_target = fleet_cfg.replicas
        self._scaled_down: set = set()
        self._slot_gen: Dict[int, int] = {}
        # gauges a CapacityController publishes through the fleet's
        # metrics surface (metricsd renders ccsc_ctrl_*); the breaker
        # gauge exists (closed) even with no controller attached
        self._ctrl_gauges: Dict[str, float] = {"ctrl_breaker_open": 0}
        self._degraded = False
        # controller-driven brownout (set_brownout): holds the
        # degraded solve budget independent of the overload ladder —
        # a rung-0 restore must not undo it
        self._brownout = False
        self._recycling = False
        self._rung = 0
        self._rung2_since: Optional[float] = None
        self._bound_rps = 0.0
        self._ceiling_derived = False
        self._ceiling = fleet_cfg.max_queue_depth or max(
            fleet_cfg.min_queue_depth,
            2 * self._total_slots * fleet_cfg.replicas,
        )
        # fleet-wide SLO layer (serve.slo): submit->result latency —
        # the path a CLIENT sees, including fleet queueing and requeue
        # retries a replica-local histogram cannot observe. Checked on
        # the monitor thread; breaches are fleet-scope events.
        self._slo = _slo.SloMonitor(
            _slo.resolve_targets(
                fleet_cfg.slo_p50_ms, fleet_cfg.slo_p99_ms
            )
        )
        # quality plane (serve.quality): per-(bank, tenant, bucket)
        # dB histograms, declared tenant floors
        # (TenantSpec.min_psnr_db), and the per-bank drift watch
        # judged against kind=quality ledger history. Checked on the
        # monitor thread beside the SLO tick; golden probes (below)
        # run on their own thread at probe_interval_s.
        self._quality = _quality.QualityMonitor(
            specs=fleet_cfg.tenants,
            drift_band_for=self._quality_drift_band,
        )
        # advisory demotion signals (quality_demote_advice): appended
        # on probe regression / drift, deduped per (bank, digest,
        # reason) excursion; a registry/controller — or the chaos
        # harness — consumes them via quality_advice()
        self._quality_advice: List[Dict] = []
        self._advice_seen: set = set()
        # bank_id -> the digest it routed to BEFORE the latest swap
        # (the advisory's to_digest — what a demotion restores)
        self._bank_prev: Dict[Optional[str], str] = {}
        self._n_probe_failures = 0
        self._probe_set: Optional[_quality.ProbeSet] = None
        self._probe_seq = 0
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_dir = _quality.resolve_probe_dir(
            fleet_cfg.probe_dir
        )
        _pi = fleet_cfg.probe_interval_s
        if _pi is None:
            _pi = _env.env_float("CCSC_PROBE_INTERVAL_S")
        self._probe_interval_s = float(_pi) if _pi else 0.0
        self._metricsd = None
        self._capture: Optional[_capture.WorkloadRecorder] = None
        self._t_start = time.time()
        # fleet run identity: stamped into the metricsd snapshot so a
        # stale metrics.prom left by a DEAD fleet is distinguishable
        # from this one's
        self.run_id = f"fleet-{os.getpid()}-{int(self._t_start)}"

        self._run = obs.start_run(
            fleet_cfg.metrics_dir,
            algorithm="serve_fleet",
            verbose=fleet_cfg.verbose,
            geom=prob.geom,
            cfg=cfg,
            device=self._device,
            replicas=fleet_cfg.replicas,
            buckets=[
                {"slots": s, "spatial": list(sp)}
                for s, sp in self.buckets
            ],
            max_queue_depth=fleet_cfg.max_queue_depth,
        )
        try:
            for rid in range(fleet_cfg.replicas):
                self._replicas[rid] = self._spawn_replica(
                    rid, generation=0, degraded=False
                )
            self._emit(
                "fleet_start",
                replica_id=None,
                replicas=fleet_cfg.replicas,
                queue_ceiling=self._ceiling,
                # per-replica device topology: a mixed mesh /
                # single-device fleet is readable from this one record
                replica_devices=[
                    rep.engine.devices if rep is not None else None
                    for rep in self._replicas
                ],
                total_devices=self.total_devices,
                ceiling_source=(
                    "explicit" if fleet_cfg.max_queue_depth
                    else "static_floor"
                ),
            )
            cap_dir = _capture.resolve_capture_dir(
                fleet_cfg.capture_dir
            )
            if cap_dir:
                # admission-level capture: ONE recorder at the fleet
                # boundary (replica engines never capture — N copies
                # of the same stream would not be a workload record)
                self._capture = _capture.WorkloadRecorder(
                    cap_dir,
                    sample=fleet_cfg.capture_sample,
                    emit=lambda type_, **f: self._emit(
                        type_, replica_id=None, **f
                    ),
                    meta={
                        "source": "serve_fleet",
                        "run_id": self.run_id,
                        "replicas": fleet_cfg.replicas,
                        "buckets": [
                            {"slots": s, "spatial": list(sp)}
                            for s, sp in self.buckets
                        ],
                        "geom": {
                            "spatial_support": list(
                                self.geom.spatial_support
                            ),
                            "num_filters": self.geom.num_filters,
                        },
                        "solve": {
                            "max_it": cfg.max_it,
                            "tol": cfg.tol,
                            "lambda_residual": cfg.lambda_residual,
                            "lambda_prior": cfg.lambda_prior,
                        },
                        # replicas resolve tuning themselves, so the
                        # solve dict above is the PRE-tune config; a
                        # replay must re-resolve under the same mode
                        # (same chip + store reproduces the arm) for
                        # bit parity to hold
                        "tune": serve_cfg.tune,
                    },
                )
            self._stop_monitor = threading.Event()
            self._hb_last = 0.0
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="ccsc-fleet-monitor",
                daemon=True,
            )
            self._monitor.start()
            if self._probe_interval_s > 0 and self._probe_dir:
                self._probe_thread = threading.Thread(
                    target=self._probe_loop,
                    name="ccsc-fleet-probes",
                    daemon=True,
                )
                self._probe_thread.start()
            self._start_metricsd()
        except BaseException:
            with self._close_lock:
                self._close_started = True
            self._closing.set()
            self._close_done.set()
            if self._metricsd is not None:
                try:
                    self._metricsd.stop()
                except Exception:
                    pass
            if self._capture is not None:
                try:
                    self._capture.close(status_note="init_failed")
                except Exception:
                    pass
            for rep in self._replicas:
                if rep is not None:
                    try:
                        rep.watchdog.stop()
                    except Exception:
                        pass
                    try:
                        rep.engine.close()
                    except Exception:
                        pass
            self._run.close(status="error")
            raise
        self._run.console(
            f"fleet: {fleet_cfg.replicas} replica(s) live, queue "
            f"ceiling {self._ceiling}",
            tier="brief",
        )

    def _device_positions(self, need: int) -> List[int]:
        """The mesh slices' allocation pool when no
        ``ServeConfig.mesh_devices`` pins one: the index of every
        visible card (the engine's ``_device_pool``), or on the CPU as
        many positions as asked (every position is the CPU)."""
        pool = _device_pool(self._device)
        return list(range(need if pool is None else len(pool)))

    # -- telemetry -----------------------------------------------------
    def _emit(self, type_: str, *, replica_id, **fields) -> None:
        """Single emission point for fleet records: ``replica_id`` is
        a REQUIRED argument (None only for fleet-scope records like
        admission/ceiling) so per-replica attribution can never be
        forgotten silently — the companion of the engine's ``_emit``,
        both lint-enforced."""
        self._run.event(type_, replica_id=replica_id, **fields)

    # -- live metrics surface ------------------------------------------
    def _start_metricsd(self) -> None:
        """Start the stdlib Prometheus endpoint + snapshot file
        (serve.metricsd) when FleetConfig.metricsd_port or
        CCSC_METRICSD_PORT asks for one. Best-effort: a port conflict
        must not take the fleet down with it."""
        from . import metricsd as metricsd_mod

        port, snap = metricsd_mod.resolve_endpoint(
            self.fleet_cfg.metricsd_port,
            self.fleet_cfg.metricsd_snapshot,
            self.fleet_cfg.metrics_dir,
        )
        if port is None and snap is None:
            return
        try:
            self._metricsd = metricsd_mod.MetricsD(
                self.metrics, port=port, snapshot_path=snap,
                run_id=self.run_id,
            ).start()
        except Exception as e:
            self._metricsd = None
            self._run.console(
                f"fleet: metrics endpoint failed to start "
                f"({type(e).__name__}: {e}) — serving without it",
                tier="always",
            )
            return
        self._emit(
            "fleet_metricsd", replica_id=None,
            port=self._metricsd.port, snapshot=snap,
        )
        self._run.console(
            "fleet: metrics "
            + (
                f"endpoint http://127.0.0.1:{self._metricsd.port}"
                "/metrics"
                if self._metricsd.port is not None
                else "snapshot-only"
            )
            + (f", snapshot {snap}" if snap else ""),
            tier="brief",
        )

    def metrics(self) -> Dict[str, object]:
        """Live counters/gauges/histograms in the shared shape
        ``serve.metricsd.render_prometheus`` renders. The request
        counter is ``_n_delivered`` — the never-truncating delivered
        count, so a scrape equals the number of served requests
        EXACTLY (the metricsd acceptance contract)."""
        with self._cv:
            counters = {
                "requests_total": self._n_delivered,
                "rejected_total": self._n_rejected,
                "requeued_total": self._n_requeued,
                "duplicates_suppressed_total": self._n_duplicates,
                "failed_total": self._n_failed,
                "probe_failures_total": self._n_probe_failures,
                # request lifecycle: rendered as
                # ccsc_hedges_total / ccsc_hedge_wins_total /
                # ccsc_deadline_exceeded_total / ccsc_cancelled_total
                "hedges_total": self._n_hedges,
                "hedge_wins_total": self._n_hedge_wins,
                "deadline_exceeded_total": self._n_deadline,
                "cancelled_total": self._n_cancelled,
            }
            n_live = sum(
                1 for r in self._replicas
                if r is not None and r.state == "live"
            )
            gauges = {
                "queue_depth": len(self._queue),
                "queue_ceiling": self._ceiling,
                "live_replicas": n_live,
                # controller-facing names: ccsc_replicas_live is the
                # autoscaling dashboard's canonical series (the
                # legacy live_replicas key is kept for old scrapes)
                "replicas_live": n_live,
                "replica_target": self._replica_target,
                "overload_rung": self._rung,
                "banks": len(self._bank_routes),
                # tenants currently judged below their declared dB
                # floor (ccsc_quality_breach — 0 is healthy)
                "quality_breach": self._quality.n_breached,
                # replicas currently judged gray (slow-but-alive
                # latency outliers — 0 is healthy)
                "gray_replicas": len(self._gray_now),
            }
            gauges.update(self._ctrl_gauges)
            # per-tenant labeled series: the shared constructor
            # (serve.metricsd.tenant_labeled_counters) keeps this
            # live surface and the stream-derived snapshot identical
            labeled = _metricsd_mod.tenant_labeled_counters(
                self._tenant_delivered, self._tenant_rejects
            )
        hists = [
            ("latency_ms", {"phase": sn["phase"]}, sn)
            for sn in self._slo.raw_snapshots()
        ] + [
            (
                "latency_ms",
                {"phase": sn["phase"], "tenant": sn["tenant"]},
                sn,
            )
            for sn in self._tenant_slos.raw_snapshots()
        ] + [
            (
                "psnr_db",
                {
                    "bank_id": sn["bank_id"],
                    "tenant": sn["tenant"],
                    "bucket": sn["bucket"],
                },
                sn,
            )
            for sn in self._quality.raw_snapshots()
        ]
        return {
            "counters": counters,
            "gauges": gauges,
            "labeled_counters": labeled,
            "histograms": hists,
        }

    # -- replica lifecycle ---------------------------------------------
    def _engine_cfg(self, degraded: bool) -> SolveConfig:
        if not degraded:
            return self.cfg
        f = self.fleet_cfg.degrade_max_it_factor
        return dataclasses.replace(
            self.cfg, max_it=max(1, int(self.cfg.max_it * f))
        )

    def _spawn_replica(
        self, rid: int, generation: int, degraded: bool
    ) -> _Replica:
        from ..utils import watchdog as wd_mod

        scfg = dataclasses.replace(
            self.serve_cfg,
            replica_id=rid,
            # replica engines never capture: the fleet records the
            # workload once at admission
            capture_dir=None,
            # this replica's device topology (heterogeneous fleets:
            # FleetConfig.replica_meshes; restarts reuse the same
            # disjoint device slice)
            mesh_shape=self._replica_mesh[rid],
            mesh_devices=(
                self._replica_devices[rid]
                if self._replica_mesh[rid]
                else None
            ),
            metrics_dir=(
                None if self.fleet_cfg.metrics_dir is None
                else os.path.join(
                    self.fleet_cfg.metrics_dir, f"replica-{rid:02d}"
                )
            ),
        )
        engine = CodecEngine(
            self._d, self._prob, self._engine_cfg(degraded), scfg,
            blur_psf=self._blur_psf, device=self._device,
        )
        # republish every known bank onto the fresh engine: a
        # restarted replica must be able to serve a requeued request
        # bound to ANY published digest (add_bank is idempotent for
        # the engine's own default bank; the extra banks cost plan
        # builds, never a kernel build)
        with self._cv:
            extra_banks = list(self._bank_arrays.values())
        for arr in extra_banks:
            engine.add_bank(arr)
        if self._rung >= 1:
            # a replica (re)built while the ladder is shedding must
            # inherit the shed micro-batch deadline, not wait out the
            # configured one under exactly the pressure rung 1 exists
            # for
            try:
                engine.set_max_wait_ms(0.0)
            except Exception:
                pass
        watchdog = wd_mod.DispatchWatchdog(
            0.0,  # no analytic cost model: MIN_S floor + self-calibration
            action="event",
            algorithm="serve_fleet",
            replica_id=rid,
            run=self._run,  # stall records land in the FLEET stream,
            # not whichever replica's run happens to be newest
        )
        rep = _Replica(rid, generation, engine, watchdog, degraded)
        # the hook closes over the replica GENERATION: a stale
        # watchdog can never retire its successor
        watchdog.on_stall = (
            lambda label, rep=rep: self._on_replica_stall(rep, label)
        )
        rep.thread = threading.Thread(
            target=self._worker_loop, args=(rep,),
            name=f"ccsc-fleet-r{rid}", daemon=True,
        )
        rep.thread.start()
        return rep

    def _on_replica_stall(self, rep: _Replica, label: str) -> None:
        with self._cv:
            if rep.reaped or (
                rep.retired and rep.state != "recycling"
            ):
                # someone already handed this replica off (or a death
                # handler is about to — reaped gates exactly one)
                return
            rep.reaped = True
            rep.retired = True
            rep.state = "stalled"
        self._emit(
            "fleet_replica_dead", replica_id=rep.id, reason="stall",
            label=label,
        )
        self._run.console(
            f"fleet: replica {rep.id} stalled ({label}) — draining "
            "and restarting",
            tier="always",
        )
        self._requeue_from(rep, reason="stall")
        # cancel work still sitting in the stalled engine's micro-batch
        # queue: the fleet just requeued its own copies, and a
        # cancelled engine future unwedges the abandoned worker's
        # result() wait if it ever wakes
        try:
            rep.engine.drain_pending()
        except Exception:
            pass
        # the wedged worker thread is abandoned (daemon); if it ever
        # wakes it finds `retired` set, its late deliveries are
        # suppressed by the idempotency set, and it closes its engine
        # on the way out
        self._schedule_restart(rep)
        # the stall just removed live
        # capacity — recompute the derived admission ceiling at the
        # transition instead of waiting out the monitor's hysteresis
        self._refresh_ceiling(force=True)

    def _on_replica_death(self, rep: _Replica, exc: BaseException) -> None:
        with self._cv:
            # `reaped` is the handoff gate, not `retired`: a replica
            # retired for a rung-3 recycle still OWES its handoff — if
            # its worker crashes mid-dispatch before the clean recycle
            # exit, this handler must requeue its in-flight requests
            # and respawn the slot, or they are lost and the slot
            # stays a dead husk
            already = rep.reaped
            if not already:
                rep.reaped = True
                rep.retired = True
                rep.state = "dead"
        if already:
            # stall handler already drained + restarted this replica;
            # we are its abandoned worker waking up (often via the
            # drain's cancelled engine futures) — release the old
            # engine on the way out, nobody else holds it anymore
            try:
                rep.engine.close()
            except Exception:
                pass
            return
        self._emit(
            "fleet_replica_dead", replica_id=rep.id, reason="crash",
            error=f"{type(exc).__name__}: {exc}"[:300],
        )
        self._run.console(
            f"fleet: replica {rep.id} died ({type(exc).__name__}) — "
            "requeueing its requests and restarting",
            tier="always",
        )
        self._requeue_from(rep, reason="crash")
        try:
            # the fleet just requeued its own copies of everything the
            # engine still holds — drain them so close() below doesn't
            # spend a dispatch serving results nobody will read
            rep.engine.drain_pending()
            rep.engine.close()
        except Exception:
            pass
        self._schedule_restart(rep)
        # a dead replica stops contributing
        # capacity right now — the ceiling must follow at the
        # transition, not at the next hysteresis crossing
        self._refresh_ceiling(force=True)

    def _schedule_restart(self, rep: _Replica, charge: bool = True) -> None:
        """``charge=False`` for ladder recycles: a rung transition is
        maintenance, not a failure — it must neither consume the
        crash-restart budget nor escalate the backoff."""
        exhausted = False
        with self._cv:
            if self._close_started:
                return
            if rep.id in self._scaled_down:
                # the slot was retired by scale-down while this
                # casualty was in flight — drop it instead of
                # respawning capacity the controller just removed
                self._slot_gen[rep.id] = rep.generation
                if self._replicas[rep.id] is rep:
                    self._replicas[rep.id] = None
                scaled = True
            else:
                scaled = False
                n = self._restarts.get(rep.id, 0)
                if not charge:
                    attempt = 1
                elif n >= self.fleet_cfg.max_restarts:
                    self._abandoned.add(rep.id)
                    exhausted = True
                else:
                    self._restarts[rep.id] = n + 1
                    attempt = n + 1
        if scaled:
            self._emit(
                "fleet_replica_retired", replica_id=rep.id,
                reason="scale_down",
            )
            self._refresh_ceiling(force=True)
            return
        if exhausted:
            self._emit(
                "fleet_replica_abandoned", replica_id=rep.id,
                restarts=n,
            )
            self._run.console(
                f"fleet: replica {rep.id} restart budget "
                f"({self.fleet_cfg.max_restarts}) exhausted — "
                "serving on survivors",
                tier="always",
            )
            self._fail_if_no_capacity()
            # a half-dead fleet must stop
            # over-admitting NOW, not at the next monitor hysteresis
            # crossing — recompute the derived ceiling on the
            # abandon transition and emit on any change
            self._refresh_ceiling(force=True)
            return
        t = threading.Thread(
            target=self._restart, args=(rep, attempt),
            name=f"ccsc-fleet-restart-r{rep.id}", daemon=True,
        )
        with self._cv:
            self._restart_threads = [
                x for x in self._restart_threads if x.is_alive()
            ]
            self._restart_threads.append(t)
        t.start()

    def _restart(self, old: _Replica, attempt: int) -> None:
        try:
            old.watchdog.stop()
        except Exception:
            pass
        delay = min(
            self.fleet_cfg.restart_backoff_s * (2 ** (attempt - 1)),
            30.0,
        )
        if delay > 0 and self._closing.wait(delay):
            return
        if self._close_started:
            return
        with self._cv:
            if old.id in self._scaled_down:
                # scale-down landed during the backoff: the slot is
                # retired, do not rebuild capacity for it
                self._slot_gen[old.id] = old.generation
                if self._replicas[old.id] is old:
                    self._replicas[old.id] = None
                scaled = True
            else:
                scaled = False
        if scaled:
            self._emit(
                "fleet_replica_retired", replica_id=old.id,
                reason="scale_down",
            )
            self._refresh_ceiling(force=True)
            return
        self._emit(
            "fleet_replica_restart", replica_id=old.id,
            attempt=attempt, degraded=self._degraded,
        )
        try:
            rep = self._spawn_replica(
                old.id, old.generation + 1, degraded=self._degraded
            )
        except Exception as e:
            self._emit(
                "fleet_replica_dead", replica_id=old.id,
                reason="restart_failed",
                error=f"{type(e).__name__}: {e}"[:300],
            )
            self._schedule_restart(old)
            return
        with self._cv:
            closing = (
                self._close_started or old.id in self._scaled_down
            )
            if not closing:
                self._replicas[old.id] = rep
                self._cv.notify_all()
            elif old.id in self._scaled_down:
                self._slot_gen[old.id] = rep.generation
                if self._replicas[old.id] is old:
                    self._replicas[old.id] = None
        if closing:
            # close() (or a scale-down) raced the rebuild and will
            # never see this replica — release it here instead of
            # leaking the engine
            rep.retired = True
            try:
                rep.watchdog.stop()
            except Exception:
                pass
            rep.engine.close()
            return
        self._emit(
            "fleet_replica_ready", replica_id=old.id,
            generation=rep.generation,
            warm=bool(rep.engine.cache_dir),
            degraded=self._degraded,
        )
        # a rejoin changes live capacity —
        # recompute the derived ceiling at the transition
        self._refresh_ceiling(force=True)

    def _fail_if_no_capacity(self) -> None:
        """Called (NOT under self._cv) when a replica is abandoned: if
        NO replica is live or coming back, pending futures can never
        resolve — fail them explicitly (exactly-once-or-error). A
        replica that is merely retired (restart backoff / rebuild in
        flight) counts as coming back — only budget exhaustion
        (``_abandoned``) is terminal, so a transient all-retired
        window must not error recoverable requests. The exceptions are
        set AFTER the lock is released (same discipline as
        ``_requeue_from`` / ``close``): ``Future.set_exception`` runs
        done-callbacks synchronously, and a client callback that
        re-enters the fleet — e.g. resubmitting under a fresh key —
        would deadlock on the non-reentrant Condition."""
        doom_spans: List = []  # (req, queue_span, root_owed)
        with self._cv:
            alive = any(
                rid not in self._abandoned
                and rid not in self._scaled_down
                for rid in range(len(self._replicas))
            )
            if alive:
                return
            doomed = list(self._queue)
            self._queue.clear()
            for r in doomed:
                self._index.pop(r.key, None)
                self._remember(self._failed_keys, r.key)
                if r.trace_id is not None:
                    qs, r.queue_span = r.queue_span, None
                    owed = not r.root_done
                    r.root_done = True
                    doom_spans.append((r, qs, owed))
            self._n_failed += len(doomed)
        wall = time.time()
        for r, qs, root_owed in doom_spans:
            if qs:
                trace_util.end_span(
                    self._emit, trace_id=r.trace_id, span="queue",
                    span_id=qs, parent_span=r.root_span,
                    status="error", ts=wall,
                )
            if root_owed:
                trace_util.end_span(
                    self._emit, trace_id=r.trace_id,
                    span=trace_util.ROOT_SPAN, span_id=r.root_span,
                    status="error", ts=wall, t_start=r.t_wall,
                )
        for r in doomed:
            try:
                r.future.set_exception(
                    RuntimeError(
                        "fleet has no live replicas left (restart "
                        "budgets exhausted)"
                    )
                )
            except InvalidStateError:
                pass

    # -- requeue / delivery --------------------------------------------
    def _remember(self, store: "OrderedDict[str, None]", key: str) -> None:
        """Record a spent key (served or failed) under self._cv,
        evicting the oldest beyond FleetConfig.key_window."""
        store[key] = None
        while len(store) > self.fleet_cfg.key_window:
            store.popitem(last=False)

    def _requeue_from(self, rep: _Replica, reason: str) -> None:
        failed: List[_FleetRequest] = []
        wall = time.time()
        # span actions, emitted after the lock: the casualty's open
        # ownership span ends ('requeued' or 'error') and each
        # requeued request re-opens a queue span — the trace carries
        # the handoff, so a killed replica's request still reassembles
        # as ONE story
        requeue_spans: List = []  # (req, old_attempt_span, att_t, new_queue_span)
        fail_spans: List = []  # (req, old_attempt_span, att_t, root_owed)
        with self._cv:
            lost = [
                r for r in rep.assigned
                if r.key not in self._delivered
                and not r.future.cancelled()
            ]
            rep.assigned = []
            requeued = []
            for r in lost:
                if r.attempts >= self.fleet_cfg.max_attempts:
                    failed.append(r)
                    self._index.pop(r.key, None)
                    self._remember(self._failed_keys, r.key)
                    if r.trace_id is not None:
                        att, r.attempt_span = r.attempt_span, None
                        pr = r.primary or r
                        owed = not pr.root_done
                        pr.root_done = True
                        r.root_done = True
                        fail_spans.append((r, att, r.attempt_t, owed))
                else:
                    requeued.append(r)
                    if r.trace_id is not None:
                        att, r.attempt_span = r.attempt_span, None
                        att_t = r.attempt_t
                        r.queue_span = trace_util.new_span_id()
                        r.queue_t = wall
                        requeue_spans.append(
                            (r, att, att_t, r.queue_span)
                        )
            # hand-offs go to the FRONT of the queue: they already
            # waited their turn once
            for r in reversed(requeued):
                self._queue.appendleft(r)
            self._n_requeued += len(requeued)
            self._n_failed += len(failed)
            self._cv.notify_all()
        for r, att, att_t, new_q in requeue_spans:
            if att:
                trace_util.end_span(
                    self._emit, trace_id=r.trace_id, span="attempt",
                    span_id=att, parent_span=r.root_span,
                    replica_id=rep.id, status="requeued", ts=wall,
                    t_start=att_t, reason=reason,
                )
            trace_util.start_span(
                self._emit, trace_id=r.trace_id, span="queue",
                span_id=new_q, parent_span=r.root_span, ts=wall,
                attempt=r.attempts + 1,
            )
        for r, att, att_t, root_owed in fail_spans:
            if att:
                trace_util.end_span(
                    self._emit, trace_id=r.trace_id, span="attempt",
                    span_id=att, parent_span=r.root_span,
                    replica_id=rep.id, status="error", ts=wall,
                    t_start=att_t, reason=reason,
                )
            if root_owed:
                trace_util.end_span(
                    self._emit, trace_id=r.trace_id,
                    span=trace_util.ROOT_SPAN, span_id=r.root_span,
                    status="error", ts=wall, t_start=r.t_wall,
                    attempts=r.attempts,
                )
        for r in failed:
            try:
                r.future.set_exception(
                    RuntimeError(
                        f"request {r.key!r} failed after "
                        f"{r.attempts} delivery attempts "
                        "(exactly-once-or-error: no result was "
                        "delivered)"
                    )
                )
            except InvalidStateError:
                pass
        if requeued or failed:
            # a casualty that had already delivered everything it took
            # is not a hand-off — emitting n=0 records here would
            # inflate the FLEET report's drain count on every clean
            # restart
            self._emit(
                "fleet_requeue", replica_id=rep.id, reason=reason,
                n=len(requeued), n_failed=len(failed),
                keys=[r.key for r in requeued][:16],
            )

    def _deliver(
        self, rep: _Replica, req: _FleetRequest, res: ServedResult
    ) -> None:
        lat = time.perf_counter() - req.t_submit
        att_span = None
        att_t = 0.0
        root_owed = False
        hedge_won = False
        lost_span = None
        lost_rep = None
        lost_t = 0.0
        with self._cv:
            # a key whose future already carries an error (max_attempts
            # exhausted) is as spent as a served one: recording a late
            # straggler result for it would report a request the client
            # saw FAIL as served in the stats and obs stream
            dup = (
                req.key in self._delivered
                or req.key in self._failed_keys
            )
            if not dup:
                self._remember(self._delivered, req.key)
                self._index.pop(req.key, None)
                self._latencies.append(lat)
                self._n_delivered += 1
                if req.tenant is not None:
                    self._tenant_delivered[req.tenant] = (
                        self._tenant_delivered.get(req.tenant, 0) + 1
                    )
                rep.served += 1
                # per-replica recent-latency histograms (engine-side
                # solve time): the gray-failure scores and the
                # adaptive hedge_after quantile read these
                self._lat_hist.observe(res.latency_s * 1e3)
                self._rep_hist.setdefault(
                    rep.id, _slo.Histogram()
                ).observe(res.latency_s * 1e3)
                if req.hedge_of:
                    # the hedged duplicate beat the original attempt
                    self._n_hedge_wins += 1
                    hedge_won = True
                # claim the open spans under the lock: a racing
                # requeue/close path can then never double-end them.
                # The root claim goes through the PRIMARY instance so
                # a hedge pair's two delivery paths can never
                # double-end the shared root span.
                if req.trace_id is not None:
                    att_span, req.attempt_span = req.attempt_span, None
                    att_rep = req.attempt_rep
                    att_t = req.attempt_t
                    pr = req.primary or req
                    root_owed = not pr.root_done
                    pr.root_done = True
                    req.root_done = True
            else:
                self._n_duplicates += 1
                # a hedge loser's attempt span is still OPEN (neither
                # requeue nor delivery claimed it): close it as the
                # suppressed half of the race
                if (req.hedged or req.hedge_of) and req.attempt_span:
                    lost_span, req.attempt_span = req.attempt_span, None
                    lost_rep = req.attempt_rep
                    lost_t = req.attempt_t
            try:
                rep.assigned.remove(req)
            except ValueError:
                pass  # requeued from under us (stall handoff)
        if dup:
            # at-most-once delivery: a recovered straggler's late
            # result for a key a survivor already served (or the fleet
            # already failed) is dropped
            self._emit(
                "fleet_duplicate_suppressed", replica_id=rep.id,
                trace_id=req.trace_id, key=req.key,
                failed_key=req.key in self._failed_keys,
            )
            if lost_span is not None:
                owner = rep.id if lost_rep is None else lost_rep
                trace_util.end_span(
                    self._emit, trace_id=req.trace_id, span="attempt",
                    span_id=lost_span, parent_span=req.root_span,
                    replica_id=owner, status="hedge_lost",
                    ts=time.time(), t_start=lost_t,
                )
                self._emit(
                    "hedge_lost", replica_id=owner,
                    trace_id=req.trace_id, key=req.key,
                )
            return
        self._slo.observe("total", lat * 1e3)
        # the tenant's OWN histogram: per-tenant p50/p99 vs declared
        # targets, untouched by other tenants' bursts
        self._tenant_slos.observe(req.tenant, lat * 1e3)
        # quality plane: fold the delivered valid-region dB (None on
        # requests without ground truth — a no-op) into the
        # per-(bank, tenant, bucket) histograms and the bank's drift
        # watch; a drift excursion fires here (the monitor returns
        # the records, nothing is emitted under its lock) and also
        # raises a demotion advisory
        if res.psnr is not None:
            with self._cv:
                q_digest = self._bank_routes.get(req.bank_id)
            for fire in self._quality.observe(
                res.psnr,
                bank_id=req.bank_id,
                tenant=req.tenant,
                bucket=res.bucket,
                digest=q_digest,
            ):
                self._emit(
                    "quality_drift", replica_id=None, **fire
                )
                self._advise_demotion(
                    req.bank_id, fire.get("digest"), "drift"
                )
        try:
            req.future.set_result(res)
        except InvalidStateError:
            pass  # client cancelled between checks
        wall = time.time()
        if att_span is not None:
            # the claimed span keeps ITS owner's identity: when a
            # recovered straggler wins the delivery race after a
            # requeue, the new owner's open span ends as
            # 'superseded' (its solve was not the delivered result —
            # the fleet_request record names the actual deliverer)
            owner = rep.id if att_rep is None else att_rep
            trace_util.end_span(
                self._emit, trace_id=req.trace_id, span="attempt",
                span_id=att_span, parent_span=req.root_span,
                replica_id=owner,
                status="ok" if owner == rep.id else "superseded",
                ts=wall, t_start=att_t, bucket=res.bucket,
            )
        if root_owed:
            trace_util.end_span(
                self._emit, trace_id=req.trace_id,
                span=trace_util.ROOT_SPAN, span_id=req.root_span,
                status="ok", ts=wall, t_start=req.t_wall,
                attempts=req.attempts,
            )
        if hedge_won:
            self._emit(
                "hedge_win", replica_id=rep.id,
                trace_id=req.trace_id, key=req.key,
            )
        self._emit(
            "fleet_request", replica_id=rep.id, trace_id=req.trace_id,
            key=req.key, attempts=req.attempts, bucket=res.bucket,
            latency_ms=round(lat * 1e3, 3),
            requeued=req.attempts > 1,
            tenant=req.tenant, bank_id=req.bank_id,
        )
        if self._capture is not None and not req.key.startswith(
            _quality.PROBE_KEY_PREFIX
        ):
            # outcome digest pairs the delivered bytes with the
            # captured request — the bit-parity oracle replay checks
            # (probe keys skipped, mirroring the submit-side guard)
            self._capture.record_outcome(
                req.key, res.recon, res.psnr, lat * 1e3, res.bucket,
                iters=int(res.trace.num_iters),
            )

    # -- the replica worker --------------------------------------------
    def _take(self, rep: _Replica) -> Optional[List[_FleetRequest]]:
        # span actions collected under the lock, EMITTED after release
        # (no stream I/O under the queue mutex): (queue_span_id, req,
        # status, root_end_owed) for drops, (queue_span_id,
        # attempt_span_id, req, attempt_no, t_queue) for takes
        dropped: List = []
        taken: List = []
        expired: List[_FleetRequest] = []
        cancelled: List[_FleetRequest] = []
        with self._cv:
            while True:
                if rep.retired:
                    return None
                if self._queue:
                    break
                if self._close_started:
                    return None
                self._cv.wait(timeout=0.1)
            # span clock AFTER the wait: this is when the take happens
            wall = time.time()
            batch: List[_FleetRequest] = []
            skipped: List[_FleetRequest] = []
            while self._queue and len(batch) < self._take_cap:
                req = self._queue.popleft()
                if (
                    req.key in self._delivered
                    or req.key in self._failed_keys
                ):
                    # requeued copy of a key a straggler already
                    # resolved — solving it again would only be
                    # suppressed at delivery; drop it for free here
                    self._index.pop(req.key, None)
                    if req.trace_id is not None and req.queue_span:
                        qs, req.queue_span = req.queue_span, None
                        dropped.append((qs, req, "dropped", False))
                    continue
                if req.deadline is not None and wall >= req.deadline:
                    # already dead: refusing here costs a queue pop,
                    # solving it would waste a full solve slot. Marked
                    # failed so a late hedge-twin delivery suppresses
                    # as a duplicate.
                    self._index.pop(req.key, None)
                    self._remember(self._failed_keys, req.key)
                    self._n_deadline += 1
                    expired.append(req)
                    if req.trace_id is not None and req.queue_span:
                        qs, req.queue_span = req.queue_span, None
                        pr = req.primary or req
                        owed = not pr.root_done
                        pr.root_done = True
                        req.root_done = True
                        dropped.append((qs, req, "deadline", owed))
                    continue
                if req.attempts == 0 and not req.hedge_of:
                    if not req.future.set_running_or_notify_cancel():
                        self._index.pop(req.key, None)
                        self._n_cancelled += 1
                        cancelled.append(req)
                        if req.trace_id is not None and req.queue_span:
                            qs, req.queue_span = req.queue_span, None
                            pr = req.primary or req
                            owed = not pr.root_done
                            pr.root_done = True
                            req.root_done = True
                            dropped.append(
                                (qs, req, "cancelled", owed)
                            )
                        continue  # client cancelled while queued
                elif req.future.cancelled():
                    # hedge clones share the primary's (already
                    # running) future, so they always land here; count
                    # the cancellation once, on the primary instance
                    self._index.pop(req.key, None)
                    if not req.hedge_of:
                        self._n_cancelled += 1
                        cancelled.append(req)
                    if req.trace_id is not None and req.queue_span:
                        qs, req.queue_span = req.queue_span, None
                        pr = req.primary or req
                        owed = not pr.root_done
                        pr.root_done = True
                        req.root_done = True
                        dropped.append((qs, req, "cancelled", owed))
                    continue
                if req.not_replica == rep.id or (
                    req.hedge_of and rep.id in self._gray_now
                ):
                    # a hedge clone must land on a DIFFERENT replica
                    # than its primary's attempt, and not on one
                    # currently scored gray — a hedge onto the slow
                    # replica would be no hedge at all
                    skipped.append(req)
                    continue
                req.attempts += 1
                if req.trace_id is not None:
                    qs, req.queue_span = req.queue_span, None
                    req.attempt_span = trace_util.new_span_id()
                    req.attempt_rep = rep.id
                    req.attempt_t = wall
                    taken.append(
                        (qs, req.attempt_span, req, req.attempts,
                         req.queue_t)
                    )
                rep.assigned.append(req)
                batch.append(req)
            for r in reversed(skipped):
                self._queue.appendleft(r)
            if skipped and not batch:
                # everything queued was a hedge this replica may not
                # take — yield briefly instead of busy-spinning
                self._cv.wait(timeout=0.05)
            rep.req_seq += len(batch)
        for qs, req, status, root_owed in dropped:
            trace_util.end_span(
                self._emit, trace_id=req.trace_id, span="queue",
                span_id=qs, parent_span=req.root_span, status=status,
                ts=wall,
            )
            if root_owed:
                trace_util.end_span(
                    self._emit, trace_id=req.trace_id,
                    span=trace_util.ROOT_SPAN, span_id=req.root_span,
                    status=status, ts=wall, t_start=req.t_wall,
                )
        for req in expired:
            # fail the future OUTSIDE the lock (done-callbacks run
            # inline). A hedge twin may have resolved it already —
            # the spent-key record above is the authoritative fence.
            try:
                if req.attempts == 0 and not req.hedge_of:
                    if not req.future.set_running_or_notify_cancel():
                        continue  # cancelled first: nothing to fail
                req.future.set_exception(
                    DeadlineExceeded("queue", req.deadline)
                )
            except InvalidStateError:
                pass
            self._emit(
                "deadline_exceeded", replica_id=rep.id,
                where="queue", deadline=round(req.deadline, 3),
                key=req.key, trace_id=req.trace_id,
            )
        for req in cancelled:
            self._emit(
                "request_cancelled", replica_id=rep.id,
                where="queue", key=req.key, trace_id=req.trace_id,
            )
        for qs, att, req, attempt_no, t_queue in taken:
            if qs:
                trace_util.end_span(
                    self._emit, trace_id=req.trace_id, span="queue",
                    span_id=qs, parent_span=req.root_span,
                    status="ok", ts=wall, t_start=t_queue,
                )
            trace_util.start_span(
                self._emit, trace_id=req.trace_id, span="attempt",
                span_id=att, parent_span=req.root_span,
                replica_id=rep.id, ts=wall, attempt=attempt_no,
            )
        return batch

    def _process(self, rep: _Replica, batch: List[_FleetRequest]) -> None:
        from ..utils import faults, validate

        seq0 = rep.req_seq - len(batch)
        stalls_before = rep.watchdog.stalls
        t0 = time.monotonic()
        # the health fence covers the injected faults too: a hang
        # sleeping here is indistinguishable from a wedged dispatch,
        # which is the point
        rep.watchdog.arm(len(batch), label=f"replica{rep.id}-dispatch")
        try:
            for i in range(len(batch)):
                s = seq0 + i + 1
                dur = faults.engine_hang_request(rep.id, s)
                if dur > 0:
                    time.sleep(dur)
                # gray-replica fault: SLOW, not hung — the sleep stays
                # far under the watchdog floor, so only the hedging /
                # gray-score plane may react, never the stall plane
                dur = faults.engine_slow_request(rep.id, s)
                if dur > 0:
                    time.sleep(dur)
                if faults.engine_kill_request(rep.id, s):
                    raise faults.InjectedFault(
                        f"injected engine kill on replica {rep.id} "
                        f"(request #{s})"
                    )
            def _submit_to_engine(r):
                # _validated: admission already ran the full request
                # checks and canonicalized the arrays — no second
                # finiteness scan per ownership. _trace threads the
                # span context: the engine's dispatch/solve spans
                # nest under THIS ownership span, in the replica's
                # own stream
                return rep.engine.submit(
                    r.b, mask=r.mask, smooth_init=r.smooth_init,
                    x_orig=r.x_orig,
                    bank_id=r.bank_id, tenant=r.tenant,
                    _validated=True,
                    _trace=(
                        (r.trace_id, r.attempt_span)
                        if r.trace_id is not None
                        else None
                    ),
                    # the ADMISSION-TIME digest, not the engine's
                    # current route: a hot-swap between admission and
                    # ownership must not retarget this request
                    _digest=r.digest or None,
                    # the ABSOLUTE deadline rides along: the engine
                    # refuses/expires it pre-dispatch instead of
                    # burning a solve slot on a request nobody waits for
                    _deadline=r.deadline,
                )

            futs = []
            for r in batch:
                try:
                    futs.append(_submit_to_engine(r))
                except DeadlineExceeded as e:
                    # engine-side admission expiry: terminal for THIS
                    # request only, never a replica fault
                    futs.append(e)
                except validate.CCSCInputError:
                    # a replica registered concurrently with a
                    # publish_bank rollout can miss the new bank
                    # (spawned after the rollout's replica snapshot,
                    # snapshot of _bank_arrays taken before the
                    # publish landed): heal from the fleet's
                    # retained bytes and retry — a routing gap must
                    # never read as a replica death
                    with self._cv:
                        arr = self._bank_arrays.get(r.digest)
                    if arr is None:
                        raise
                    rep.engine.add_bank(arr)
                    futs.append(_submit_to_engine(r))
            results = []
            for f in futs:
                if isinstance(f, DeadlineExceeded):
                    results.append(f)
                    continue
                try:
                    results.append(f.result(timeout=600.0))
                except DeadlineExceeded as e:
                    # the engine's pre-dispatch sweep expired it while
                    # queued for a micro-batch — same terminal contract
                    results.append(e)
        finally:
            rep.watchdog.disarm()
        if rep.watchdog.stalls == stalls_before:
            # teach the watchdog this replica's real measured pace
            # (same role as LearnConfig.watchdog_slack: deadline =
            # observed per-request time x stall_slack). A fence the
            # watchdog fired on is NOT representative — it may include
            # an injected hang's sleep.
            per = (time.monotonic() - t0) / len(batch)
            rep.watchdog.per_iter_s = max(
                rep.watchdog.per_iter_s,
                self.fleet_cfg.stall_slack * per,
            )
        for req, res in zip(batch, results):
            if isinstance(res, DeadlineExceeded):
                self._fail_request(rep, req, res)
            else:
                self._deliver(rep, req, res)

    def _fail_request(
        self, rep: _Replica, req: _FleetRequest, exc: DeadlineExceeded
    ) -> None:
        """Terminal per-request failure (deadline expiry inside the
        engine): fail the client future and close the spans WITHOUT
        burning a fleet retry — the request is dead by contract, not
        by replica fault, so it must never reach _requeue_from."""
        att_span = None
        att_t = 0.0
        root_owed = False
        with self._cv:
            dup = (
                req.key in self._delivered
                or req.key in self._failed_keys
            )
            if not dup:
                self._remember(self._failed_keys, req.key)
                self._index.pop(req.key, None)
                self._n_deadline += 1
            if req.trace_id is not None and req.attempt_span:
                att_span, req.attempt_span = req.attempt_span, None
                att_t = req.attempt_t
                pr = req.primary or req
                root_owed = not pr.root_done
                pr.root_done = True
                req.root_done = True
            try:
                rep.assigned.remove(req)
            except ValueError:
                pass  # requeued from under us (stall handoff)
        if not dup:
            try:
                req.future.set_exception(exc)
            except InvalidStateError:
                pass  # client cancelled between checks
        wall = time.time()
        if att_span is not None:
            trace_util.end_span(
                self._emit, trace_id=req.trace_id, span="attempt",
                span_id=att_span, parent_span=req.root_span,
                replica_id=rep.id, status="deadline", ts=wall,
                t_start=att_t,
            )
        if root_owed:
            trace_util.end_span(
                self._emit, trace_id=req.trace_id,
                span=trace_util.ROOT_SPAN, span_id=req.root_span,
                status="deadline", ts=wall, t_start=req.t_wall,
                attempts=req.attempts,
            )
        if not dup:
            self._emit(
                "deadline_exceeded", replica_id=rep.id,
                where=exc.where, deadline=round(exc.deadline, 3),
                key=req.key, trace_id=req.trace_id,
            )

    def _worker_loop(self, rep: _Replica) -> None:
        while True:
            batch = self._take(rep)
            if batch is None:
                break
            if not batch:
                continue
            try:
                self._process(rep, batch)
            except BaseException as e:
                self._on_replica_death(rep, e)
                return
        # clean exit: fleet close, or a retire (stall handoff /
        # recycle). The stall path already scheduled the replacement;
        # a clean recycle claims the handoff here (reaped gates
        # exactly one of us) and schedules it after the engine is
        # released — nothing to requeue, _take stopped before this
        # batch was taken.
        with self._cv:
            recycle = rep.state == "recycling" and not rep.reaped
            draining = rep.state == "draining" and not rep.reaped
            if recycle or draining:
                rep.reaped = True
        if recycle:
            # normally nothing is in flight here (_take stopped before
            # another batch was taken, _process delivered the last
            # one), but the handoff contract is uniform: whoever
            # claims `reaped` requeues whatever is left
            self._requeue_from(rep, reason="recycle")
        elif draining:
            # scale-down: drain-then-retire, never a kill — leftovers
            # (normally none; _take stopped before another batch) go
            # back to the FRONT of the queue for the survivors
            self._requeue_from(rep, reason="scale_down")
        if rep.retired:
            try:
                rep.engine.close()
            except Exception:
                pass
        if recycle:
            self._schedule_restart(rep, charge=False)
        elif draining:
            # no replacement is scheduled: the slot empties and the
            # capacity math (ceiling, dead-fleet checks, devices)
            # follows the new target immediately
            with self._cv:
                rep.state = "stopped"
                self._slot_gen[rep.id] = rep.generation
                if self._replicas[rep.id] is rep:
                    self._replicas[rep.id] = None
            self._emit(
                "fleet_replica_retired", replica_id=rep.id,
                reason="scale_down",
            )
            self._refresh_ceiling(force=True)

    # -- monitor: heartbeats, ceiling, overload ladder ------------------
    def _monitor_loop(self) -> None:
        from ..utils import perfmodel

        hb_every = self.fleet_cfg.heartbeat_s
        while not self._stop_monitor.wait(
            self.fleet_cfg.health_interval_s
        ):
            now = time.monotonic()
            with self._cv:
                depth = len(self._queue)
                reps = list(self._replicas)
            if self.fleet_cfg.max_queue_depth is None:
                self._update_ceiling(perfmodel, reps)
            self._eval_rungs(depth, now)
            if now - self._hb_last >= hb_every:
                self._hb_last = now
                for rep in reps:
                    if rep is None:
                        continue
                    self._emit(
                        "fleet_heartbeat", replica_id=rep.id,
                        state=rep.state, generation=rep.generation,
                        served=rep.served, inflight=len(rep.assigned),
                        queue_depth=depth,
                        restarts=self._restarts.get(rep.id, 0),
                        devices=rep.engine.devices,
                    )
            # fleet-wide SLO check (serve.slo): submit->result
            # latency vs the declared targets, plus the periodic
            # histogram snapshot any stream reader can recompute
            # percentiles from
            breaches, snaps = self._slo.tick(now)
            for br in breaches:
                self._emit("slo_breach", replica_id=None, **br)
            for sn in snaps:
                self._emit("slo_histogram", replica_id=None, **sn)
            # per-TENANT SLO checks: each declared tenant's own
            # histogram vs its own declared band — the records carry
            # the tenant name (obs_report TENANTS)
            t_breaches, t_snaps = self._tenant_slos.tick(now)
            for br in t_breaches:
                self._emit("slo_breach", replica_id=None, **br)
            for sn in t_snaps:
                self._emit("slo_histogram", replica_id=None, **sn)
            # quality plane: tenant dB floors vs declared
            # min_psnr_db (quality_breach, the slo_breach
            # discipline), periodic per-(bank, tenant, bucket) dB
            # snapshots, and the per-bucket solve diagnostics
            q_breaches, q_snaps, q_diags = self._quality.tick(now)
            for br in q_breaches:
                self._emit("quality_breach", replica_id=None, **br)
            for sn in q_snaps:
                self._emit(
                    "quality_histogram", replica_id=None, **sn
                )
            for dg in q_diags:
                self._emit(
                    "quality_solve_diag", replica_id=None, **dg
                )
            # request lifecycle: gray-failure scores from the
            # per-replica latency histograms, then hedge any attempt
            # that has outwaited the hedge threshold
            self._hedge_and_gray_tick()

    def _hedge_after_ms(self) -> Optional[float]:
        """The hedge trigger threshold: a stuck attempt older than
        this gets a second attempt on another replica. Resolution:
        ``FleetConfig.hedge_after_ms`` > ``CCSC_HEDGE_AFTER_MS`` >
        the ``hedge_quantile`` (default p95) of the fleet-wide
        engine-side latency histogram — adaptive, so 'slow' means
        slow RELATIVE to what this fleet actually serves. None while
        the histogram is too thin to judge (no hedging yet)."""
        if self.fleet_cfg.hedge_after_ms is not None:
            return self.fleet_cfg.hedge_after_ms
        env_ms = _env.env_float("CCSC_HEDGE_AFTER_MS")
        if env_ms is not None:
            return float(env_ms)
        q = self.fleet_cfg.hedge_quantile
        if q is None:
            q = float(_env.env_float("CCSC_HEDGE_QUANTILE"))
        with self._cv:
            if self._lat_hist.n < 5:
                return None
            return self._lat_hist.percentile(q)

    def _hedge_and_gray_tick(self) -> None:
        """One monitor-tick pass of the gray-failure plane.

        Gray scoring: a replica whose engine-side latency p50 is
        ``CCSC_GRAY_FACTOR``x the median of the replica p50s is
        scored gray — a sustained latency OUTLIER, a weaker (and
        earlier) signal than the watchdog's hard stall. Gray is
        advisory: the replica keeps serving, but hedges avoid it and
        a deduped ``fleet_gray_replica`` event (the recycle hint)
        marks the excursion.

        Hedging: any in-flight attempt older than the hedge
        threshold gets ONE duplicate attempt enqueued for a
        different, non-gray replica — first result wins through the
        delivery fence, the loser is suppressed-and-counted. Total
        hedges are capped at ``hedge_max_frac`` of admitted requests
        so a fleet-wide slowdown cannot double its own load."""
        gray_factor = float(_env.env_float("CCSC_GRAY_FACTOR"))
        frac = self.fleet_cfg.hedge_max_frac
        if frac is None:
            frac = float(_env.env_float("CCSC_HEDGE_MAX_FRAC"))
        hedge_ms = self._hedge_after_ms()
        wall = time.time()
        gray_events: List[Dict[str, object]] = []
        spawned: List[Tuple[_FleetRequest, int, float]] = []
        with self._cv:
            live = [
                rep for rep in self._replicas
                if rep is not None and rep.state == "live"
            ]
            # -- gray scores (needs >= 2 replicas for a median) -----
            p50s = {}
            for rep in live:
                h = self._rep_hist.get(rep.id)
                if h is not None and h.n >= 5:
                    p = h.percentile(0.5)
                    if p is not None:
                        p50s[rep.id] = p
            if len(p50s) >= 2:
                med = sorted(p50s.values())[len(p50s) // 2]
                for rid, p in p50s.items():
                    factor = p / max(med, 1e-9)
                    self._gray_score[rid] = round(factor, 3)
                    if factor >= gray_factor and med > 0:
                        if rid not in self._gray_now:
                            # one event per excursion, not per tick
                            self._gray_now.add(rid)
                            gray_events.append({
                                "replica_id": rid,
                                "p50_ms": round(p, 3),
                                "fleet_p50_ms": round(med, 3),
                                "factor": round(factor, 3),
                            })
                    else:
                        self._gray_now.discard(rid)
            # -- hedge spawns ---------------------------------------
            if hedge_ms is not None and len(live) >= 2 and frac > 0:
                budget = frac * max(self._n_admitted, 1)
                for rep in live:
                    for req in list(rep.assigned):
                        if self._n_hedges >= budget:
                            break
                        if req.hedged or req.hedge_of:
                            continue  # one hedge per request, ever
                        if req.attempt_t <= 0:
                            continue
                        waited = (wall - req.attempt_t) * 1e3
                        if waited < hedge_ms:
                            continue
                        if (
                            req.key in self._delivered
                            or req.key in self._failed_keys
                        ):
                            continue
                        if req.deadline is not None and (
                            wall >= req.deadline
                        ):
                            continue  # expiry owns it, not hedging
                        if req.future.cancelled():
                            continue
                        clone = _FleetRequest(
                            key=req.key, b=req.b, mask=req.mask,
                            smooth_init=req.smooth_init,
                            x_orig=req.x_orig,
                            future=req.future,
                            t_submit=req.t_submit,
                            tenant=req.tenant, bank_id=req.bank_id,
                            digest=req.digest,
                            deadline=req.deadline,
                            trace_id=req.trace_id,
                            root_span=req.root_span,
                            queue_span=trace_util.new_span_id(),
                            t_wall=req.t_wall, queue_t=wall,
                            hedged=True, hedge_of=True,
                            not_replica=rep.id, primary=req,
                        )
                        req.hedged = True
                        # NOT in _index: the key's index entry stays
                        # the primary's; the clone is reachable only
                        # through the queue and the shared future
                        self._queue.append(clone)
                        self._n_hedges += 1
                        spawned.append((clone, rep.id, waited))
                if spawned:
                    self._cv.notify_all()
        for ev in gray_events:
            self._emit("fleet_gray_replica", **ev)
        for clone, owner, waited in spawned:
            self._emit(
                "hedge_spawn", replica_id=owner,
                trace_id=clone.trace_id, key=clone.key,
                waited_ms=round(waited, 3),
                hedge_after_ms=round(hedge_ms, 3),
            )
            if clone.trace_id is not None:
                trace_util.start_span(
                    self._emit, trace_id=clone.trace_id,
                    span="queue", span_id=clone.queue_span,
                    parent_span=clone.root_span, ts=wall,
                    attempt=2, hedge=True,
                )

    # -- quality plane (serve.quality) ---------------------------------
    def _quality_drift_band(
        self, bank_id: Optional[str], digest: str
    ) -> Optional[Dict[str, float]]:
        """The drift watch's historical band for one bank: the
        quality band over EVERY kind=quality ledger record of this
        bank id and workload — deliberately across digests, so a
        freshly-swapped rotten bank is judged against the good
        history it replaced, not its own. None (no ledger / thin
        history) leaves that bank unwatched."""
        try:
            from ..analysis import ledger as _ledger
            from ..tune import store as tune_store

            if not _ledger.enabled():
                return None
            workload = tune_store.solve_workload(self.geom)
            bank_key = bank_id or "default"
            vals = [
                float(r["value"])
                for r in _ledger.Ledger().read()
                if r.get("kind") == "quality"
                and r.get("workload") == workload
                and (r.get("knobs") or {}).get("bank") == bank_key
            ]
            min_history = _env.env_int("CCSC_PERF_GATE_MIN_HISTORY")
            if len(vals) < min_history:
                return None
            return _quality.quality_band(vals)
        except Exception:  # pragma: no cover - defensive
            return None

    def _advise_demotion(
        self,
        bank_id: Optional[str],
        from_digest: Optional[str],
        reason: str,
    ) -> None:
        """Record + emit one advisory demotion signal: the bank's
        served quality regressed (probe or drift evidence) and the
        previously-routed digest — if the fleet saw one — is the
        restoration candidate. ADVISORY by design: the fleet never
        swaps a bank on its own (a flapping probe must not flap
        production routing); a registry/controller or operator
        consumes quality_advice() and decides. Deduped per
        (bank, digest, reason)."""
        key = (bank_id, from_digest, reason)
        with self._cv:
            if key in self._advice_seen:
                return
            self._advice_seen.add(key)
            advice = {
                "bank_id": bank_id,
                "from_digest": from_digest,
                "to_digest": self._bank_prev.get(bank_id),
                "reason": reason,
                "t": time.time(),
            }
            self._quality_advice.append(advice)
        self._emit(
            "quality_demote_advice",
            replica_id=None,
            bank_id=bank_id,
            from_digest=from_digest,
            to_digest=advice["to_digest"],
            reason=reason,
        )

    def quality_advice(self) -> List[Dict]:
        """Advisory demotion signals accumulated so far (newest
        last) — each carries bank_id, the regressing from_digest,
        the restoration to_digest (the digest the bank routed to
        before its last swap, None if never swapped), and the
        evidence reason ('probe' | 'drift')."""
        with self._cv:
            return list(self._quality_advice)

    def _probe_loop(self) -> None:
        """Golden probes through idle capacity: every
        probe_interval_s, serve the deterministic probe set against
        every routed bank id and judge each result bit-exact + in dB
        against the stored reference for the bank's CURRENT digest
        (serve.quality.ProbeSet). Skipped while the queue has real
        work — probes ride idle replicas only. A regression emits
        quality_probe_breach and raises a demotion advisory."""
        while not self._stop_monitor.wait(self._probe_interval_s):
            with self._cv:
                busy = len(self._queue) > 0
                bank_ids = list(self._bank_routes)
            if busy or self._close_started:
                continue
            try:
                self._run_probes(bank_ids)
            except Exception:
                # a probe failure (draining fleet, bucket rebuild)
                # must never take the probe thread down — the next
                # interval retries
                continue

    def _run_probes(self, bank_ids) -> None:
        if self._probe_set is None:
            # auto-generate on first use: deterministic payloads per
            # configured bucket, idempotent on an existing store.
            # Content is synthesized through the PINNED bank — the
            # only content whose served dB ranks banks (synth_probe)
            self._probe_set = _quality.ProbeSet.generate(
                self._probe_dir, self.geom, self.buckets,
                d=self._d,
            )
        for bank_id in bank_ids:
            self._probe_seq += 1
            verdicts = self._probe_set.run(
                self,
                bank_id=bank_id,
                key_seq=self._probe_seq,
                timeout=600.0,
            )
            for v in verdicts:
                self._emit(
                    "quality_probe",
                    replica_id=None,
                    probe=v["probe"],
                    bank_id=v["bank_id"],
                    digest=v["digest"],
                    status=v["status"],
                    db=v["db"],
                    ref_db=v["ref_db"],
                )
                if v["status"] == "regressed":
                    with self._cv:
                        self._n_probe_failures += 1
                    self._emit(
                        "quality_probe_breach",
                        replica_id=None,
                        probe=v["probe"],
                        bank_id=v["bank_id"],
                        digest=v["digest"],
                        db=v["db"],
                        ref_db=v["ref_db"],
                    )
                    self._advise_demotion(
                        bank_id, v["digest"], "probe"
                    )

    def _refresh_ceiling(self, force: bool = False) -> None:
        """Recompute the derived admission ceiling NOW: called at
        every replica lifecycle transition —
        retire, rejoin, abandon, scale — so a half-dead fleet stops
        over-admitting at the transition instead of at the monitor's
        next 1.5x hysteresis crossing. ``force`` emits
        ``fleet_ceiling`` on ANY change, bypassing the hysteresis
        band (which exists to quiet steady-state jitter, not to
        delay capacity news)."""
        if (
            self.fleet_cfg.max_queue_depth is not None
            or self._close_started
        ):
            return
        from ..utils import perfmodel

        with self._cv:
            reps = list(self._replicas)
        self._update_ceiling(perfmodel, reps, force=force)

    def _replica_warm(self, rep: _Replica) -> bool:
        """Every declared bucket's program installed and serveable on
        this replica's engine. A replica staging its warmup
        (ServeConfig.staged_warmup) is LIVE for the buckets it has,
        but the capacity math must not credit it at full rate until
        it is past BucketCold everywhere — the scale-up admission
        gate of serve.controller."""
        try:
            return all(
                rep.engine.bucket_warm((s, sp))
                for s, sp in self.buckets
            )
        except Exception:
            return False

    def _update_ceiling(self, perfmodel, reps, force=False) -> None:
        live = [
            r for r in reps
            if r is not None and r.state == "live"
            and self._replica_warm(r)
        ]
        # per-replica bounds, device-count aware: each live replica
        # contributes its OWN measured rate; an unmeasured one is
        # credited at the best measured per-device rate times its
        # device count (perfmodel.fleet_serving_bound) — a mesh
        # replica is a multiple of a single-device replica's
        # capacity, and a ceiling that counted replicas instead of
        # devices would reject exactly the load the mesh bought.
        # The EFFECTIVE solve budget still applies: rung 3 recycles
        # replicas onto max_it x degrade_max_it_factor, which raises
        # real request throughput.
        bound = perfmodel.fleet_serving_bound(
            [
                (r.engine.last_it_rate, r.engine.devices)
                for r in live
            ],
            max(1, self._engine_cfg(self._degraded).max_it),
            self._total_slots,
            occupancy=1.0,
        )
        if bound["measured"] == 0:
            return
        self._bound_rps = bound["requests_per_sec"]
        derived = max(
            self.fleet_cfg.min_queue_depth,
            int(self._bound_rps * self.fleet_cfg.max_queue_s),
        )
        old = self._ceiling
        hysteresis = (
            not self._ceiling_derived or derived > 1.5 * old
            or derived < old / 1.5
        )
        if hysteresis or (force and derived != old):
            self._ceiling = derived
            self._ceiling_derived = True
            self._emit(
                "fleet_ceiling", replica_id=None, ceiling=derived,
                bound_requests_per_sec=round(self._bound_rps, 3),
                live_replicas=len(live),
                live_devices=sum(r.engine.devices for r in live),
                source="serving_bound",
            )

    def _set_rung(self, rung: int, depth: int) -> None:
        old = self._rung
        if rung == old:
            return
        self._rung = rung
        self._rung2_since = (
            time.monotonic() if rung == 2 else None
        )
        self._emit(
            "fleet_overload", replica_id=None,
            rung_from=RUNGS[old], rung_to=RUNGS[rung],
            queue_depth=depth, ceiling=self._ceiling,
        )
        self._run.console(
            f"fleet: overload ladder {RUNGS[old]} -> {RUNGS[rung]} "
            f"(queue {depth}/{self._ceiling})",
            tier="brief",
        )
        # rung effects on live engines (best-effort: a replica mid-
        # restart picks up the current rung when it next matters)
        shed = rung >= 1
        for rep in self._replicas:
            if rep is None or rep.retired:
                continue
            try:
                rep.engine.set_max_wait_ms(
                    0.0 if shed else self.serve_cfg.max_wait_ms
                )
            except Exception:
                pass
        if rung == 3 and not self._degraded:
            self._degraded = True
            self._emit(
                "degrade", replica_id=None, rung="serve_max_it",
                stage="overload",
                max_it=self._engine_cfg(True).max_it,
            )
            self._start_recycle()
        elif rung == 0 and self._degraded and not self._brownout:
            self._degraded = False
            self._emit(
                "degrade", replica_id=None, rung="serve_restore",
                stage="overload", max_it=self.cfg.max_it,
            )
            self._start_recycle()

    def _eval_rungs(self, depth: int, now: float) -> None:
        c = max(1, self._ceiling)
        frac = depth / c
        f = self.fleet_cfg
        r = self._rung
        if r == 3:
            if frac < f.shed_exit:
                self._set_rung(0, depth)
        elif r == 2:
            if frac < f.shed_exit:
                self._set_rung(0, depth)
            elif frac < f.reject_exit:
                self._set_rung(1, depth)
            elif (
                f.degrade_after_s > 0
                and self._rung2_since is not None
                and now - self._rung2_since > f.degrade_after_s
            ):
                self._set_rung(3, depth)
        elif r == 1:
            if frac >= 1.0:
                self._set_rung(2, depth)
            elif frac < f.shed_exit:
                self._set_rung(0, depth)
        else:
            if frac >= 1.0:
                self._set_rung(2, depth)
            elif frac >= f.shed_at:
                self._set_rung(1, depth)

    def _start_recycle(self) -> None:
        """Staggered replica recycle onto the current degrade state:
        one replica at a time, so capacity never drops below N-1."""
        with self._cv:
            if self._recycling or self._close_started:
                return
            self._recycling = True
            # tracked, not fire-and-forget: close() joins it so an
            # interpreter exit can never catch it mid-work (lint:
            # thread-safety; _recycling gates at most one alive).
            # Started INSIDE the lock: publishing an unstarted thread
            # and starting it after release would let a racing
            # close() join() a never-started Thread (RuntimeError
            # mid-cleanup). The new thread's first act is to take
            # this same lock, so it simply blocks until we release.
            self._recycle_thread = threading.Thread(
                target=self._recycle_loop, name="ccsc-fleet-recycle",
                daemon=True,
            )
            self._recycle_thread.start()

    def _recycle_loop(self) -> None:
        try:
            # loop until every live replica matches the CURRENT target
            # — capturing a fixed target and bailing when the ladder
            # moves would strand already-recycled replicas on the old
            # budget (the rung flip's own _start_recycle no-ops while
            # this thread holds _recycling)
            while not self._close_started:
                target = self._degraded
                with self._cv:
                    todo = [
                        rep for rep in self._replicas
                        if rep is not None and not rep.retired
                        and rep.degraded != target
                    ]
                    if not todo:
                        if self._degraded == target:
                            return
                        continue  # target moved during the scan
                    rep = todo[0]
                    rep.retired = True
                    rep.state = "recycling"
                    self._cv.notify_all()
                # wait for the replacement (an engine rebuild: plans
                # and a warm dispatch) before touching the next one
                deadline = time.monotonic() + 120.0
                while time.monotonic() < deadline:
                    if self._close_started:
                        return
                    if rep.id in self._abandoned:
                        # the recycling replica crashed under us and
                        # exhausted its restart budget — no replacement
                        # is coming, move on
                        break
                    cur = self._replicas[rep.id]
                    if (
                        cur is not None
                        and cur.generation > rep.generation
                        and cur.state == "live"
                    ):
                        break
                    time.sleep(0.05)
        finally:
            with self._cv:
                self._recycling = False
            # a rung flip that raced our exit had its _start_recycle
            # no-oped against the flag we just cleared — re-check and
            # reschedule so no replica is stranded on a stale budget
            if not self._close_started:
                with self._cv:
                    stranded = any(
                        rep is not None and not rep.retired
                        and rep.degraded != self._degraded
                        for rep in self._replicas
                    )
                if stranded:
                    self._start_recycle()

    # -- public API ----------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._close_started

    @property
    def total_devices(self) -> int:
        """Devices across all replica engines (a single-device
        replica counts 1, a mesh replica prod(mesh_shape))."""
        return sum(
            rep.engine.devices
            for rep in self._replicas
            if rep is not None
        ) or max(1, self._replica_target)

    @property
    def capacity_hint(self) -> int:
        """Total concurrent request capacity across replicas — the
        natural claim-batch bound for a drain worker feeding this
        fleet from an external queue (serve.federation). Counts MESH
        slots: a replica sharded over D devices turns a bucket
        dispatch around ~D times faster, so it sustains ~D
        single-device replicas' worth of claimed work — an
        all-single-device fleet keeps the historical
        slots x replicas value exactly."""
        return self._total_slots * self.total_devices

    @property
    def queue_ceiling(self) -> int:
        """The current admission ceiling (explicit or
        serving_bound-derived)."""
        return self._ceiling

    @property
    def overload_rung(self) -> str:
        return RUNGS[self._rung]

    # -- elasticity: the control plane's actuators ----------------------
    @property
    def replica_target(self) -> int:
        """The replica count the fleet is currently converging to —
        the single source of truth a (re)started CapacityController
        reconciles from: the controller holds NO durable state of its
        own, so its death or restart can never disagree with the
        data plane about how much capacity exists."""
        return self._replica_target

    def set_replica_count(self, n: int, reason: str = "manual") -> Dict[str, int]:
        """Live grow/shrink to ``n`` replicas (the fine-grain
        elasticity actuator). Strictly a data-plane operation: callers
        (a capacity controller, an operator REPL) are advisory.

        Grow spawns fresh replicas onto the next free device slices;
        a grown replica is admitted into the derived ceiling only
        once every bucket is past ``BucketCold``
        (``_replica_warm`` gates ``_update_ceiling``). Shrink is
        drain-then-retire, never a kill: the highest-id replicas stop
        taking work, finish their in-flight batch, requeue any
        leftovers to the FRONT of the queue, and release their
        engines — zero lost requests by construction. Returns
        ``{"from_n", "to_n"}``; raises ``CCSCInputError`` for n < 1
        and ``RuntimeError`` on a closed fleet (or a strict device
        pool that cannot supply another disjoint slice)."""
        import math as _math

        from ..utils import validate

        n = int(n)
        if n < 1:
            raise validate.CCSCInputError(
                f"replica count must be >= 1, got {n}"
            )
        if self._close_started:
            raise RuntimeError("fleet is closed")
        spawn: List[int] = []
        with self._cv:
            if self._close_started:
                raise RuntimeError("fleet is closed")
            cur = self._replica_target
            if n == cur:
                return {"from_n": cur, "to_n": n}
            if n > cur:
                add = n - cur
                # resurrect drained slots first (their device slice
                # is already reserved), then append fresh ones
                for rid in sorted(self._scaled_down):
                    if add == 0:
                        break
                    if self._replicas[rid] is None:
                        self._scaled_down.discard(rid)
                        self._restarts.pop(rid, None)
                        self._abandoned.discard(rid)
                        spawn.append(rid)
                        add -= 1
                while add > 0:
                    rid = len(self._replicas)
                    entry = self._default_mesh_entry
                    devices = None
                    if entry:
                        if self._mesh_pool is None:
                            self._mesh_pool = (
                                list(self.serve_cfg.mesh_devices)
                                if self.serve_cfg.mesh_devices
                                is not None
                                else self._device_positions(
                                    _math.prod(entry) * n)
                            )
                        need = _math.prod(entry)
                        pool = self._mesh_pool
                        if self._mesh_off + need <= len(pool):
                            devices = tuple(
                                pool[self._mesh_off:
                                     self._mesh_off + need]
                            )
                            self._mesh_off += need
                        elif _env.env_flag("CCSC_SERVE_MESH_STRICT"):
                            # roll back: nothing spawned yet, so the
                            # resurrected slots return to the drained
                            # set and the target stays where it was
                            for r2 in spawn:
                                self._scaled_down.add(r2)
                            raise RuntimeError(
                                f"cannot grow to {n} replicas: the "
                                f"device pool ({len(pool)} device(s),"
                                f" {self._mesh_off} allocated) has no"
                                f" disjoint {entry} slice left — "
                                "shrink the mesh, free devices, or "
                                "set CCSC_SERVE_MESH_STRICT=0"
                            )
                    self._replicas.append(None)
                    self._replica_mesh.append(entry)
                    self._replica_devices.append(devices)
                    spawn.append(rid)
                    add -= 1
                self._replica_target = n
            else:
                shed = cur - n
                for rid in range(len(self._replicas) - 1, -1, -1):
                    if shed == 0:
                        break
                    if rid in self._scaled_down:
                        continue
                    self._scaled_down.add(rid)
                    shed -= 1
                    rep = self._replicas[rid]
                    if rep is not None and not rep.retired:
                        # drain-then-retire: _take stops handing this
                        # worker batches; its clean exit requeues
                        # leftovers and empties the slot. An already-
                        # retired slot (recycle/restart in flight)
                        # is dropped by the _scaled_down guards in
                        # _schedule_restart/_restart instead.
                        rep.retired = True
                        rep.state = "draining"
                self._replica_target = n
                self._cv.notify_all()
        self._emit(
            "fleet_scale", replica_id=None, from_n=cur, to_n=n,
            reason=reason,
        )
        self._run.console(
            f"fleet: scaling {cur} -> {n} replica(s) ({reason})",
            tier="brief",
        )
        for rid in spawn:
            gen = self._slot_gen.get(rid, -1) + 1
            try:
                rep = self._spawn_replica(
                    rid, generation=gen, degraded=self._degraded
                )
            except BaseException:
                # a failed grow must not leave a husk slot the
                # dead-fleet checks count as coming back
                with self._cv:
                    self._scaled_down.add(rid)
                    self._replica_target -= 1
                raise
            with self._cv:
                closing = (
                    self._close_started or rid in self._scaled_down
                )
                if not closing:
                    self._replicas[rid] = rep
                    self._cv.notify_all()
            if closing:
                rep.retired = True
                try:
                    rep.watchdog.stop()
                except Exception:
                    pass
                rep.engine.close()
                continue
            self._emit(
                "fleet_replica_ready", replica_id=rid,
                generation=gen,
                warm=bool(rep.engine.cache_dir),
                degraded=self._degraded,
            )
        self._refresh_ceiling(force=True)
        return {"from_n": cur, "to_n": n}

    def set_brownout(self, on: bool, reason: str = "controller") -> bool:
        """Drive the degrade rung directly (the controller's brownout
        actuator): ``on`` recycles replicas onto the reduced
        ``max_it x degrade_max_it_factor`` solve budget WITHOUT
        waiting for the overload ladder's rung-3 escalation — trade
        solve quality for throughput BEFORE any shed. ``off``
        restores the full budget unless the ladder itself holds
        rung 3. Idempotent; returns whether the call changed
        state."""
        with self._cv:
            if self._close_started:
                raise RuntimeError("fleet is closed")
            if on == self._brownout:
                return False
            self._brownout = on
            if on:
                changed = not self._degraded
                self._degraded = True
            else:
                # the ladder still demands degrade at rung 3 — the
                # brownout flag releases, the budget stays down
                changed = self._degraded and self._rung < 3
                if changed:
                    self._degraded = False
        if on and changed:
            self._emit(
                "degrade", replica_id=None, rung="serve_max_it",
                stage="brownout",
                max_it=self._engine_cfg(True).max_it,
            )
            self._start_recycle()
        elif not on and changed:
            self._emit(
                "degrade", replica_id=None, rung="serve_restore",
                stage="brownout", max_it=self.cfg.max_it,
            )
            self._start_recycle()
        return True

    @property
    def brownout(self) -> bool:
        return self._brownout

    def set_ctrl_gauge(self, name: str, value: float) -> None:
        """Publish a controller gauge through the fleet's metrics
        surface (rendered as ``ccsc_<name>`` by serve.metricsd)."""
        with self._cv:
            self._ctrl_gauges[name] = value

    def control_snapshot(self) -> Dict[str, object]:
        """One consistent sensor read for the control plane
        (serve.controller): queue depth vs ceiling, rung, live/warm
        replica counts vs target, SLO percentiles vs declared
        targets, serving bound, and the fleet-wide warmup ETA.
        Carries its own wall-clock ``t`` — the controller's
        staleness detector compares against it and fails safe."""
        with self._cv:
            depth = len(self._queue)
            live = [
                r for r in self._replicas
                if r is not None and r.state == "live"
            ]
            snap = {
                "t": time.time(),
                "queue_depth": depth,
                "ceiling": self._ceiling,
                "rung": self._rung,
                "live_replicas": len(live),
                "replica_target": self._replica_target,
                "abandoned": len(self._abandoned),
                "bound_rps": round(self._bound_rps, 3),
                "brownout": self._brownout,
                # request-lifecycle plane: gray excursions and the
                # hedge/deadline/cancel tallies — the controller and
                # ops surfaces read recycle hints from here
                "gray_replicas": sorted(self._gray_now),
                "gray_scores": dict(self._gray_score),
                "hedges": self._n_hedges,
                "hedge_wins": self._n_hedge_wins,
                "deadline_exceeded": self._n_deadline,
                "cancelled": self._n_cancelled,
            }
        snap["warm_replicas"] = sum(
            1 for r in live if self._replica_warm(r)
        )
        etas = []
        for s, sp in self.buckets:
            eta = self._cold_eta((s, sp))
            if eta is not None:
                etas.append(eta)
        snap["warmup_eta_s"] = round(max(etas), 3) if etas else 0.0
        p99 = self._slo.percentile("total", 0.99)
        snap["p99_ms"] = None if p99 is None else round(p99, 3)
        snap["slo_p99_target_ms"] = self.fleet_cfg.slo_p99_ms
        return snap

    def _cold_eta(self, bkey) -> Optional[float]:
        """None when some LIVE replica already serves ``bkey``'s
        program — or no live replica exists to ask (the dead-fleet
        refusals own that path) — else the smallest warmup ETA across
        the staging replicas: the bucket is cold fleet-wide and the
        caller should back off that long."""
        with self._cv:
            engines = [
                rep.engine
                for rep in self._replicas
                if rep is not None
                and rep.state == "live"
                and rep.engine is not None
            ]
        etas = []
        for eng in engines:
            try:
                if eng.bucket_warm(bkey):
                    return None
                etas.append(eng.warmup_eta_s())
            except Exception:
                # a replica mid-death answers nothing — its casualty
                # handling is the watchdog's job, not admission's
                continue
        return min(etas) if etas else None

    def _resolve_deadline(
        self,
        tenant: Optional[str],
        deadline_ms: Optional[float],
        _deadline: Optional[float],
    ) -> Optional[float]:
        """Absolute wall-clock deadline of one submission. An
        internal absolute hand-off wins unconditionally (a cross-host
        budget must SHRINK through each hop, never reset); else the
        explicit relative budget, else the tenant's declared default,
        else the fleet config, else ``CCSC_REQ_DEADLINE_MS``, else
        None (unbounded — the pre-deadline contract)."""
        if _deadline is not None:
            return float(_deadline)
        if deadline_ms is None:
            spec = self._tenants.get(tenant)
            if spec is not None and spec.deadline_ms is not None:
                deadline_ms = spec.deadline_ms
            elif self.fleet_cfg.deadline_ms is not None:
                deadline_ms = self.fleet_cfg.deadline_ms
            else:
                deadline_ms = _env.env_float("CCSC_REQ_DEADLINE_MS")
        if deadline_ms is None:
            return None
        return time.time() + float(deadline_ms) / 1e3

    def submit(
        self, b, mask=None, smooth_init=None, x_orig=None,
        key: Optional[str] = None,
        bank_id: Optional[str] = None,
        tenant: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        _deadline: Optional[float] = None,
    ) -> "Future[ServedResult]":
        """Enqueue one observation; returns a Future of
        :class:`~.engine.ServedResult`.

        ``key`` is the request's idempotency key (auto-assigned when
        None): resubmitting a key that is still queued/in-flight
        returns the SAME future; a key that was already delivered —
        or already failed — is refused (at-most-once delivery and
        exactly-once-or-error: a key resolves once, ever; the fleet
        does not cache results). ``tenant`` names a declared
        :class:`~..config.TenantSpec` (admission then rides that
        tenant's weighted-fair lane, quota, and SLO histogram; an
        unknown name is refused — a typo must not silently bypass its
        quota). ``bank_id`` routes to a published bank (explicit id >
        the tenant's declared default > the fleet's pinned bank); the
        request binds that bank's DIGEST here, so a concurrent
        hot-swap never retargets admitted work. ``deadline_ms`` is the
        request's END-TO-END budget, relative to now (resolution:
        explicit > ``TenantSpec.deadline_ms`` >
        ``FleetConfig.deadline_ms`` > ``CCSC_REQ_DEADLINE_MS`` > no
        deadline); once it expires, the request is refused/failed
        with :class:`~.engine.DeadlineExceeded` at whatever stage it
        has reached — it never occupies a solve slot past expiry.
        ``_deadline`` (internal) is an ABSOLUTE ``time.time()``
        deadline passed through by cross-host hand-offs so queueing
        upstream shrinks the remaining budget instead of resetting
        it. Raises :class:`Overloaded` at the admission ceiling OR
        the tenant's quota (a ``tenant_reject`` — other tenants keep
        being admitted), :class:`~.engine.BucketCold` while no live
        replica has warmed the request's bucket yet (staged warmup —
        carries the same ``retry_after_s`` backoff contract),
        :class:`~.engine.DeadlineExceeded` when the budget is already
        spent at admission, and ``CCSCInputError`` for malformed
        requests."""
        from ..utils import validate

        if self._close_started:
            raise RuntimeError("fleet is closed")
        deadline = self._resolve_deadline(
            tenant, deadline_ms, _deadline
        )
        if deadline is not None and time.time() >= deadline:
            # stamped-dead on arrival: refuse before ANY admission
            # work — the client's budget is spent, honesty beats a
            # wasted solve
            with self._cv:
                self._n_deadline += 1
            self._emit(
                "deadline_exceeded", replica_id=None,
                where="admission", deadline=round(deadline, 3),
            )
            raise DeadlineExceeded("admission", deadline)
        validate.check_serve_request(
            b, self.geom, mask=mask, smooth_init=smooth_init,
            x_orig=x_orig,
        )
        self._tenants.check(tenant)
        eff_bank = self._tenants.route(tenant, bank_id)
        spatial = tuple(
            int(s) for s in np.shape(b)[self.geom.ndim_reduce:]
        )
        # oversize refusal, pre-queue (the picked bucket also names
        # the capture record's expected program)
        bslots, bsp = pick_bucket(self.buckets, spatial)
        # staged-warmup admission (serve.engine BucketCold): when NO
        # live replica has this bucket's program installed yet, refuse
        # just this bucket with a retry hint — the fleet keeps serving
        # its warm buckets while replicas stage. Checked BEFORE the
        # canonicalizing copies: a refused request must stay cheap.
        cold_eta = self._cold_eta((bslots, bsp))
        if cold_eta is not None:
            jitter = _env.env_float("CCSC_FED_RETRY_JITTER") or 0.0
            if jitter > 0:
                cold_eta *= 1.0 + random.random() * jitter
            self._emit(
                "bucket_cold", replica_id=None,
                bucket=_bucket_name(bslots, bsp),
                retry_after_s=round(cold_eta, 3),
            )
            raise BucketCold(_bucket_name(bslots, bsp), cold_eta)
        # canonicalize OUTSIDE the fleet lock: four potentially-large
        # array copies per request must not serialize every submitter
        # against the workers' _take/_deliver — nothing here reads
        # guarded state
        to32 = lambda a: None if a is None else np.asarray(a, np.float32)
        b32 = np.asarray(b, np.float32)
        mask32 = to32(mask)
        smooth32 = to32(smooth_init)
        xorig32 = to32(x_orig)
        wall0 = time.time()  # span clock: admission starts here
        reject = None
        treject = None
        with self._cv:
            if self._close_started:
                raise RuntimeError("fleet is closed")
            if not any(
                rid not in self._abandoned
                and rid not in self._scaled_down
                for rid in range(len(self._replicas))
            ):
                # every non-scaled-down replica's restart budget is
                # exhausted — no worker will ever take this request,
                # so an accepted future could never resolve
                raise RuntimeError(
                    "fleet has no live replicas left (restart budgets "
                    "exhausted)"
                )
            if key is not None:
                if key in self._index:
                    return self._index[key].future
                if key in self._delivered:
                    raise validate.CCSCInputError(
                        f"idempotency key {key!r} was already served "
                        "(at-most-once delivery: the fleet does not "
                        "cache results)"
                    )
                if key in self._failed_keys:
                    raise validate.CCSCInputError(
                        f"idempotency key {key!r} already failed "
                        "(exactly-once-or-error: the key is spent; "
                        "retry under a fresh key)"
                    )
            # bank digest binds UNDER the lock: publish_bank flips
            # the route under the same lock, so an admission can
            # never observe a torn route table
            digest = self._bank_routes.get(eff_bank)
            if digest is None:
                raise validate.CCSCInputError(
                    f"unknown bank id {eff_bank!r} — published: "
                    f"{sorted(k for k in self._bank_routes if k)} "
                    "(the fleet's pinned bank routes as "
                    "bank_id=None; publish_bank adds more)"
                )
            depth = len(self._queue)
            # per-tenant quota FIRST (the more specific refusal): a
            # bursting tenant gets its own Overloaded while other
            # tenants' admissions — and the shared queue capacity —
            # are untouched
            tq = self._tenants.quota(tenant, self._ceiling)
            if tq is not None and self._queue.depth_of(tenant) >= tq:
                self._tenant_rejects[tenant] = (
                    self._tenant_rejects.get(tenant, 0) + 1
                )
                retry = (
                    max(self._queue.depth_of(tenant), 1)
                    / self._bound_rps
                    if self._bound_rps > 0
                    else 1.0
                )
                retry = min(max(retry, 0.05), 60.0)
                treject = (
                    tenant, self._queue.depth_of(tenant), tq, retry
                )
            # rung 2 IS the reject rung: admission stays shut while
            # the ladder holds it, even once the queue dips back under
            # the hard ceiling — FleetConfig.reject_exit (the monitor's
            # exit fraction) is the hysteresis that reopens the door,
            # not the ceiling itself. Rung 3 reopens admission: the
            # degraded (faster) solve budget is what the fleet trades
            # for serving under sustained pressure, so only the hard
            # ceiling gates it there.
            elif depth >= self._ceiling or self._rung == 2:
                self._n_rejected += 1
                retry = (
                    max(depth, 1) / self._bound_rps
                    if self._bound_rps > 0
                    else 1.0
                )
                retry = min(max(retry, 0.05), 60.0)
                # emit + raise AFTER releasing the lock (the reject
                # event write can block on the stream file)
                reject = (depth, self._ceiling, RUNGS[self._rung], retry)
            else:
                if key is None:
                    # auto-assigned keys must not collide with a
                    # user-supplied key of the same shape: a collision
                    # would cross-wire two requests' delivery
                    # bookkeeping
                    while True:
                        self._seq += 1
                        key = f"req-{self._seq:08d}"
                        if (
                            key not in self._index
                            and key not in self._delivered
                            and key not in self._failed_keys
                        ):
                            break
                req = _FleetRequest(
                    key=key,
                    b=b32,
                    mask=mask32,
                    smooth_init=smooth32,
                    x_orig=xorig32,
                    future=Future(),
                    t_submit=time.perf_counter(),
                    tenant=tenant,
                    bank_id=eff_bank,
                    digest=digest,
                    deadline=deadline,
                    # span ids are assigned UNDER the lock (cheap id
                    # generation, no I/O) so a worker that takes this
                    # request immediately already sees them; the
                    # span events themselves are emitted after release
                    trace_id=trace_util.new_trace_id(),
                    root_span=trace_util.new_span_id(),
                    queue_span=trace_util.new_span_id(),
                    t_wall=wall0,
                    queue_t=time.time(),
                )
                self._index[req.key] = req
                self._queue.append(req)
                self._n_admitted += 1  # the hedge-rate denominator
                # snapshot the span ids before releasing the lock: a
                # worker can take the request (claiming queue_span)
                # the instant we release
                qspan = req.queue_span
                self._cv.notify_all()
        if treject is not None:
            t_name, t_depth, t_quota, retry = treject
            jitter = _env.env_float("CCSC_FED_RETRY_JITTER") or 0.0
            if jitter > 0:
                retry *= 1.0 + random.random() * jitter
            self._emit(
                "tenant_reject", replica_id=None,
                tenant=t_name, queue_depth=t_depth, quota=t_quota,
                retry_after_s=round(retry, 3),
            )
            raise Overloaded(
                f"tenant {t_name!r} is at its admission quota "
                f"({t_depth}/{t_quota} queued); retry after "
                f"~{retry:.2f}s (other tenants are unaffected)",
                retry_after_s=retry,
            )
        if reject is not None:
            depth, ceiling, rung, retry = reject
            # jitter the retry hint (CCSC_FED_RETRY_JITTER): N
            # federated frontends refused on the same tick would
            # otherwise all resubmit on the same tick too, arriving
            # as the very thundering herd the ceiling just rejected.
            # Applied outside the lock — the hint is advice, not
            # shared state.
            jitter = _env.env_float("CCSC_FED_RETRY_JITTER") or 0.0
            if jitter > 0:
                retry *= 1.0 + random.random() * jitter
            self._emit(
                "fleet_admission_reject", replica_id=None,
                queue_depth=depth, ceiling=ceiling, rung=rung,
                retry_after_s=round(retry, 3),
            )
            raise Overloaded(
                f"queue at its admission ceiling ({depth}/"
                f"{ceiling}, overload ladder at {rung}); retry "
                f"after ~{retry:.2f}s",
                retry_after_s=retry,
            )
        # trace spans for the accepted request (emitted OUTSIDE the
        # lock; a worker may already have taken — even delivered — it,
        # which is fine: spans match by id, not by stream order)
        trace_util.start_span(
            self._emit, trace_id=req.trace_id,
            span=trace_util.ROOT_SPAN, span_id=req.root_span,
            ts=req.t_wall, key=req.key,
            # the stamped absolute deadline travels on the root span:
            # every later deadline_exceeded/cancel/hedge decision is
            # auditable against it from the event stream alone
            deadline=(
                None if req.deadline is None
                else round(req.deadline, 3)
            ),
        )
        trace_util.emit_span(
            self._emit, trace_id=req.trace_id, span="admission",
            parent_span=req.root_span, t_start=req.t_wall,
            t_end=req.queue_t,
        )
        trace_util.start_span(
            self._emit, trace_id=req.trace_id, span="queue",
            span_id=qspan, parent_span=req.root_span,
            ts=req.queue_t, attempt=1,
        )
        if self._capture is not None and not req.key.startswith(
            _quality.PROBE_KEY_PREFIX
        ):
            # durable workload record of the ADMITTED request —
            # outside the fleet lock (sha256 + file append must not
            # serialize submitters against the workers). Golden
            # probes are excluded: synthetic quality traffic must
            # not pollute the replayable workload.
            self._capture.record_submit(
                req.key, req.trace_id, b32, mask=mask32,
                smooth_init=smooth32, x_orig=xorig32,
                bucket=_bucket_name(bslots, bsp),
                bank_id=eff_bank, tenant=tenant,
            )
        return req.future

    def reconstruct(
        self, b, mask=None, smooth_init=None, x_orig=None,
        key: Optional[str] = None,
        bank_id: Optional[str] = None,
        tenant: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> ServedResult:
        """Synchronous submit-and-wait."""
        return self.submit(
            b, mask=mask, smooth_init=smooth_init, x_orig=x_orig,
            key=key, bank_id=bank_id, tenant=tenant,
        ).result(timeout=timeout)

    def serve_many(self, requests, timeout=None) -> List[ServedResult]:
        """Submit an iterable of request dicts (keys b/mask/
        smooth_init/x_orig/key/bank_id/tenant) and wait for all
        results, in order."""
        futs = [self.submit(**req) for req in requests]
        return [f.result(timeout=timeout) for f in futs]

    # -- multi-tenant bank publication (serve.registry) ----------------
    def publish_bank(
        self, bank_id: Optional[str], d,
        tenant: Optional[str] = None,
        quality_check: Optional[bool] = None,
    ) -> Tuple[Optional[str], str]:
        """Fleet-wide zero-downtime hot-swap: make ``d`` servable on
        EVERY replica, then atomically route ``bank_id`` (None = the
        fleet's pinned default bank) to the new digest.

        The rollout is STAGGERED — one replica's plans build at a
        time (``CCSC_BANK_SWAP_STAGGER_S`` spacing), the rung-3
        staggered-recycle discipline applied to publication — so the
        plan-build burst is bounded and serving capacity never dips:
        a plan build is a few FFTs and factorizations (the kernels are
        shared by every bank) and traffic keeps flowing on the old
        digest throughout. Requests admitted
        before the flip bound the OLD digest and finish on it; the
        first admission after the flip serves the new one. The
        cutover is one ``bank_swap`` event carrying both digests.

        A replica that dies mid-rollout is fine: its restart
        republishes every retained bank before taking work
        (``_spawn_replica``), and requeued requests re-serve against
        their admission-time digest on any survivor. Returns
        ``(old_digest, new_digest)``.

        ``quality_check`` (None = the ``CCSC_QUALITY_GATE`` flag)
        arms the publish-time quality gate: the candidate digest's
        ``kind=quality`` ledger history (shadow scores from
        ``serve.quality.score_bank``) is judged against the live
        history's quality band and a regression raises
        :class:`~.quality.QualityGateError` BEFORE any replica sees
        the bank — the held-out-parity publish guard online
        dictionary learning rides on."""
        from ..utils import validate

        if self._close_started:
            raise RuntimeError("fleet is closed")
        validate.check_filters(d, self.geom)
        digest = _registry.bank_digest(d)
        if quality_check is None:
            quality_check = _env.env_flag("CCSC_QUALITY_GATE")
        if quality_check:
            _quality.gate_publish(digest, bank_id=bank_id)
        arr = np.asarray(d)
        with self._cv:
            if self._close_started:
                raise RuntimeError("fleet is closed")
            # retained bytes FIRST: any replica restarting from here
            # on republishes the new bank before taking work
            self._bank_arrays[digest] = arr
            old = self._bank_routes.get(bank_id)
            reps = [
                rep for rep in self._replicas
                if rep is not None and not rep.retired
            ]
        stagger = _env.env_float("CCSC_BANK_SWAP_STAGGER_S") or 0.0
        for i, rep in enumerate(reps):
            if i and stagger > 0 and self._closing.wait(stagger):
                raise RuntimeError("fleet closed mid-publish")
            try:
                rep.engine.add_bank(arr)
            except RuntimeError:
                # a replica that closed under us (crash handoff in
                # flight): its replacement republishes from
                # _bank_arrays, so the rollout still completes
                continue
        with self._cv:
            if self._close_started:
                raise RuntimeError("fleet is closed")
            self._bank_routes[bank_id] = digest
            # the demotion advisory's restoration target: what this
            # bank served BEFORE this flip (no-op on a republish of
            # the same digest — a refresh must not make a bank its
            # own rollback)
            if old is not None and old != digest:
                self._bank_prev[bank_id] = old
        self._emit(
            "bank_swap", replica_id=None,
            bank_id=bank_id, old_digest=old, new_digest=digest,
            tenant=tenant, replicas=len(reps),
        )
        self._run.console(
            f"fleet: bank {bank_id if bank_id else '<default>'} "
            f"hot-swapped {old} -> {digest} across {len(reps)} "
            "replica(s)",
            tier="brief",
        )
        self._retire_stale_banks()
        return old, digest

    def _retire_stale_banks(self) -> None:
        """Memory-bounding sweep after a route flip: drop superseded
        digests NOTHING references anymore — not routed by any bank
        id, not bound by any queued or assigned request (those finish
        on their admission-time plan; the next publish retries the
        sweep). A fleet republishing a refreshed bank continuously
        must not accumulate every superseded copy forever."""
        with self._cv:
            routed = set(self._bank_routes.values())
            bound = {r.digest for r in self._queue if r.digest}
            for rep in self._replicas:
                if rep is not None:
                    bound.update(
                        r.digest for r in rep.assigned if r.digest
                    )
            stale = [
                dg for dg in self._bank_arrays
                if dg not in routed and dg not in bound
            ]
            for dg in stale:
                del self._bank_arrays[dg]
            reps = [
                rep for rep in self._replicas
                if rep is not None and not rep.retired
            ]
        for dg in stale:
            for rep in reps:
                # best-effort: an engine still referencing the digest
                # locally refuses and keeps its copy; nothing can
                # bind the digest again, so that copy is the last
                try:
                    rep.engine.retire_bank(dg)
                except Exception:
                    pass

    @property
    def bank_ids(self) -> List[str]:
        """Published bank ids (the pinned default bank routes as
        None and is not listed)."""
        with self._cv:
            return sorted(
                k for k in self._bank_routes if k is not None
            )

    def bank_digest(self, bank_id: Optional[str] = None) -> str:
        """The digest ``bank_id`` currently routes to (None = the
        fleet's pinned default bank)."""
        from ..utils import validate

        with self._cv:
            digest = self._bank_routes.get(bank_id)
        if digest is None:
            raise validate.CCSCInputError(
                f"unknown bank id {bank_id!r}"
            )
        return digest

    def stats(self) -> Dict[str, object]:
        """Fleet aggregates: delivery counts, latency percentiles,
        admission/requeue/duplicate counters, per-replica liveness.
        Percentiles come from the fleet-wide streaming histogram
        (serve.slo) — the same numbers the slo_histogram events and
        the metricsd scrape quote; ``_latencies`` keeps the exact
        newest-window sample for cross-checks and debugging."""
        with self._cv:
            reps = [
                None if r is None else {
                    "replica": r.id,
                    "state": r.state,
                    "generation": r.generation,
                    "served": r.served,
                    "restarts": self._restarts.get(r.id, 0),
                    "devices": r.engine.devices,
                    "mesh": (
                        list(r.engine.mesh_shape)
                        if r.engine.mesh_shape
                        else None
                    ),
                }
                for r in self._replicas
            ]
            depth = len(self._queue)
            n_delivered = self._n_delivered
        return {
            "n_requests": n_delivered,
            "n_rejected": self._n_rejected,
            "n_requeued": self._n_requeued,
            "n_duplicates_suppressed": self._n_duplicates,
            "n_failed": self._n_failed,
            "queue_depth": depth,
            "queue_ceiling": self._ceiling,
            "overload_rung": RUNGS[self._rung],
            "p50_latency_s": _ms_to_s(
                self._slo.percentile("total", 0.50)
            ),
            "p99_latency_s": _ms_to_s(
                self._slo.percentile("total", 0.99)
            ),
            "replicas": reps,
            "tenants": {
                t: {
                    "delivered": self._tenant_delivered.get(t, 0),
                    "rejected": self._tenant_rejects.get(t, 0),
                    "p50_latency_s": _ms_to_s(
                        self._tenant_slos.percentile(t, 0.50)
                    ),
                    "p99_latency_s": _ms_to_s(
                        self._tenant_slos.percentile(t, 0.99)
                    ),
                }
                for t in self._tenants.names()
            },
            "banks": {
                (bid if bid is not None else "<default>"): dg
                for bid, dg in self._bank_routes.items()
            },
        }

    def _ledger_append(self, st: Dict[str, object]) -> None:
        """Append this serving run's normalized record to the
        durable perf ledger (analysis.ledger; no-op unless
        CCSC_PERF_LEDGER is set): achieved fleet requests/sec over
        the run's lifetime, keyed by chip + solve-shape bucket +
        the replicas' resolved knob dict. Never raises — the ledger
        must not fail a fleet close."""
        try:
            from ..analysis import ledger as _ledger

            if not _ledger.enabled():
                return
            n = int(st.get("n_requests") or 0)
            elapsed = time.time() - self._t_start
            chip = self._run.chip
            if n <= 0 or elapsed <= 0 or not chip:
                return
            from ..tune import store as tune_store
            from ..utils import obs

            knobs = next(
                (
                    dict(rep.engine._knob_dict)
                    for rep in self._replicas
                    if rep is not None
                    and getattr(rep.engine, "_knob_dict", None)
                ),
                {},
            )
            n_reps = sum(
                1 for rep in self._replicas if rep is not None
            ) or self._replica_target
            knobs["replicas"] = n_reps
            if self.total_devices > n_reps:
                # only a meshed fleet carries the topology key: an
                # all-single-device fleet's knob digest (its ledger
                # history key) stays exactly the pre-mesh one
                knobs["total_devices"] = self.total_devices
            _spatial = max(
                (sp for _s_, sp in self.buckets),
                key=lambda sp: tuple(sp),
            )
            workload = tune_store.solve_workload(self.geom)
            rec = _ledger.maybe_append(
                chip=chip,  # normalize_record canonicalizes
                kind="serve",
                workload=workload,
                shape_key=tune_store.solve_shape_key(
                    workload,
                    k=self.geom.num_filters,
                    support=tuple(self.geom.spatial_support),
                    spatial=tuple(_spatial),
                ),
                knobs=knobs,
                value=n / elapsed,
                unit="requests/sec",
                git_sha=obs.git_sha(),
                n_compiles=(
                    self._run.compile_monitor.summary()["n_compiles"]
                    if self._run.compile_monitor is not None
                    else None
                ),
                source="serve.fleet",
            )
            if rec is not None:
                self._emit(
                    "ledger_append",
                    replica_id=None,
                    key=_ledger.record_key(rec),
                    value=rec["value"],
                    unit=rec["unit"],
                    path=_ledger.default_ledger_path(),
                )
        except Exception:  # pragma: no cover - defensive
            pass

    def close(self, drain_timeout_s: float = 600.0):
        """Serve every queued request, retire the replicas, and close
        the telemetry run with the fleet summary. Re-entrant and
        race-safe (same contract as ``CodecEngine.close``). Requests
        still undelivered after ``drain_timeout_s`` get an explicit
        error."""
        with self._close_lock:
            owner = not self._close_started
            self._close_started = True
        if not owner:
            self._close_done.wait()
            return
        self._closing.set()
        try:
            with self._cv:
                self._cv.notify_all()
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                with self._cv:
                    busy = bool(self._queue) or any(
                        rep is not None and rep.assigned
                        and not rep.retired
                        for rep in self._replicas
                    )
                    any_live = any(
                        rep is not None and not rep.retired
                        for rep in self._replicas
                    )
                if not busy or not any_live:
                    break
                time.sleep(0.02)
            self._stop_monitor.set()
            self._monitor.join(timeout=5.0)
            # the probe thread shares _stop_monitor but a sweep in
            # flight holds result futures — give it the same drain
            # grace as a worker before engines close under it
            if self._probe_thread is not None:
                self._probe_thread.join(timeout=60.0)
            # the recycle walker polls _close_started at 50ms — join
            # it so it cannot be alive at interpreter exit
            if self._recycle_thread is not None:
                self._recycle_thread.join(timeout=10.0)
            # a restart thread caught mid-engine-build must finish and
            # release its engine (the `closing` branch in _restart)
            # before the interpreter can safely exit
            with self._cv:
                pending_restarts = list(self._restart_threads)
            for t in pending_restarts:
                t.join(timeout=120.0)
            # workers exit once the queue is dry; join briefly, then
            # close engines (re-entrant — a straggler's own close on
            # exit is a no-op)
            for rep in self._replicas:
                if rep is None:
                    continue
                if rep.thread is not None:
                    rep.thread.join(timeout=60.0)
                try:
                    rep.watchdog.stop()
                except Exception:
                    pass
                try:
                    rep.engine.close()
                except Exception:
                    pass
                if rep.state == "live":
                    rep.state = "stopped"
            # final per-replica heartbeat: a short run may never reach
            # a monitor tick, and the FLEET report's liveness column
            # reads heartbeats — every replica gets a terminal one.
            # Snapshot under the lock, emit OUTSIDE it: the stream
            # write can block on file I/O and must not hold the queue
            # mutex (lint: thread-safety)
            with self._cv:
                depth = len(self._queue)
                final_rows = [
                    dict(
                        replica_id=rep.id, state=rep.state,
                        generation=rep.generation, served=rep.served,
                        inflight=len(rep.assigned), queue_depth=depth,
                        restarts=self._restarts.get(rep.id, 0),
                        devices=rep.engine.devices,
                        final=True,
                    )
                    for rep in self._replicas
                    if rep is not None
                ]
            for row in final_rows:
                self._emit("fleet_heartbeat", **row)
            undelivered: List[_FleetRequest] = []
            shutdown_spans: List = []  # (req, queue_span, attempt_span, root_owed)
            with self._cv:
                undelivered.extend(
                    # a queued hedge clone whose primary already
                    # delivered is not a casualty — its story closed
                    r for r in self._queue
                    if r.key not in self._delivered
                )
                self._queue.clear()
                for rep in self._replicas:
                    if rep is None:
                        continue
                    undelivered.extend(
                        r for r in rep.assigned
                        if r.key not in self._delivered
                    )
                    rep.assigned = []
                for r in undelivered:
                    self._index.pop(r.key, None)
                    if r.trace_id is not None:
                        qs, r.queue_span = r.queue_span, None
                        att, r.attempt_span = r.attempt_span, None
                        pr = r.primary or r
                        owed = not pr.root_done
                        pr.root_done = True
                        r.root_done = True
                        if qs or att or owed:
                            shutdown_spans.append((r, qs, att, owed))
                # hedge clones share their primary's key: one request,
                # one failure — don't count the pair twice
                self._n_failed += sum(
                    1 for r in undelivered if not r.hedge_of
                )
            # a shut-down fleet still closes every story: whatever
            # span the request had open ends 'shutdown', so the trace
            # reassembles gap-free even for requests the close failed
            wall = time.time()
            for r, qs, att, root_owed in shutdown_spans:
                if qs:
                    trace_util.end_span(
                        self._emit, trace_id=r.trace_id, span="queue",
                        span_id=qs, parent_span=r.root_span,
                        status="shutdown", ts=wall,
                    )
                if att:
                    trace_util.end_span(
                        self._emit, trace_id=r.trace_id,
                        span="attempt", span_id=att,
                        parent_span=r.root_span, status="shutdown",
                        ts=wall, t_start=r.attempt_t,
                    )
                if root_owed:
                    trace_util.end_span(
                        self._emit, trace_id=r.trace_id,
                        span=trace_util.ROOT_SPAN,
                        span_id=r.root_span, status="shutdown",
                        ts=wall, t_start=r.t_wall,
                    )
            for r in undelivered:
                try:
                    r.future.set_exception(
                        RuntimeError(
                            "fleet closed before this request could "
                            "be served"
                        )
                    )
                except InvalidStateError:
                    pass
            if self._metricsd is not None:
                # final snapshot rides stop(); the endpoint dies with
                # the fleet it describes
                try:
                    self._metricsd.stop()
                except Exception:
                    pass
            if self._capture is not None:
                # seal the capture with the fleet's final admission
                # counters: replay diffs its own admission behavior
                # against these (the recorded-vs-replayed story)
                with self._cv:
                    cap_final = dict(
                        n_delivered=self._n_delivered,
                        n_rejected=self._n_rejected,
                        n_requeued=self._n_requeued,
                        n_failed=self._n_failed,
                    )
                try:
                    self._capture.close(**cap_final)
                except Exception:
                    pass
            if not self._run.closed:
                # closing histogram flush: the stream always ends
                # with one complete fleet-wide slo_histogram per
                # phase (offline percentile recomputation — the
                # acceptance contract of the SLO layer), plus one
                # per declared tenant (the TENANTS report's source)
                _breaches, snaps = self._slo.final()
                for sn in snaps:
                    self._emit("slo_histogram", replica_id=None, **sn)
                _t_breaches, t_snaps = self._tenant_slos.final()
                for sn in t_snaps:
                    self._emit("slo_histogram", replica_id=None, **sn)
                # ... and the quality plane's closing flush: one
                # complete quality_histogram per (bank, tenant,
                # bucket) plus the accumulated solve diagnostics
                _qb, q_snaps, q_diags = self._quality.final()
                for sn in q_snaps:
                    self._emit(
                        "quality_histogram", replica_id=None, **sn
                    )
                for dg in q_diags:
                    self._emit(
                        "quality_solve_diag", replica_id=None, **dg
                    )
            if not self._run.closed:
                st = self.stats()
                self._ledger_append(st)
                self._run.close(
                    status="ok",
                    n_requests=st["n_requests"],
                    n_rejected=st["n_rejected"],
                    n_requeued=st["n_requeued"],
                    n_duplicates_suppressed=st[
                        "n_duplicates_suppressed"
                    ],
                    n_failed=st["n_failed"],
                    p50_latency_s=st["p50_latency_s"],
                    p99_latency_s=st["p99_latency_s"],
                )
        finally:
            self._close_done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
