"""Typed configuration of the PyTorch/CUDA port.

A jax-free copy of ``ccsc_code_iccv2017_tpu.config``'s ``ProblemGeom``,
``GEOM_2D``, ``LearnConfig``, ``SolveConfig``, ``ServeConfig``,
``TenantSpec``, ``FleetConfig`` and ``ControllerConfig``: every
field, name and default is identical (tests/test_torch_config.py holds
the two side by side), so a configuration reads the same in both
packages. The port implements the reconstruction solves, the
consensus, masked and streaming learners, the serving engine, the
serving fleet, its federation across processes and its capacity
controller, their run telemetry (``metrics_dir``, the SLO targets,
``verbose='all'`` figures) and the performance knobs with their
autotuner (``herm_inv``, ``fft_impl``, ``outer_chunk`` /
``donate_state``, ``pipeline_depth``, ``tune`` / ``tune_store``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ProblemGeom:
    """Geometry of one CCSC problem family, dimension-generic.

    - ``spatial_support``: spatial filter support over which the FFT is
      taken, e.g. (11, 11) for 2D.
    - ``reduce_shape``: extra filter/data dims shared by one code map
      (wavelengths, angular views). Empty for 2D/3D.
    - ``num_filters``: k, the filter-bank size.

    Canonical layouts (batch leading, FFT axes trailing):

    ==========  =========================================
    data b      [n, *reduce, *spatial]
    filters d   [k, *reduce, *spatial_support]
    codes z     [n, k, *spatial_padded]
    Dz          [n, *reduce, *spatial_padded]
    ==========  =========================================
    """

    spatial_support: Tuple[int, ...]
    num_filters: int
    reduce_shape: Tuple[int, ...] = ()

    @property
    def ndim_spatial(self) -> int:
        return len(self.spatial_support)

    @property
    def ndim_reduce(self) -> int:
        return len(self.reduce_shape)

    @property
    def reduce_size(self) -> int:
        return math.prod(self.reduce_shape) if self.reduce_shape else 1

    @property
    def psf_radius(self) -> Tuple[int, ...]:
        # floor(psf_s/2) per spatial dim
        return tuple(s // 2 for s in self.spatial_support)

    def padded_shape(self, data_spatial: Tuple[int, ...]) -> Tuple[int, ...]:
        """Spatial shape after symmetric zero padding by psf_radius."""
        return tuple(
            s + 2 * r for s, r in zip(data_spatial, self.psf_radius)
        )

    @property
    def filter_shape(self) -> Tuple[int, ...]:
        return (self.num_filters, *self.reduce_shape, *self.spatial_support)


GEOM_2D = lambda k=100, s=11: ProblemGeom((s, s), k)


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    """Hyperparameters of the consensus dictionary learner.

    Defaults follow 2D/learn_kernels_2D_large.m:15-24 and the rho
    constants of admm_learn_conv2D_large_dzParallel.m (rho_d=5000,
    rho_z=1). See the JAX package's ``LearnConfig`` for the full story
    of each field; the notes here cover what differs in the port.

    - ``fused_z``: on a CUDA tensor the z inner iteration runs the two
      hand-written kernels K2a/K2b (ops.fused_z); on a CPU tensor their
      plain version. Only the 2D, W == 1 learner takes it; every other
      geometry takes the composition path, as in JAX.
    - ``fused_z_precision``: all three tiers run K2's float32 body (full
      f32 on the CUDA cores), which meets the bounds JAX sets for
      ``"high"`` and ``"default"`` a fortiori. K2 is not bound by its
      operations on the card, so a cheaper tier would buy nothing.
    - ``carry_freq``: the masked learner (models.learn_masked) carries
      the spectrum across its inner iterations; the consensus learner
      does not read it, as in JAX.
    - ``use_pallas`` is kept for name parity and is not read: on a CUDA
      tensor the composition path's z-solve always runs K1.
    - ``storage_dtype`` / ``d_storage_dtype``: ``float32`` or
      ``bfloat16`` (f32 math, rounded store, as in JAX).
    - ``metrics_dir``: the run's telemetry stream (utils.obs);
      ``verbose='all'`` also writes per-iteration figures as PNG files
      (utils.display).
    - ``watchdog`` / ``watchdog_slack``: the dispatch-fence watchdog
      (utils.watchdog) around each step's one host read; its deadline
      comes from the H100 row of the roofline on the card.
    - ``outer_chunk`` / ``donate_state``: the chunked driver
      (models.learn.outer_chunk_scan): ``outer_chunk`` steps with one
      host read a chunk; ``donate_state`` adopts each step into the
      input state's storage (``torch.where(..., out=)``), so a chunk
      holds one state fewer.
    - ``fft_impl``: 'xla' (torch.fft) or the matmul-DFT tiers
      (ops.fourier), whose three accuracy classes are JAX's.
    - ``tune``: 'auto' / 'sweep' are resolved by the learner apps before
      the run (tune.autotune.resolve_learn); a learner called directly
      runs the config as written, as in JAX.
    """

    lambda_residual: float = 1.0
    lambda_prior: float = 1.0
    max_it: int = 20
    tol: float = 1e-3
    max_it_d: int = 5
    max_it_z: int = 10
    rho_d: float = 5000.0
    rho_z: float = 1.0
    num_blocks: int = 1
    dtype: str = "float32"
    verbose: str = "brief"  # 'none' | 'brief' | 'all'
    track_objective: Optional[bool] = None
    compat_coding: str = "consensus"
    use_pallas: bool = False
    fused_z: bool = False
    fused_z_precision: str = "highest"
    fft_pad: str = "none"
    storage_dtype: str = "float32"
    d_storage_dtype: str = "float32"
    fft_impl: str = "xla"
    outer_chunk: int = 1
    donate_state: bool = False
    max_recoveries: int = 0
    rho_backoff: float = 0.5
    metrics_dir: Optional[str] = None
    watchdog: bool = False
    watchdog_slack: float = 20.0
    carry_freq: bool = False
    tune: str = "off"

    @property
    def with_objective(self) -> bool:
        if self.track_objective is None:
            return self.verbose != "none"
        return self.track_objective

    @property
    def with_obs_metrics(self) -> bool:
        """True when the step computes the telemetry scalars
        (models.learn.ObsExtras): only with ``metrics_dir`` set, so an
        un-instrumented run computes exactly what it did before."""
        return self.metrics_dir is not None

    def __post_init__(self):
        # the JAX package's own validation, identical messages
        if self.outer_chunk < 1:
            raise ValueError(
                f"outer_chunk must be >= 1, got {self.outer_chunk}"
            )
        if self.max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {self.max_recoveries}"
            )
        if not (0.0 < self.rho_backoff <= 1.0):
            raise ValueError(
                f"rho_backoff must be in (0, 1], got {self.rho_backoff}"
            )
        if self.watchdog_slack <= 0:
            raise ValueError(
                f"watchdog_slack must be > 0, got {self.watchdog_slack}"
            )
        if self.tune not in ("off", "auto", "sweep"):
            raise ValueError(
                f"tune must be 'off' | 'auto' | 'sweep', got "
                f"{self.tune!r}"
            )
        if self.fused_z_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"fused_z_precision must be 'highest' | 'high' | "
                f"'default', got {self.fused_z_precision!r}"
            )

    @property
    def chunked_driver(self) -> bool:
        """True when the driver must route through the chunked step
        (models.learn.outer_chunk_scan): outer_chunk > 1, or
        donate_state, which implies chunking even at outer_chunk=1."""
        return self.outer_chunk > 1 or self.donate_state


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Hyperparameters of the reconstruction (coding) solve.

    ``gamma_factor``/``gamma_ratio`` encode the per-app gamma heuristic
    ``g = factor * lambda_prior / max(b); gamma = [g/ratio, g]``
    (inpainting 60/100). See the JAX package's ``SolveConfig`` for the
    full story of each field; the notes here cover what differs in the
    port.

    ``use_pallas`` is kept for name parity and is not read: on a CUDA
    tensor the W == 1 z-solve always runs the hand-written rank-1 kernel
    (ops.kernels.solve_z_rank1). ``herm_inv`` selects the W > 1
    problems' Gram inverse (ops.freq_solvers.hermitian_inverse; None
    reads ``CCSC_HERM_INV``, else Cholesky). ``fft_impl`` picks torch.fft
    ('xla') or a matmul-DFT tier. ``tune`` 'auto' / 'sweep' resolves the
    knobs from the tuned store at ``reconstruct`` (tune.autotune).
    """

    lambda_residual: float = 5.0
    lambda_prior: float = 2.0
    max_it: int = 100
    tol: float = 1e-3
    gamma_factor: float = 60.0
    gamma_ratio: float = 100.0
    scale_rho_by_reduce: bool = False
    lambda_smooth: float = 0.5
    dtype: str = "float32"
    verbose: str = "brief"
    track_objective: Optional[bool] = None
    track_psnr: Optional[bool] = None
    use_pallas: bool = False
    fft_pad: str = "none"
    fft_impl: str = "xla"
    storage_dtype: str = "float32"
    herm_inv: Optional[str] = None
    metrics_dir: Optional[str] = None
    tune: str = "off"
    track_diagnostics: bool = False

    def __post_init__(self):
        if self.tune not in ("off", "auto", "sweep"):
            raise ValueError(
                f"tune must be 'off' | 'auto' | 'sweep', got "
                f"{self.tune!r}"
            )
        if self.storage_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"storage_dtype must be 'float32' | 'bfloat16', got "
                f"{self.storage_dtype!r}"
            )
        if self.herm_inv not in (None, "cholesky", "schur", "newton"):
            raise ValueError(
                f"herm_inv must be None | 'cholesky' | 'schur' | "
                f"'newton', got {self.herm_inv!r}"
            )

    @property
    def with_objective(self) -> bool:
        if self.track_objective is None:
            return self.verbose != "none"
        return self.track_objective

    @property
    def with_psnr(self) -> bool:
        if self.track_psnr is None:
            return self.verbose != "none"
        return self.track_psnr


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Configuration of the reconstruction serving engine
    (serve.CodecEngine): the shape-bucket table, the micro-batch flush
    and what a result carries. Every field, name and default is the JAX
    package's (tests/test_torch_config.py holds them side by side; see
    its ``ServeConfig`` for each field's story).

    ``buckets`` is ``((slots, spatial_shape), ...)``: a request is padded
    (mask-excluded) up to the smallest bucket that fits, and up to
    ``slots`` requests ride one dispatch of that bucket. The port serves
    ``buckets``, ``max_wait_ms``, ``return_codes``, ``verbose``,
    ``aot_warmup`` (one short warm dispatch per bucket at construction,
    which builds the kernels and the cuFFT plans), ``mesh_shape``,
    ``mesh_devices``, ``metrics_dir`` (the engine's telemetry stream),
    the SLO fields (``slo_p50_ms``, ``slo_p99_ms``, ``slo_check_s``,
    ``slo_profile_dir``: serve.slo), ``capture_dir`` (workload
    capture of a standalone engine: serve.capture; None falls back to
    ``CCSC_CAPTURE_DIR``, "" is off), ``replica_id`` (the fleet's), and
    the warmup fields: ``compile_cache`` (the directory the kernel
    libraries are built into and kept in), ``artifact_store`` (a library
    store shared between hosts: serve.artifacts), ``staged_warmup``,
    ``warm_order`` and ``warm_rank_capture`` (serve.engine, hot to cold;
    each None falls back to its ``CCSC_*`` knob, and "" of a path is
    off), ``tune`` / ``tune_store`` (the engine resolves its SolveConfig
    from the tuned store at construction: tune.autotune.resolve_solve)
    and ``pipeline_depth`` (None: ``CCSC_SERVE_PIPELINE``; at 2 the
    worker uploads batch n+1 on a copy stream while batch n solves).

    ``mesh_shape`` ``(batch,)`` or ``(batch, freq)`` serves every bucket
    from a mesh of devices driven by the engine's one process (None:
    the ``CCSC_SERVE_MESH`` env knob, else one device; ``()``: one
    device regardless of the knob): each bucket's slots split over the
    batch axis, and each slot's per-frequency z-solves over 'freq'.
    ``mesh_devices`` names the card index of each mesh position in
    row-major order (batch outer); an index may repeat, so
    ``mesh_devices=(0, 0)`` runs two positions on one card. Every
    bucket's slots must divide by the batch axis.
    """

    buckets: Tuple[Tuple[int, Tuple[int, ...]], ...]
    max_wait_ms: float = 5.0
    compile_cache: Optional[str] = None
    aot_warmup: bool = True
    return_codes: bool = False
    metrics_dir: Optional[str] = None
    verbose: str = "brief"
    tune: str = "off"
    tune_store: Optional[str] = None
    replica_id: Optional[int] = None
    slo_p50_ms: Optional[float] = None
    slo_p99_ms: Optional[float] = None
    slo_check_s: Optional[float] = None
    slo_profile_dir: Optional[str] = None
    capture_dir: Optional[str] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_devices: Optional[Tuple[int, ...]] = None
    artifact_store: Optional[str] = None
    staged_warmup: Optional[bool] = None
    warm_order: Optional[Tuple[str, ...]] = None
    warm_rank_capture: Optional[str] = None
    pipeline_depth: Optional[int] = None

    def __post_init__(self):
        # the JAX package's checks and normalization, verbatim
        for fname in ("slo_p50_ms", "slo_p99_ms", "slo_check_s"):
            v = getattr(self, fname)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{fname} must be > 0 when set, got {v}"
                )
        if self.tune not in ("off", "auto", "sweep"):
            raise ValueError(
                f"tune must be 'off' | 'auto' | 'sweep', got "
                f"{self.tune!r}"
            )
        if self.replica_id is not None and int(self.replica_id) < 0:
            raise ValueError(
                f"replica_id must be >= 0, got {self.replica_id}"
            )
        if (
            self.pipeline_depth is not None
            and int(self.pipeline_depth) < 1
        ):
            raise ValueError(
                f"pipeline_depth must be >= 1 when set, got "
                f"{self.pipeline_depth}"
            )
        if not self.buckets:
            raise ValueError("ServeConfig.buckets must be non-empty")
        norm = []
        for entry in self.buckets:
            try:
                slots, spatial = entry
                spatial = tuple(int(s) for s in spatial)
                slots = int(slots)
            except (TypeError, ValueError):
                raise ValueError(
                    f"bucket {entry!r} is not (slots, spatial_shape)"
                )
            if slots < 1 or any(s < 1 for s in spatial):
                raise ValueError(
                    f"bucket {entry!r}: slots and spatial dims must be "
                    ">= 1"
                )
            norm.append((slots, spatial))
        ndims = {len(sp) for _, sp in norm}
        if len(ndims) > 1:
            raise ValueError(
                f"buckets mix spatial ranks {sorted(ndims)} — one "
                "engine serves one problem family"
            )
        # sorted by volume, so picking a bucket is "first that fits"
        object.__setattr__(
            self,
            "buckets",
            tuple(sorted(norm, key=lambda e: math.prod(e[1]))),
        )
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}"
            )
        if self.warm_order is not None:
            if isinstance(self.warm_order, str):
                raise ValueError(
                    f"warm_order {self.warm_order!r} is a string — "
                    "pass a tuple of bucket labels like "
                    "('8@32x32', '4@16x16')"
                )
            object.__setattr__(
                self,
                "warm_order",
                tuple(str(n) for n in self.warm_order),
            )
        if self.mesh_shape is not None:
            if isinstance(self.mesh_shape, str):
                raise ValueError(
                    f"mesh_shape {self.mesh_shape!r} is a string — "
                    "pass a tuple of axis sizes (e.g. (4, 2)); spec "
                    "strings like '4x2' belong to --mesh / "
                    "CCSC_SERVE_MESH"
                )
            try:
                mesh = tuple(int(a) for a in self.mesh_shape)
            except (TypeError, ValueError):
                raise ValueError(
                    f"mesh_shape {self.mesh_shape!r} is not a tuple "
                    "of axis sizes"
                )
            if mesh == ():
                # () = explicitly single-device
                object.__setattr__(self, "mesh_shape", ())
                if self.mesh_devices is not None:
                    raise ValueError(
                        "mesh_devices without a mesh is meaningless"
                    )
            else:
                if not 1 <= len(mesh) <= 2 or any(
                    a < 1 for a in mesh
                ):
                    raise ValueError(
                        f"mesh_shape must be (batch,) or "
                        f"(batch, freq) with positive axes, got "
                        f"{mesh}"
                    )
                object.__setattr__(self, "mesh_shape", mesh)
                bad = [
                    (s, sp) for s, sp in self.buckets if s % mesh[0]
                ]
                if bad:
                    raise ValueError(
                        f"mesh batch axis {mesh[0]} must divide "
                        f"every bucket's slots; offending buckets "
                        f"{bad} of {list(self.buckets)} — resize the "
                        "buckets or the mesh"
                    )
                if self.mesh_devices is not None:
                    devs = tuple(int(i) for i in self.mesh_devices)
                    if len(devs) != math.prod(mesh) or any(
                        i < 0 for i in devs
                    ):
                        raise ValueError(
                            f"mesh_devices needs {math.prod(mesh)} "
                            f"non-negative device indices for mesh "
                            f"{mesh}, got {devs}"
                        )
                    object.__setattr__(self, "mesh_devices", devs)
        elif self.mesh_devices is not None:
            raise ValueError(
                "mesh_devices without mesh_shape is meaningless"
            )


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One serving tenant's declared contract (serve.tenancy): which
    bank its requests route to by default, its latency SLO targets,
    its admission quota, and its weighted-fair share.

    - ``tenant``: the tenant name requests carry (``submit(...,
      tenant=...)``).
    - ``bank_id``: default bank this tenant's requests route to when
      the request names none (serve.registry ids). None = the fleet's
      pinned default bank.
    - ``slo_p50_ms`` / ``slo_p99_ms``: declared per-tenant
      submit->result latency targets, checked by the tenant's own
      streaming histogram (serve.slo.TenantSlos) — breaches emit
      ``slo_breach`` events carrying the tenant name. None = no
      target declared for that quantile (NO env fallback here: a
      fleet-wide CCSC_SLO_* knob must not silently become every
      tenant's contract).
    - ``quota``: max requests this tenant may hold QUEUED at once;
      admission past it is an explicit ``Overloaded`` refusal
      (``tenant_reject``) while other tenants keep being admitted.
      None = derived from the fleet ceiling x weight share x
      ``CCSC_TENANT_QUOTA_FRAC``.
    - ``weight``: weighted-fair dequeue share (a weight-2 tenant is
      served twice as often as a weight-1 tenant when both have work
      queued).
    """

    tenant: str
    bank_id: Optional[str] = None
    slo_p50_ms: Optional[float] = None
    slo_p99_ms: Optional[float] = None
    quota: Optional[int] = None
    weight: float = 1.0
    # Declared served-quality floor (dB): the tenant's median
    # valid-region PSNR must stay at or above this; judged by the
    # quality monitor (serve.quality.QualityMonitor) with the SLO
    # breach discipline — `quality_breach` events, re-fire dedup.
    # None = no floor declared (same no-env-fallback stance as the
    # latency targets: a fleet-wide knob must not become every
    # tenant's quality contract). Only requests carrying ground
    # truth (x_orig) count toward the floor.
    min_psnr_db: Optional[float] = None
    # Default end-to-end deadline (ms) stamped on this tenant's
    # requests at fleet admission when the submit names none. The
    # resolution ladder is explicit submit(deadline_ms=) > this >
    # CCSC_REQ_DEADLINE_MS > no deadline — the env knob here IS a
    # fallback (unlike the SLO targets) because a deadline is a
    # safety bound, not a contract: a fleet-wide budget tightening
    # every tenant is the conservative direction.
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError(
                f"tenant must be a non-empty string, got "
                f"{self.tenant!r}"
            )
        for fname in (
            "slo_p50_ms", "slo_p99_ms", "min_psnr_db", "deadline_ms"
        ):
            v = getattr(self, fname)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{fname} must be > 0 when set, got {v}"
                )
        if self.quota is not None and self.quota < 1:
            raise ValueError(
                f"quota must be >= 1 when set, got {self.quota}"
            )
        if not self.weight > 0:
            raise ValueError(
                f"weight must be > 0, got {self.weight}"
            )


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Configuration of the fault-tolerant serving fleet
    (serve.ServeFleet) — N replicated :class:`~serve.CodecEngine`\\ s
    behind one front queue, with health-driven requeue and admission
    control.

    The replicas share nothing but the queue (the MPAX fleet of
    solver instances over pinned problem structure, PAPERS.md
    arXiv:2412.09734):
    each owns a private engine built from the same pinned
    (bank, problem, SolveConfig, ServeConfig), so a request served by
    any replica is bit-identical to a single-engine serve of the same
    request. Admission is bounded by a queue-depth ceiling — explicit
    (``max_queue_depth``) or derived from the measured
    ``utils.perfmodel.serving_bound`` x live-replica count x
    ``max_queue_s`` — and overload walks a three-rung ladder
    (shed micro-batch waiting -> reject with retry-after -> degrade
    the solve budget) so saturation produces predictable latency
    instead of OOM.
    """

    # number of engine replicas
    replicas: int = 2
    # explicit admission ceiling on queued (not yet assigned) requests;
    # None = derive from perfmodel.serving_bound: once a dispatch has
    # measured an iteration rate, ceiling = bound requests/sec x live
    # replicas x max_queue_s (floored at min_queue_depth). Before any
    # measurement a static floor of
    # max(min_queue_depth, 2 x total slots x replicas) applies.
    max_queue_depth: Optional[int] = None
    # target worst-case queueing delay used by the derived ceiling
    max_queue_s: float = 2.0
    # floor of the derived ceiling (admission must never starve a
    # healthy fleet)
    min_queue_depth: int = 8
    # per-request delivery attempts before the future gets an error
    # (the exactly-once-OR-ERROR half of the delivery contract): a
    # request is requeued when its replica dies or stalls, at most
    # max_attempts - 1 times
    max_attempts: int = 3
    # per-replica restart budget (crash or stall casualties; the
    # scripts/supervise.py discipline, in-process)
    max_restarts: int = 3
    # base restart delay; restart k of a replica sleeps
    # restart_backoff_s * 2^(k-1), capped at 30 s
    restart_backoff_s: float = 0.25
    # health monitor cadence (overload-ladder evaluation + ceiling
    # refresh); per-replica stall detection runs on the watchdog's own
    # thread at watchdog cadence
    health_interval_s: float = 0.1
    # fleet_heartbeat cadence per replica (obs stream; the liveness
    # signal scripts/obs_report.py and watchdog.check_replicas read)
    heartbeat_s: float = 5.0
    # slack multiplier on the per-replica dispatch deadline (same role
    # as LearnConfig.watchdog_slack; the floor is CCSC_WATCHDOG_MIN_S)
    stall_slack: float = 20.0
    # overload ladder thresholds, as fractions of the queue ceiling:
    # rung 1 (shed max_wait_ms micro-batch waiting) enters at shed_at
    # and exits below shed_exit; rung 2 (reject) enters at 1.0 and
    # exits below reject_exit
    shed_at: float = 0.5
    shed_exit: float = 0.25
    reject_exit: float = 0.75
    # rung 3 (degrade): sustained rejection for this many seconds
    # recycles replicas onto a degraded solve budget
    # (max_it x degrade_max_it_factor) — bounded latency under
    # saturation at reduced solve quality. 0 disables rung 3.
    degrade_after_s: float = 30.0
    degrade_max_it_factor: float = 0.5
    # delivery bookkeeping is BOUNDED (a serving process lives for
    # days; per-request state must not grow to OOM under the very
    # admission control that exists to prevent it): the newest
    # key_window served/failed idempotency keys are remembered for
    # at-most-once suppression and resubmit refusal — a straggler
    # delayed by more than key_window requests, or a resubmit of a
    # key that old, is outside the protection window
    key_window: int = 100_000
    # latency percentiles (stats / summary) are computed over the
    # newest latency_window deliveries
    latency_window: int = 10_000
    # fleet telemetry dir (utils.obs): the fleet stream lands here and
    # each replica engine's stream in a replica-NN/ subdir
    metrics_dir: Optional[str] = None
    verbose: str = "brief"
    # Fleet-wide latency SLO targets (ms) on submit->result — the
    # full queue-wait + ownership + solve + delivery path, which is
    # what a client experiences (a replica's engine-local histogram
    # cannot see fleet queueing or requeue retries). Checked by the
    # monitor thread at CCSC_SLO_CHECK_S cadence; breaches emit
    # `slo_breach` events with replica_id=None (fleet scope). None =
    # the CCSC_SLO_* env knobs.
    slo_p50_ms: Optional[float] = None
    slo_p99_ms: Optional[float] = None
    # Live metrics surface (serve.metricsd): port for the stdlib
    # Prometheus-text HTTP endpoint (0 = an ephemeral port, reported
    # in the fleet_metricsd event). None = CCSC_METRICSD_PORT env
    # knob; unset = no endpoint.
    metricsd_port: Optional[int] = None
    # Atomic snapshot file of the same exposition for scrape-less
    # environments. None = CCSC_METRICSD_SNAPSHOT env, else (when the
    # endpoint is on and a metrics_dir exists) metrics_dir/
    # metrics.prom.
    metricsd_snapshot: Optional[str] = None
    # Workload capture (serve.capture): when set — or via
    # CCSC_CAPTURE_DIR — every ADMITTED request is durably recorded
    # under this directory (relative arrival time, idempotency key,
    # trace id, payloads content-addressed by sha256 with cross-
    # request dedup) and paired with its outcome digest + PSNR +
    # latency at delivery, so the stream can be re-served
    # bit-checkably by serve.replay. None = the CCSC_CAPTURE_DIR env
    # knob (unset = capture off); "" = explicitly OFF even when the
    # env knob is armed (replay fleets must never re-capture the
    # stream they are replaying).
    capture_dir: Optional[str] = None
    # Fraction of admitted requests captured, deterministic per
    # idempotency key (a request and its outcome always land on the
    # same side). None = CCSC_CAPTURE_SAMPLE (default 1.0).
    capture_sample: Optional[float] = None
    # Heterogeneous replica shapes: one entry per replica — a mesh
    # shape tuple (the replica's engine shards its bucket programs
    # over that many devices, ServeConfig.mesh_shape semantics) or
    # None (a single-device replica). None (default) = every replica
    # inherits ServeConfig.mesh_shape. The fleet assigns disjoint
    # device slices when the pool is large enough, scales the derived
    # admission ceiling by each replica's device count
    # (utils.perfmodel.fleet_serving_bound), and counts mesh devices
    # in capacity_hint (federation claim sizing).
    replica_meshes: Optional[
        Tuple[Optional[Tuple[int, ...]], ...]
    ] = None
    # Declared tenants (serve.tenancy): per-tenant bank routing,
    # latency SLO targets, admission quotas, and weighted-fair
    # dequeue shares. None (default) = the untenanted fleet — one
    # queue, the fleet-wide SLO, the historical behavior exactly.
    # With tenants declared, submit(..., tenant=...) must name one of
    # them (or None for untenanted traffic).
    tenants: Optional[Tuple[TenantSpec, ...]] = None
    # Golden-probe store (serve.quality.ProbeSet): a directory of
    # deterministic probe requests + content-addressed reference
    # outcomes (capture payload-store layout). None = the
    # CCSC_PROBE_DIR env knob; "" = explicitly off (the capture_dir
    # convention). Auto-generated on first use when the directory
    # has no probes yet.
    probe_dir: Optional[str] = None
    # Probe cadence in seconds: the fleet serves every probe through
    # idle capacity at this interval and scores it bit-exact + in dB
    # against the stored reference for the live bank digest;
    # regressions emit quality_probe_breach + a demotion advisory.
    # None = CCSC_PROBE_INTERVAL_S (unset/0 = probing off).
    probe_interval_s: Optional[float] = None
    # Request lifecycle ------------------------------------------
    # Fleet-wide default end-to-end deadline (ms) for requests whose
    # submit and tenant name none. None = the CCSC_REQ_DEADLINE_MS
    # env knob (unset = no deadline).
    deadline_ms: Optional[float] = None
    # Hedged attempts against gray replicas: an attempt that has been
    # in flight longer than hedge_after_ms is re-enqueued on a
    # DIFFERENT replica; first result wins through the at-most-once
    # fencing, the loser is suppressed-and-counted. None =
    # CCSC_HEDGE_AFTER_MS, else adaptive: the hedge_quantile of the
    # fleet's recent delivery-latency histogram (so "anomalously
    # slow" tracks the workload instead of a magic number).
    hedge_after_ms: Optional[float] = None
    # Latency quantile the adaptive hedge_after derives from. None =
    # CCSC_HEDGE_QUANTILE (default 0.95).
    hedge_quantile: Optional[float] = None
    # Cap on hedges as a fraction of admitted requests — hedging must
    # never amplify an overload into a retry storm. None =
    # CCSC_HEDGE_MAX_FRAC (default 0 = hedging OFF; setting this > 0
    # is how hedging is enabled).
    hedge_max_frac: Optional[float] = None

    def __post_init__(self):
        if (
            self.probe_interval_s is not None
            and self.probe_interval_s < 0
        ):
            raise ValueError(
                f"probe_interval_s must be >= 0, got "
                f"{self.probe_interval_s}"
            )
        for fname in (
            "slo_p50_ms", "slo_p99_ms", "deadline_ms",
            "hedge_after_ms",
        ):
            v = getattr(self, fname)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{fname} must be > 0 when set, got {v}"
                )
        if self.hedge_quantile is not None and not (
            0.0 < self.hedge_quantile < 1.0
        ):
            raise ValueError(
                f"hedge_quantile must be in (0, 1), got "
                f"{self.hedge_quantile}"
            )
        if self.hedge_max_frac is not None and not (
            0.0 <= self.hedge_max_frac <= 1.0
        ):
            raise ValueError(
                f"hedge_max_frac must be in [0, 1], got "
                f"{self.hedge_max_frac}"
            )
        if self.metricsd_port is not None and self.metricsd_port < 0:
            raise ValueError(
                f"metricsd_port must be >= 0, got {self.metricsd_port}"
            )
        if self.capture_sample is not None and not (
            0.0 <= self.capture_sample <= 1.0
        ):
            raise ValueError(
                f"capture_sample must be in [0, 1], got "
                f"{self.capture_sample}"
            )
        if self.replicas < 1:
            raise ValueError(
                f"replicas must be >= 1, got {self.replicas}"
            )
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got "
                f"{self.max_queue_depth}"
            )
        if self.max_queue_s <= 0:
            raise ValueError(
                f"max_queue_s must be > 0, got {self.max_queue_s}"
            )
        if self.min_queue_depth < 1:
            raise ValueError(
                f"min_queue_depth must be >= 1, got "
                f"{self.min_queue_depth}"
            )
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}"
            )
        if self.key_window < 1:
            raise ValueError(
                f"key_window must be >= 1, got {self.key_window}"
            )
        if self.latency_window < 1:
            raise ValueError(
                f"latency_window must be >= 1, got "
                f"{self.latency_window}"
            )
        if self.stall_slack <= 0:
            raise ValueError(
                f"stall_slack must be > 0, got {self.stall_slack}"
            )
        if not (0.0 < self.shed_exit <= self.shed_at <= 1.0):
            raise ValueError(
                "need 0 < shed_exit <= shed_at <= 1, got "
                f"shed_exit={self.shed_exit}, shed_at={self.shed_at}"
            )
        if not (0.0 < self.reject_exit <= 1.0):
            raise ValueError(
                f"reject_exit must be in (0, 1], got {self.reject_exit}"
            )
        if self.degrade_after_s < 0:
            raise ValueError(
                f"degrade_after_s must be >= 0, got "
                f"{self.degrade_after_s}"
            )
        if not (0.0 < self.degrade_max_it_factor <= 1.0):
            raise ValueError(
                f"degrade_max_it_factor must be in (0, 1], got "
                f"{self.degrade_max_it_factor}"
            )
        if self.replica_meshes is not None:
            if len(self.replica_meshes) != self.replicas:
                raise ValueError(
                    f"replica_meshes has {len(self.replica_meshes)} "
                    f"entries for {self.replicas} replica(s) — one "
                    "mesh shape (or None) per replica"
                )
            norm_meshes = []
            for i, m in enumerate(self.replica_meshes):
                if m is None:
                    norm_meshes.append(None)
                    continue
                try:
                    if isinstance(m, str):
                        # "12" would iterate characters into (1, 2)
                        raise TypeError(m)
                    mesh = tuple(int(a) for a in m)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"replica_meshes[{i}] = {m!r} is not a tuple "
                        "of axis sizes (use e.g. (2,) or (4, 2), not "
                        "a bare int or a spec string)"
                    )
                if not 1 <= len(mesh) <= 2 or any(a < 1 for a in mesh):
                    raise ValueError(
                        f"replica_meshes[{i}] must be (batch,) or "
                        f"(batch, freq) with positive axes, got {m!r}"
                    )
                norm_meshes.append(mesh)
            object.__setattr__(
                self, "replica_meshes", tuple(norm_meshes)
            )
        if self.tenants is not None:
            norm_tenants = []
            for i, spec in enumerate(self.tenants):
                if not isinstance(spec, TenantSpec):
                    raise ValueError(
                        f"tenants[{i}] = {spec!r} is not a TenantSpec"
                    )
                norm_tenants.append(spec)
            names = [s.tenant for s in norm_tenants]
            if len(names) != len(set(names)):
                dupes = sorted(
                    n for n in set(names) if names.count(n) > 1
                )
                raise ValueError(
                    f"duplicate tenant name(s) {dupes} — one "
                    "TenantSpec per tenant"
                )
            object.__setattr__(
                self, "tenants", tuple(norm_tenants)
            )


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Configuration of the SLO-feedback capacity controller
    (serve.CapacityController) — the strictly-advisory control plane
    over a :class:`~serve.ServeFleet`. Every field, default and refusal
    is the JAX package's (tests/test_torch_config.py holds them side by
    side); ``hbm_limit_mb`` is read against ``torch.cuda.memory_stats``'
    peak (utils.memwatch).

    The controller reads one consistent sensor snapshot per tick
    (queue depth vs the derived admission ceiling, SLO p99 vs target,
    warmup ETAs, measured HBM watermark) and drives the fleet's
    actuators (``set_replica_count`` grow/shrink, the brownout rung,
    federated host spin-up/down) inside the ``[min_replicas,
    max_replicas]`` bounds. Every ``None`` field resolves from the
    matching ``CCSC_CTRL_*`` env knob at controller start, so a config
    object only pins what a caller cares about.

    Robustness contract: hysteresis bands (``high_frac``/``low_frac``,
    ``brownout_frac``/``brownout_exit_frac``) plus ``sustain`` streaks
    prevent flapping; stale sensors (older than ``stale_s``) hold
    state and never scale *down*; actuators run under
    timeout/retry/backoff with a stuck-actuator circuit breaker; and
    the controller dying leaves the fleet serving exactly as last
    configured (all capacity state lives in the fleet, none in the
    controller).
    """

    # replica-count bounds the controller may move within
    min_replicas: int = 1
    max_replicas: int = 2
    # control-loop tick interval; None = CCSC_CTRL_INTERVAL_S
    interval_s: Optional[float] = None
    # queue-depth/ceiling fraction above which scale-up pressure
    # registers; None = CCSC_CTRL_HIGH_FRAC
    high_frac: Optional[float] = None
    # fraction below which scale-down is considered (only with SLO
    # green and the ladder at rung 0); None = CCSC_CTRL_LOW_FRAC
    low_frac: Optional[float] = None
    # consecutive ticks a signal must persist before the controller
    # acts (flap guard); None = CCSC_CTRL_SUSTAIN
    sustain: Optional[int] = None
    # per-actuator cooldown after a successful invocation;
    # None = CCSC_CTRL_COOLDOWN_S
    cooldown_s: Optional[float] = None
    # sensor snapshot age beyond which telemetry is stale (fail safe:
    # hold, never scale down); None = CCSC_CTRL_STALE_S
    stale_s: Optional[float] = None
    # actuator invocation timeout / retries / backoff base;
    # None = CCSC_CTRL_ACT_TIMEOUT_S / _ACT_RETRIES / _ACT_BACKOFF_S
    act_timeout_s: Optional[float] = None
    act_retries: Optional[int] = None
    act_backoff_s: Optional[float] = None
    # consecutive exhausted invocations that open the circuit breaker,
    # and how long it stays open; None = CCSC_CTRL_BREAKER_AFTER /
    # CCSC_CTRL_BREAKER_RESET_S
    breaker_after: Optional[int] = None
    breaker_reset_s: Optional[float] = None
    # brownout hysteresis band (engage at brownout_frac, release below
    # brownout_exit_frac); None = CCSC_CTRL_BROWNOUT_FRAC /
    # CCSC_CTRL_BROWNOUT_EXIT_FRAC
    brownout_frac: Optional[float] = None
    brownout_exit_frac: Optional[float] = None
    # measured HBM watermark (MB) above which scale-up is vetoed;
    # None = CCSC_CTRL_HBM_LIMIT_MB (0 = no veto)
    hbm_limit_mb: Optional[float] = None
    # federated host-count bounds (None = host pool not controller-
    # managed; requires a host_pool actuator at construction)
    min_hosts: Optional[int] = None
    max_hosts: Optional[int] = None

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need min_replicas <= max_replicas, got "
                f"{self.min_replicas} > {self.max_replicas}"
            )
        for fname in (
            "interval_s", "cooldown_s", "stale_s", "act_timeout_s",
            "act_backoff_s", "breaker_reset_s",
        ):
            v = getattr(self, fname)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{fname} must be > 0 when set, got {v}"
                )
        for fname in ("sustain", "breaker_after"):
            v = getattr(self, fname)
            if v is not None and v < 1:
                raise ValueError(
                    f"{fname} must be >= 1 when set, got {v}"
                )
        if self.act_retries is not None and self.act_retries < 0:
            raise ValueError(
                f"act_retries must be >= 0 when set, got "
                f"{self.act_retries}"
            )
        if self.hbm_limit_mb is not None and self.hbm_limit_mb < 0:
            raise ValueError(
                f"hbm_limit_mb must be >= 0 when set, got "
                f"{self.hbm_limit_mb}"
            )
        for lo_name, hi_name in (
            ("low_frac", "high_frac"),
            ("brownout_exit_frac", "brownout_frac"),
        ):
            lo, hi = getattr(self, lo_name), getattr(self, hi_name)
            for fname, v in ((lo_name, lo), (hi_name, hi)):
                if v is not None and not 0.0 < v <= 1.5:
                    raise ValueError(
                        f"{fname} must be in (0, 1.5] when set, "
                        f"got {v}"
                    )
            if lo is not None and hi is not None and lo >= hi:
                raise ValueError(
                    f"need {lo_name} < {hi_name} (a hysteresis "
                    f"band), got {lo} >= {hi}"
                )
        if (self.min_hosts is None) != (self.max_hosts is None):
            raise ValueError(
                "min_hosts and max_hosts must be set together"
            )
        if self.min_hosts is not None:
            if self.min_hosts < 0:
                raise ValueError(
                    f"min_hosts must be >= 0, got {self.min_hosts}"
                )
            if self.max_hosts < self.min_hosts:
                raise ValueError(
                    f"need min_hosts <= max_hosts, got "
                    f"{self.min_hosts} > {self.max_hosts}"
                )
