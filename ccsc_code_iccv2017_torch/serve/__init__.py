"""Serving: the reconstruction engine (torch port of
``ccsc_code_iccv2017_tpu.serve``'s ``CodecEngine`` on one device or a
mesh, its plan LRU, its valid-region PSNR, its telemetry and SLO layer,
``serve.slo``, and its workload capture, ``serve.capture``) and the
serving fleet in one process: :class:`ServeFleet` (serve.fleet, N
replica engines behind one front queue with idempotency keys, requeue,
restarts, admission control and the overload ladder), the durable
:class:`BankRegistry` (serve.registry), tenancy (serve.tenancy), the
quality observatory (serve.quality) and the metrics endpoint
:class:`MetricsD` (serve.metricsd); and across processes: the durable
file-lease queue :class:`DurableQueue` (serve.dqueue), federation
(:class:`FederatedFrontend`, :class:`FederatedHost`,
:class:`FederatedHostPool`, serve.federation), the SLO-feedback
:class:`CapacityController` (serve.controller) and deterministic traffic
replay (:class:`ReplayDriver`, :func:`generate_diurnal`, serve.replay);
and the warmup: the library store (:class:`ArtifactStore`,
:func:`library_key`, :func:`rank_buckets`, serve.artifacts), the
compile cache (:func:`enable_compile_cache`) and staged warmup
(serve.engine).
"""
from .artifacts import (
    ArtifactStore,
    bucket_label,
    library_key,
    rank_buckets,
    resolve_artifact_dir,
)
from .capture import WorkloadRecorder
from .controller import ActuatorStuck, BreakerOpen, CapacityController
from .dqueue import DurableQueue
from .engine import (
    BucketCold,
    CodecEngine,
    DeadlineExceeded,
    ServedResult,
    enable_compile_cache,
    pick_bucket,
)
from .federation import (
    FederatedFrontend,
    FederatedHost,
    FederatedHostPool,
    FederatedResult,
)
from .fleet import Overloaded, ServeFleet
from .metricsd import MetricsD
from .quality import valid_region_psnr
from .registry import BankRegistry, PlanCache, bank_digest
from .replay import ReplayDriver, generate_diurnal
from .slo import Histogram, SloMonitor, TenantSlos
from .tenancy import (
    TenantSpec,
    TenantTable,
    WeightedFairScheduler,
    parse_tenant_spec,
)

__all__ = [
    "ActuatorStuck",
    "ArtifactStore",
    "BankRegistry",
    "BreakerOpen",
    "BucketCold",
    "CapacityController",
    "CodecEngine",
    "DeadlineExceeded",
    "DurableQueue",
    "FederatedFrontend",
    "FederatedHost",
    "FederatedHostPool",
    "FederatedResult",
    "Histogram",
    "MetricsD",
    "Overloaded",
    "PlanCache",
    "ReplayDriver",
    "ServeFleet",
    "ServedResult",
    "SloMonitor",
    "TenantSlos",
    "TenantSpec",
    "TenantTable",
    "WeightedFairScheduler",
    "WorkloadRecorder",
    "bank_digest",
    "bucket_label",
    "enable_compile_cache",
    "generate_diurnal",
    "library_key",
    "parse_tenant_spec",
    "pick_bucket",
    "rank_buckets",
    "resolve_artifact_dir",
    "valid_region_psnr",
]
