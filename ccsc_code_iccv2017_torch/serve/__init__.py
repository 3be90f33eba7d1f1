"""Serving: the reconstruction engine (torch port of
``ccsc_code_iccv2017_tpu.serve``'s ``CodecEngine`` on one device or a
mesh, its plan LRU, its valid-region PSNR, its telemetry and SLO layer,
``serve.slo``, and its workload capture, ``serve.capture``) and the
serving fleet in one process: :class:`ServeFleet` (serve.fleet, N
replica engines behind one front queue with idempotency keys, requeue,
restarts, admission control and the overload ladder), the durable
:class:`BankRegistry` (serve.registry), tenancy (serve.tenancy), the
quality observatory (serve.quality) and the metrics endpoint
:class:`MetricsD` (serve.metricsd). Federation, the durable queue,
replay, the capacity controller and the artifact store are ROADMAP.md
Queue 1 item 11, second half.
"""
from .capture import WorkloadRecorder
from .engine import (
    BucketCold,
    CodecEngine,
    DeadlineExceeded,
    ServedResult,
    pick_bucket,
)
from .fleet import Overloaded, ServeFleet
from .metricsd import MetricsD
from .quality import valid_region_psnr
from .registry import BankRegistry, PlanCache, bank_digest
from .slo import Histogram, SloMonitor, TenantSlos
from .tenancy import (
    TenantSpec,
    TenantTable,
    WeightedFairScheduler,
    parse_tenant_spec,
)

__all__ = [
    "BankRegistry",
    "BucketCold",
    "CodecEngine",
    "DeadlineExceeded",
    "Histogram",
    "MetricsD",
    "Overloaded",
    "PlanCache",
    "ServeFleet",
    "ServedResult",
    "SloMonitor",
    "TenantSlos",
    "TenantSpec",
    "TenantTable",
    "WeightedFairScheduler",
    "WorkloadRecorder",
    "bank_digest",
    "parse_tenant_spec",
    "pick_bucket",
    "valid_region_psnr",
]
