"""Serving: the reconstruction engine (torch port of
``ccsc_code_iccv2017_tpu.serve``'s ``CodecEngine`` core on one device or
a mesh, its plan LRU, its valid-region PSNR, its telemetry and SLO
layer, ``serve.slo``, and its workload capture, ``serve.capture``). The
fleet, federation, replay, tenancy and quality plane are ROADMAP.md
Queue 1 item 11.
"""
from .capture import WorkloadRecorder
from .engine import (
    CodecEngine,
    DeadlineExceeded,
    ServedResult,
    pick_bucket,
)
from .quality import valid_region_psnr
from .registry import PlanCache, bank_digest

__all__ = [
    "CodecEngine",
    "DeadlineExceeded",
    "PlanCache",
    "ServedResult",
    "WorkloadRecorder",
    "bank_digest",
    "pick_bucket",
    "valid_region_psnr",
]
