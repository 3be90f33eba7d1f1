"""Serving: the reconstruction engine (torch port of
``ccsc_code_iccv2017_tpu.serve``'s ``CodecEngine`` core on one device or
a mesh, its plan LRU, its valid-region PSNR, and its telemetry and SLO
layer, ``serve.slo``). Capture is ROADMAP.md Queue 1 item 10; the
fleet, federation, replay, tenancy and quality plane are item 11.
"""
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
    "bank_digest",
    "pick_bucket",
    "valid_region_psnr",
]
