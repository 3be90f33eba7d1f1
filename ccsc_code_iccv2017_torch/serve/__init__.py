"""Serving: the single-device reconstruction engine (torch port of
``ccsc_code_iccv2017_tpu.serve``'s ``CodecEngine`` core, its plan LRU
and its valid-region PSNR). The fleet, federation, capture/replay,
tenancy, SLO and telemetry layers are ROADMAP.md Queue 1 items 10-11.
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
