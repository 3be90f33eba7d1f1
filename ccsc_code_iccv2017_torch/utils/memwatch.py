"""Measured device-memory watermark and OOM forensics (torch port of
``ccsc_code_iccv2017_tpu.utils.memwatch``).

- :class:`MemWatch` samples ``torch.cuda.memory_stats(dev)`` at the
  driver's existing fences (the obs layer calls ``sample()`` from
  ``Run.chunk`` and ``Run.close``, so it adds no synchronisation) and
  keeps each card's peak: the caching allocator's own high-water mark
  ``allocated_bytes.all.peak``, with ``reserved_bytes.all.peak`` beside
  it. It reads the peak and never resets it
  (``torch.cuda.reset_peak_memory_stats`` belongs to the caller: a run
  measures from wherever its caller last reset). A CPU device has no
  stats, so every method does nothing there.
- :meth:`MemWatch.watermark_record` — the ``mem_watermark`` obs record:
  the measured peak against a modeled estimate, flagged when the
  relative delta exceeds ``CCSC_MEM_DELTA_FRAC``.
- :func:`oom_dump` — on a ``torch.cuda.OutOfMemoryError`` (:func:`is_oom`)
  an atomic JSON dump of every card's memory stats and the error text,
  announced by a ``mem_oom_dump`` obs record.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional

from . import env as _env

__all__ = ["MemWatch", "is_oom", "oom_dump"]


def _device_stats(dev) -> Optional[Dict[str, float]]:
    """One device's allocator stats, or None where there are none (a
    CPU device). ``dev`` is a torch device or anything with a
    ``memory_stats()`` method (the tests' fakes)."""
    if hasattr(dev, "memory_stats"):
        try:
            stats = dev.memory_stats()
        except Exception:
            return None
    else:
        import torch

        dev = torch.device(dev)
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
    if not isinstance(stats, dict) or not stats:
        return None
    return stats


def _cuda_devices() -> List:
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class MemWatch:
    """Peak device-memory poller. ``enabled=False`` (or
    ``CCSC_MEMWATCH=0``) makes every method a cheap no-op, and so does a
    device without memory stats. ``devices``: the torch devices to read
    (None: every visible card); tests pass objects with a
    ``memory_stats()`` method and an ``id``."""

    def __init__(self, devices=None, enabled: Optional[bool] = None):
        self.enabled = (
            _env.env_flag("CCSC_MEMWATCH") if enabled is None
            else bool(enabled)
        )
        self._devices = devices
        self._peak: Dict[object, int] = {}
        self._reserved: Dict[object, int] = {}
        self.n_samples = 0

    def _resolve_devices(self) -> List:
        if self._devices is None:
            self._devices = _cuda_devices()
        return self._devices

    def sample(self) -> Optional[int]:
        """Read every device's stats once; returns the current total
        bytes allocated (None when no device reports)."""
        if not self.enabled:
            return None
        total = None
        for dev in self._resolve_devices():
            stats = _device_stats(dev)
            if stats is None:
                continue
            key = getattr(dev, "id", None)
            if key is None:
                key = str(dev)
            peak = stats.get("allocated_bytes.all.peak")
            if peak is not None:
                # the allocator's own high-water mark: exact, and
                # monotone until someone resets it
                self._peak[key] = max(self._peak.get(key, 0), int(peak))
            reserved = stats.get("reserved_bytes.all.peak")
            if reserved is not None:
                self._reserved[key] = max(self._reserved.get(key, 0),
                                          int(reserved))
            cur = stats.get("allocated_bytes.all.current")
            if cur is not None:
                total = (total or 0) + int(cur)
        self.n_samples += 1
        return total

    @property
    def peak_bytes(self) -> Optional[int]:
        """Max per-device peak observed so far (None when no device ever
        reported: 'not measured', not 0)."""
        return max(self._peak.values()) if self._peak else None

    @property
    def total_peak_bytes(self) -> Optional[int]:
        """Sum of per-device peaks, the footprint a run spread over its
        cards (what a modeled whole-problem estimate compares with)."""
        return sum(self._peak.values()) if self._peak else None

    @property
    def reserved_peak_bytes(self) -> Optional[int]:
        """Max per-device peak of the allocator's reserved bytes."""
        return max(self._reserved.values()) if self._reserved else None

    @property
    def watermark_source(self) -> Optional[str]:
        """'allocator_peak' once a device reported, else None."""
        return "allocator_peak" if self._peak else None

    def watermark_record(
        self, modeled_bytes: Optional[int] = None
    ) -> Optional[Dict]:
        """The ``mem_watermark`` obs record (None when there is nothing
        to report: no measurement and no model). The delta compares the
        modeled whole-problem estimate with the measured total across
        devices."""
        peak = self.peak_bytes
        total = self.total_peak_bytes
        if peak is None and modeled_bytes is None:
            return None
        delta = None
        flagged = False
        if total is not None and modeled_bytes:
            delta = (total - modeled_bytes) / float(modeled_bytes)
            flagged = abs(delta) > _env.env_float("CCSC_MEM_DELTA_FRAC")
        return {
            "peak_hbm_bytes": peak,
            "peak_hbm_bytes_total": total,
            "peak_reserved_bytes": self.reserved_peak_bytes,
            "modeled_hbm_bytes": (
                None if modeled_bytes is None else int(modeled_bytes)
            ),
            "delta_frac": None if delta is None else round(delta, 4),
            "flagged": flagged,
            "n_samples": self.n_samples,
            "source": self.watermark_source,
        }


def is_oom(e: BaseException) -> bool:
    """A device-memory failure: ``torch.cuda.OutOfMemoryError``, or an
    error whose text says so (an OOM raised through another layer)."""
    import torch

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}"
    return "out of memory" in s or "Out of memory" in s


def oom_dump(
    exc: BaseException,
    dump_dir: Optional[str] = None,
    devices=None,
) -> Optional[str]:
    """Write an OOM forensic dump and return its path (None when ``exc``
    is not a device-memory failure): every device's memory stats, the
    error text and provenance, written atomically (tmp + rename), and a
    ``mem_oom_dump`` record into the current obs run. Never raises:
    forensics must not mask the original error."""
    if not is_oom(exc):
        return None
    try:
        out_dir = (
            _env.env_str("CCSC_MEM_DUMP_DIR")
            or dump_dir
            or tempfile.gettempdir()
        )
        if devices is None:
            devices = _cuda_devices()
        rows = [{"device": str(dev), "stats": _device_stats(dev)}
                for dev in devices]
        from . import obs

        dump = {
            "t": time.time(),
            "error": f"{type(exc).__name__}: {exc}"[:4000],
            "git_sha": obs.git_sha(),
            "devices": rows,
        }
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"ccsc_oom_dump_{int(time.time() * 1e3)}.json"
        )
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(dump, f, indent=1, default=str)
        os.replace(tmp, path)
        obs.record("mem_oom_dump", path=path, error=dump["error"][:300])
        return path
    except Exception:  # forensics must not mask the original error
        return None
