"""The traced run: ``torch.profiler`` (CPU and CUDA) over a stretch of
the window, the benchmark's own host spans around its calls into each
layer, and what per-layer metrics read from them.

All times are epoch seconds (the profiler's clock is the wall clock).
A device operation is every event that ran on the card (kernels,
copies, sets); a span is a ``record_function`` named ``portbench.*``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

from . import stats

SPAN_PREFIX = "portbench."
TOP = 10  # entries of each list of the breakdown


@dataclasses.dataclass
class Trace:
    t0: float
    t1: float
    device_ops: List[Tuple[str, float, float]]  # (name, start, end)
    spans: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return stats.covered(((s, e) for _, s, e in self.device_ops),
                             self.t0, self.t1)

    def ops_named(self, needles) -> List[Tuple[str, float, float]]:
        return [op for op in self.device_ops
                if any(n in op[0] for n in needles)]


class Tracer:
    """Off: spans are no-ops and nothing is recorded. On: ``prepare``
    in set-up, then ``start`` and ``stop`` bracket the profiled stretch
    (from the thread that drives the window), which ``stop`` parses
    into ``trace``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._t0: Optional[float] = None
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    def prepare(self) -> None:
        """Initialise the profiler once in set-up (CUPTI's start takes
        seconds), so that starting the stretch does not stall the
        window."""
        if not self.enabled:
            return
        import torch

        with torch.profiler.profile(activities=_activities()):
            torch.ones(8, device="cuda" if torch.cuda.is_available()
                       else "cpu").sum().item()

    def start(self) -> None:
        if not self.enabled or self._t0 is not None:
            return  # one stretch a run
        import torch

        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.__enter__()
        self._t0 = time.time()

    def stop(self, until: Optional[float] = None) -> None:
        """End the stretch; ``until`` (epoch s) clips it, so that it may
        be stopped after the window without reading past it."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time() if until is None else min(time.time(), until)
        self._prof.__exit__(None, None, None)
        self.trace = _parse(self._prof, self._t0, max(t1, self._t0))
        self._prof = None


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    if torch.cuda.is_available():
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def _parse(prof, t0: float, t1: float) -> Trace:
    from torch.autograd import DeviceType

    dev, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        iv = (e.name(), s, s + e.duration_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(iv)
        elif e.name().startswith(SPAN_PREFIX):
            spans.append((iv[0][len(SPAN_PREFIX):], iv[1], iv[2]))
        elif not e.is_user_annotation():
            host.append(iv)
    return Trace(t0, t1, dev, spans, host)


def _label(tr: Trace, lo: float, hi: float) -> str:
    """What the host was doing in an idle gap: the innermost benchmark
    span over its middle, then the host operation that overlaps it
    most."""
    mid = 0.5 * (lo + hi)
    inner = [sp for sp in tr.spans if sp[1] <= mid <= sp[2]]
    name = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "none"
    best, best_ov = None, 0.0
    for op, s, e in tr.host_ops:
        ov = min(e, hi) - max(s, lo)
        if ov > best_ov:
            best, best_ov = op, ov
    return f"{name} / {best or 'no host op'}"[:200]


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time (summed by name) and
    the longest idle gaps, labelled by what the host was doing."""
    by_name = {}
    for name, s, e in tr.device_ops:
        ov = min(e, tr.t1) - max(s, tr.t0)
        if ov > 0:
            by_name[name[:200]] = by_name.get(name[:200], 0.0) + ov
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(stats.gaps(((s, e) for _, s, e in tr.device_ops),
                             tr.t0, tr.t1), key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[_label(tr, lo, hi), hi - lo] for lo, hi in gaps]}
