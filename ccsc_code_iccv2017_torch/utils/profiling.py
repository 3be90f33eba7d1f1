"""Profiling and tracing utilities (torch port of
``ccsc_code_iccv2017_tpu.utils.profiling``).

- ``xla_trace(log_dir)``: a ``torch.profiler`` capture around any code
  region, written as a Chrome trace (``*.pt.trace.json``, which
  TensorBoard's PyTorch profiler plugin and chrome://tracing read). The
  name is the JAX package's, so the call sites read alike.
- ``annotate(name)``: a named span in the capture
  (``torch.profiler.record_function``).
- ``SectionTimers``: accumulating named wall-clock timers for host-side
  phases (a copy of the JAX package's).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


def profiler_active() -> bool:
    """Whether a torch profiler is recording in this process."""
    import torch

    return bool(torch._C._autograd._profiler_enabled())


@contextlib.contextmanager
def xla_trace(log_dir: Optional[str], device=None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region into ``log_dir``
    (no-op if None).

    It records the host's operators and ``annotate`` spans (the CPU
    activity) and, when ``device`` is a CUDA device (None: whenever a
    card is visible), every kernel and copy on the card (the CUDA
    activity, through CUPTI). On exit ``tensorboard_trace_handler``
    writes one ``<host>_<pid>.<ns>.pt.trace.json`` into ``log_dir``.

    Only one torch profiler can record at a time: starting a capture
    while another is active (``profile_solve``, a caller's own
    ``torch.profiler.profile``) raises instead of nesting or skipping.
    """
    if log_dir is None:
        yield
        return
    import torch

    if profiler_active():
        raise RuntimeError(
            f"cannot start a profiler capture into {log_dir!r}: another "
            "torch profiler is already recording in this process (only "
            "one can be active at a time)"
        )
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
        if cuda:
            # the capture must hold the kernels, not just their launches
            torch.cuda.synchronize(device)


def annotate(name: str):
    """Named span visible in profiler timelines (a cheap context
    manager when no capture is active)."""
    import torch

    return torch.profiler.record_function(name)


class SectionTimers:
    """Accumulating wall-clock timers keyed by section name.

    >>> timers = SectionTimers()
    >>> with timers.section("load"):
    ...     load()
    >>> timers.report()   # {'load': 1.23}
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float) -> None:
        """Charge ``dt`` seconds to a section directly — for drivers
        that already hold a measured duration (chunk fences) and
        cannot wrap the region in a context manager."""
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def drain(self) -> Dict[str, Dict[str, float]]:
        """Return {name: {'s': total, 'n': count}} accumulated since
        the last drain and reset — the event-stream protocol of
        utils.obs.Run.drain_timers (each ``phase`` record carries the
        delta, so consecutive records sum to the run total)."""
        out = {
            k: {"s": round(v, 6), "n": self.counts.get(k, 0)}
            for k, v in self.totals.items()
        }
        self.totals = {}
        self.counts = {}
        return out

    def __str__(self) -> str:
        return "  ".join(
            f"{k}={v:.2f}s/{self.counts[k]}x"
            for k, v in sorted(self.totals.items())
        )
