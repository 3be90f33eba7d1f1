"""What a run hands to the metric readers (``portbench/metrics/*.py``).

A reader is a file named after its metric with one function,
``read(run: RunRecord) -> float | None``; it returns None where the run
has nothing for it to read, and the harness then leaves the metric out
of the result line.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .trace import Trace

# the H100 SXM5 data sheet; the card's power limit is printed beside
# every run
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 66.9e12}


@dataclasses.dataclass
class RunRecord:
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    window_t0: float = 0.0  # epoch s
    # served requests due (open loop) or sent (closed loop) in the
    # window: pool, due, submit, done (epoch s; done None if it never
    # came), wait_s (the engine's submit -> dispatch start), iters, ok
    requests: List[dict] = dataclasses.field(default_factory=list)
    # the engine's dispatches of those requests, in order: requests,
    # iters, wall_s, t_end (epoch s), members (their requests' iters)
    dispatches: List[dict] = dataclasses.field(default_factory=list)
    # learner: steps completed in the window, and the learner's trace
    steps: int = 0
    learn_trace: Optional[dict] = None
    # sizes the rooflines need (K, F, slots, codes, ...)
    shapes: dict = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None
    peaks: dict = dataclasses.field(default_factory=lambda: dict(PEAKS))

    def completed(self) -> List[dict]:
        return [r for r in self.requests if r["ok"]]
