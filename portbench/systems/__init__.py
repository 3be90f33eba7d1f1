"""Systems under test: one module per entry into the program, named by a
configuration's ``system`` key. Each has ``run(ctx) -> Outcome``: it
builds the program's object from the configuration, warms the cell's
shapes, drives the window with the traffic's driver, and checks what
the window produced against the plain reference."""
from __future__ import annotations

import dataclasses
from typing import List

from ..record import RunRecord


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    record: RunRecord
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    complete: bool  # every answer the checks needed was there
