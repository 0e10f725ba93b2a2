"""What one run of a cell gathered, as the metric readers see it."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    setup_s: float = 0.0
    window_s: float = 0.0
    memory_peak_bytes: int = 0
    requests: list = dataclasses.field(default_factory=list)  # one dict a request
    counters: dict = dataclasses.field(default_factory=dict)  # the program's, over the window
    trace_summary: Any = None  # harness.trace.Trace of the traced run
    work: dict = dataclasses.field(default_factory=dict)  # bounds (s) by layer, from the check
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    check_s: float = 0.0
    metrics: dict = dataclasses.field(default_factory=dict)

    def done(self) -> list[dict]:
        """The requests that returned an answer."""
        return [r for r in self.requests if "error" not in r]

    def correct(self) -> bool:
        return (bool(self.checks) and all(v <= lim for _, v, lim in self.checks)
                and not any("error" in r for r in self.requests))
