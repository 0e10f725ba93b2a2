"""Tracing, profiling and throughput counters.

* :class:`Counters` — process-wide cells/launches/seconds per engine,
  giving live GCUPS without external tooling;
* :func:`measure` — records one launch; on CUDA it synchronises the
  device before it stops the clock, so the time covers the kernel and not
  only its enqueue;
* :func:`profile_trace` — context manager around ``torch.profiler``
  (writes a Chrome/Perfetto trace file);
* ``log`` — the package's logger (``aligner_tpu_torch``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from collections import defaultdict

import torch

log = logging.getLogger("aligner_tpu_torch")


@dataclasses.dataclass
class EngineStats:
    launches: int = 0
    cells: int = 0
    problems: int = 0
    seconds: float = 0.0

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds > 0 else 0.0


class Counters:
    """Process-wide per-engine throughput counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, EngineStats] = defaultdict(EngineStats)

    def record(self, engine: str, cells: int, problems: int, seconds: float):
        with self._lock:
            s = self._stats[engine]
            s.launches += 1
            s.cells += cells
            s.problems += problems
            s.seconds += seconds

    def snapshot(self) -> dict[str, EngineStats]:
        with self._lock:
            return {k: dataclasses.replace(v) for k, v in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.snapshot().items()):
            lines.append(
                f"{name}: {s.launches} launches, {s.problems} problems, "
                f"{s.cells / 1e9:.3f} Gcells in {s.seconds:.3f}s "
                f"({s.gcups:.2f} GCUPS)"
            )
        return "\n".join(lines) or "(no launches recorded)"


counters = Counters()


@contextlib.contextmanager
def measure(engine: str, cells: int, problems: int, device=None):
    """Record a launch in the global counters.  With a CUDA ``device`` the
    device is synchronised before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        counters.record(engine, cells, problems, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(path: str):
    """``torch.profiler`` trace of the block, CPU and (when present) CUDA
    activity, exported as a Chrome trace (view at ui.perfetto.dev)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
