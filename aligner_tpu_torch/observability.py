"""Tracing, profiling and throughput counters.

* :class:`Counters` — process-wide cells/launches/seconds per engine,
  giving live GCUPS without external tooling;
* :func:`measure` — records one launch; on CUDA it synchronises the
  device before it stops the clock, so the time covers the kernel and not
  only its enqueue;
* :func:`profile_trace` — context manager around ``torch.profiler``
  (writes a Chrome/Perfetto trace file);
* :func:`configure_logging` — ``ALIGNER_LOG``-controlled logging of the
  package's logger;
* ``log`` — the package's logger (``aligner_tpu_torch``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import defaultdict

import torch

log = logging.getLogger("aligner_tpu_torch")

_LEVELS = {"DEBUG", "INFO", "WARNING", "WARN", "ERROR", "CRITICAL", "FATAL"}


def configure_logging(level: str | None = None) -> None:
    """Set the level of the package's logger from ``level`` or the
    ``ALIGNER_LOG`` environment variable (default ``warning``; a value that
    names no level falls back to it), and give the process a handler if it
    has none.

    Divergence from ``aligner_tpu.observability.configure_logging``: that
    one sets the level of the **root** logger, so an embedding application
    that called it had every library's records let through.  Here only the
    ``aligner_tpu_torch`` logger's level changes; the root logger keeps its
    own."""
    lvl = (level or os.environ.get("ALIGNER_LOG", "warning")).upper()
    if lvl not in _LEVELS:
        lvl = "WARNING"
    # a handler for a process that has none (a no-op otherwise); without a
    # level argument it leaves the root logger's level alone
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s %(message)s")
    log.setLevel(getattr(logging, lvl))


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
    """Record a launch in the global counters.  With a CUDA ``device`` (or
    a list of devices: the shards of a fill) each card is synchronised
    before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for d in dict.fromkeys(device if isinstance(device, (list, tuple)) else [device]):
            if d is not None and torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)
        counters.record(engine, cells, problems, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(path: str):
    """``torch.profiler`` trace of the block, CPU and (when present) CUDA
    activity, exported as a Chrome trace (view at ui.perfetto.dev)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    # chooses only what the profiler records, never where work runs: a
    # missing card has already raised in backend.resolve_device
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
