"""Tracing, spans and throughput counters.

* :class:`Counters` — process-wide cells/launches/seconds per engine,
  giving live GCUPS without external tooling;
* :func:`measure` — records one launch; on CUDA it synchronises the
  device before it stops the clock, so the time covers the kernel and not
  only its enqueue;
* :func:`span` — a named, nested range of the program's host work with
  counts, recorded only while a ``torch.profiler`` session records (its
  log: :func:`spans`, :func:`dropped_spans`, :func:`clear_spans`);
* :func:`configure_logging` — ``ALIGNER_LOG``-controlled logging of the
  package's logger;
* ``log`` — the package's logger (``aligner_tpu_torch``).

The spans, nested as the program opens them (counts in brackets; a root
span is one request, and its id is the request id):

* ``search`` [records, query_len, resident, in_flight, streams]
  (``search.search_database``; ``resident``: 1 where the records were
  found on the cards, 0 where they were prepared; ``in_flight``: the
  buckets' fills enqueued before the score pass's one wait, ``streams``:
  the CUDA streams they went on, 0 on the CPU): one ``search.bucket``
  [rows, width] per length bucket, tallest first (its ``batch``, without
  ``batch.read`` and ``fill.sync``; on a database's first pass its
  ``batch.pad``, ``fill.check`` and ``fill.upload`` also pad, check and
  send the bucket's targets), ``search.verify`` (the call's records
  compared with the kept ones on the host, while the kept buckets' fills
  run), the score pass's one ``batch`` [batches] (its ``fill.sync``, the
  one wait, and ``batch.read``), ``search.rank``, ``search.alignments``
  (the top hits' ``batch``); where the records are not the kept ones,
  ``search.prepare`` (``search.encode``, ``search.buckets`` [buckets])
  before a pass over the prepared buckets (after a ``search.verify`` that
  found them different, a second run of ``search.bucket`` spans);
* ``batch`` [rows, with_alignments, shared_query_rows] (``align.batch_align``,
  and a batch of ``align.ScorePass``; ``shared_query_rows``: the rows that
  read one shared query row, 0 unless every problem has the same query
  object): ``batch.pad``, ``fill``, ``batch.read`` (the results' copies to
  the host), ``batch.walk``;
* ``fill`` [cells, shards, lone] (a batched fill; ``lone``: its launches
  that took the fill kernel's lone design, a block a problem, of
  ``ops.dp_fill.launches.lone``): ``fill.check``, one
  ``fill.upload`` [h2d_bytes, query_bytes] and one ``fill.launch`` per
  shard (a shared query row and the scoring state are counted where they
  are sent, once a device a call, once a device a score pass),
  ``fill.sync`` (the wait for the card);
* ``population`` [members, iterations] (``heuristic.heuristic_align_population``):
  ``population.start``, ``population.done_read`` (the read of the members'
  ``done`` flags, where the host waits for the card), one
  ``population.iteration`` per iteration (``population.fill``,
  ``population.counting_walk``, ``population.transform``,
  ``population.done_read``), ``population.final`` (its ``batch``);
* ``pvalue`` (``statistics.calculate_p_value``): ``pvalue.shuffle``
  [shuffles], ``pvalue.fill`` (its ``batch``), ``pvalue.fit`` [rounds,
  converged, repeat, maxiter] (``statistics.calculate_distribution_params``;
  a root of its own when called alone);
* ``pair`` [cells, aligned, row_blocks, col_blocks, engine] (one
  ``align.align_global`` or ``align.global_end_score`` call that takes the
  column-blocked pipeline or a single-plane wavefront route; ``aligned`` 1
  for an alignment, 0 for an end score; ``row_blocks`` and ``col_blocks``
  the forward fill's blocks, 1 and 1 on a single plane; ``engine`` the
  index of the fill in :data:`PAIR_ENGINES`): ``pair.forward`` [launches]
  (the forward fill's launches and the wait for them; on the pipeline its
  ``pair.gather``, the trace records gathered to the walking device),
  ``pair.replay`` [tiles, cells] (the replay tiles with directions, and the
  cells they refill) with one ``pair.walk`` [steps] per tile (the replay
  walk's launch and the read of its cursor), ``pair.decode`` (the step
  stream brought to the host and turned into strings and coordinates).
  The direct single-plane alignment fills with directions and walks in its
  ``pair.forward``;
* ``repeat`` [scans, windows, survivors] (one record of
  ``repeat.engine.perform_calculation_per_sequence``: the scans run, the
  windows they scanned, the windows at z >= 3): ``repeat.start`` (the
  PWM's draw, the shuffle and the starting scan), one ``repeat.cycle``
  [windows, survivors, kept] a cycle (``repeat.filter`` [tasks_in,
  tasks_out], the overlap filter of the survivors' tasks;
  ``repeat.survivors`` [windows, cells], the full pass over the tasks it
  keeps; ``repeat.matrix``, the next PWM); each scan, in either, is a
  ``repeat.scan`` [windows, cells, chunks].

An operator records them with ``torch.profiler``::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        search_database(...)
    prof.export_chrome_trace("trace.json")  # the spans beside the kernels
    observability.spans()  # the same spans with their ids and counts
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import logging
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

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


def synchronize(device, sync_span: str | None = None) -> None:
    """Wait for a CUDA ``device`` (or for each card of a list of devices:
    the shards of a fill), inside the span ``sync_span`` when one is
    named."""
    with span(sync_span) if sync_span else _OFF:
        for d in dict.fromkeys(device if isinstance(device, (list, tuple)) else [device]):
            if d is not None and torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)


@contextlib.contextmanager
def measure(engine: str, cells: int, problems: int, device=None, sync_span: str | None = None):
    """Record a launch in the global counters.  With a CUDA ``device`` (or
    a list of devices: the shards of a fill) each card is synchronised
    (:func:`synchronize`) before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        synchronize(device, sync_span)
        counters.record(engine, cells, problems, time.perf_counter() - t0)


class SpanRecord(NamedTuple):
    """One closed span: ``start_ns``/``end_ns`` on ``time.time_ns()``'s
    clock (the profiler's), its ``id``, its ``parent``'s (None for a root)
    and its ``root``'s (the request id), and its counts."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    root: int
    counts: dict


MAX_SPANS = 131_072

_log: list[SpanRecord] = []
_dropped = 0
_log_lock = threading.Lock()
_ids = itertools.count(1)
_open: contextvars.ContextVar = contextvars.ContextVar("aligner_tpu_torch_span", default=None)
_recording = torch._C._autograd._profiler_enabled
# a function-scope range: the profiler lists it among the CPU ops as it
# lists record_function's, but gives it no copy on the device's timeline
# (record_function's user scope gets a "gpu_user_annotation" there, which
# a reader of device time would count as work)
_range = torch._C._profiler._RecordFunctionFast


class _Off:
    """What :func:`span` gives while no profiler records: a context that
    does nothing and takes no counts."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "root", "start_ns", "_token", "_range")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def count(self, **counts) -> None:
        """Add to the span's counts (a new key starts at 0)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        up = _open.get()
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self._token = _open.set(self)
        self._range = _range(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _open.reset(self._token)
        rec = SpanRecord(self.name, self.start_ns, end_ns, self.id, self.parent, self.root,
                         self.counts)
        with _log_lock:
            if len(_log) < MAX_SPANS:
                _log.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, **counts):
    """A span of the program's host work named ``name``, with ``counts``
    (numbers the host already holds: lengths, bytes, loop counters; a span
    reads no device tensor and never synchronises).  Use as ``with
    span(...) as sp:``; ``sp.count(key=n)`` adds counts while it is open.

    Only while a ``torch.profiler`` session records does a span do
    anything (checking costs tens of nanoseconds; there is no other
    switch).  It then opens a profiler range of its name, so it lies on the
    profiler's clock beside the device's kernels and copies (and in
    ``export_chrome_trace``), and when it closes appends a
    :class:`SpanRecord` to the process's span log: its start and end from
    ``time.time_ns()`` (the profiler's clock), its id, its parent's (the
    span open around it in this thread or task, through a
    ``contextvars.ContextVar``), its root's (the request id) and its
    counts.  The log holds at most :data:`MAX_SPANS` (131,072) records;
    those past it are dropped and counted (:func:`dropped_spans`).  The
    profiler records the thread that started it (and the threads it hands
    its state to): in another thread a span does nothing."""
    if not _recording():
        return _OFF
    return _Span(name, counts)


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span of this thread or task
    (nothing while none is open, and so while no profiler records): the
    counts that a callee learns for its caller's span."""
    up = _open.get()
    if up is not None:
        up.count(**counts)


# the fills of a ``pair`` span's ``engine`` count, by index: the pipeline's
# three block engines (K7, K6, K7 with an int32 table), then the single
# plane's row scan (K5) and its band fill (K6)
PAIR_ENGINES = ("pallas", "band", "lax", "row_scan", "diag")


def spans() -> list[SpanRecord]:
    """The span log, in the order the spans closed (a child before its
    parent)."""
    with _log_lock:
        return list(_log)


def dropped_spans() -> int:
    """Spans closed while the log was full since it was last emptied."""
    return _dropped


def clear_spans() -> None:
    """Empty the span log and its count of dropped spans."""
    global _dropped
    with _log_lock:
        _log.clear()
        _dropped = 0
