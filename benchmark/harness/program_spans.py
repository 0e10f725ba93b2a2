"""The program's own spans (``aligner_tpu_torch.observability.spans()``),
read in the process after a traced window.

The program records a span only while a ``torch.profiler`` session
records, so the log holds the traced window's spans (and those of any
earlier traced run in the same process).  A root span is one request of
the program (``search``, ``population``, ``pvalue``); only the roots that
lie inside a done request's ``[t0, t1]`` are kept, with their
descendants.  The requests' times are on ``time.perf_counter()``, the
spans' on ``time.time_ns()``: the offset between the two clocks is taken
once in the process, so the requests of two runs in one process map to
their own times and never take each other's spans.

Where the program has no spans (a checkout before them), :func:`load`
gives None and the readers give no number.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

# the two clocks' offset is read in two calls a microsecond apart; a root
# span opens after its request's t0 and closes before its t1 by more
SLACK_NS = 200_000

_offset_ns: int | None = None


def offset_ns() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, taken once."""
    global _offset_ns
    if _offset_ns is None:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
    return _offset_ns


def _log():
    try:
        from aligner_tpu_torch.observability import spans
    except ImportError:
        return None
    return spans()


@dataclasses.dataclass
class Spans:
    roots: list  # the kept roots of the name asked for, one a request
    spans: list  # the kept roots and all their descendants
    by_id: dict
    children: dict  # span id -> its children

    def named(self, name: str, under: str | None = None) -> list:
        """The kept spans called ``name`` (with an ancestor called
        ``under``, where given)."""
        out = [s for s in self.spans if s.name == name]
        return out if under is None else [s for s in out if self.has_ancestor(s, under)]

    def has_ancestor(self, s, name: str) -> bool:
        while s.parent is not None:
            s = self.by_id.get(s.parent)
            if s is None:
                return False
            if s.name == name:
                return True
        return False

    def total_ns(self, name: str, under: str | None = None) -> int:
        return sum(s.end_ns - s.start_ns for s in self.named(name, under))

    def count(self, name: str, key: str) -> float:
        return sum(s.counts.get(key, 0) for s in self.named(name))

    def descendants(self, s) -> list:
        out, todo = [], list(self.children.get(s.id, ()))
        while todo:
            x = todo.pop()
            out.append(x)
            todo.extend(self.children.get(x.id, ()))
        return out

    def less_covered_ns(self, s, name: str) -> int:
        """``s``'s duration less the part of it that its descendants
        called ``name`` cover (a self time, where ``name`` is each child's)."""
        covered = _union([(max(d.start_ns, s.start_ns), min(d.end_ns, s.end_ns))
                          for d in self.descendants(s) if d.name == name])
        return (s.end_ns - s.start_ns) - covered


def _union(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def load(run, root: str) -> Spans | None:
    """The spans of ``run``'s done requests under roots called ``root``;
    None where the program records no spans or none of them lies in the
    run's requests."""
    log = _log()
    if not log:
        return None
    off = offset_ns()
    windows = [(int(r["t0"] * 1e9) + off - SLACK_NS, int(r["t1"] * 1e9) + off + SLACK_NS)
               for r in run.done() if "t0" in r and "t1" in r]
    roots = [s for s in log if s.parent is None and s.name == root
             and any(a <= s.start_ns and s.end_ns <= b for a, b in windows)]
    if not roots:
        return None
    keep = {s.id for s in roots}
    kept = [s for s in log if s.root in keep]
    children = defaultdict(list)
    for s in kept:
        if s.parent is not None:
            children[s.parent].append(s)
    return Spans(roots, kept, {s.id: s for s in kept}, dict(children))
