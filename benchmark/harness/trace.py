"""The traced run: ``torch.profiler`` over the window, and the benchmark's
own host spans.

Spans are ``record_function`` ranges named ``bench:<name>``, opened by the
harness around each request and, in the traced run only, around the calls
into the program's layers that a driver names (:func:`wrap`).  They share
the profiler's clock with the device's kernels and copies, so an idle gap
on the device is named by the innermost span open over it.  The events are
read from the profiler's results in memory; nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
from collections import defaultdict

import torch

PREFIX = "bench:"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict  # device op name -> [seconds, count]
    idle: dict  # innermost open span -> idle seconds under it

    def device_s(self, match) -> float:
        return sum(v[0] for k, v in self.kernels.items() if match(k))

    def count(self, match) -> int:
        return sum(v[1] for k, v in self.kernels.items() if match(k))


def span(name: str):
    """A host span of the benchmark (a no-op outside a profiler)."""
    return torch.profiler.record_function(PREFIX + name)


def wrap(targets: list[tuple]):
    """Context in which each (module, attribute, span name) of ``targets``
    is called inside a span of that name (or of the name that the span
    name, a function of the call's arguments, gives); put back on exit."""
    @contextlib.contextmanager
    def ctx():
        saved = []
        try:
            for mod_name, attr, name in targets:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)

                @functools.wraps(fn)
                def inner(*a, _fn=fn, _name=name, **kw):
                    with span(_name(a, kw) if callable(_name) else _name):
                        return _fn(*a, **kw)

                saved.append((mod, attr, fn))
                setattr(mod, attr, inner)
            yield
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)
    return ctx()


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof):
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for e in res.events():
            yield (e.name(), e.device_type(), e.start_ns(), e.end_ns())
        return
    for e in prof.events():  # an older profiler: its parsed events
        yield (e.name, e.device_type, int(e.time_range.start * 1000),
               int(e.time_range.end * 1000))


def short(name: str) -> str:
    """A device op's name without its argument list (the last parenthesised
    group, where the name ends with one)."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[:160]


def _union(intervals):
    total, end = 0, None
    busy = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy.append([s, e])
            end = e
        elif e > end:
            busy[-1][1] = e
            end = e
    total = sum(e - s for s, e in busy)
    return total, busy


def read(prof, window: str = "window") -> Trace:
    """Device time by op, the device's busy time within the span
    ``window``, and its idle time named by the innermost span open."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev = [], []
    for name, dtype, s, e in _events(prof):
        if name.startswith(PREFIX):
            if dtype != cuda:
                spans.append((name[len(PREFIX):], s, e))
            continue  # the span's copy on the device's timeline is no work
        if dtype == cuda and e > s:
            dev.append((short(name), s, e))
    win = [sp for sp in spans if sp[0] == window]
    if not win:
        raise RuntimeError("the traced window's span is missing from the profile")
    w0, w1 = win[0][1], win[0][2]
    kernels = defaultdict(lambda: [0.0, 0])
    clipped = []
    for name, s, e in dev:
        if e <= w0 or s >= w1:
            continue
        kernels[name][0] += (e - s) / 1e9
        kernels[name][1] += 1
        clipped.append((max(s, w0), min(e, w1)))
    busy_ns, busy = _union(clipped)
    idle = defaultdict(float)
    inner = sorted((sp for sp in spans if sp[0] != window), key=lambda sp: sp[1])
    cursor = w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            mid = (cursor + s) / 2
            open_ = [sp for sp in inner if sp[1] <= mid <= sp[2]]
            name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "outside requests"
            idle[name] += (s - cursor) / 1e9
        cursor = max(cursor, e)
    return Trace((w1 - w0) / 1e9, busy_ns / 1e9, dict(kernels), dict(idle))


def breakdown(tr: Trace) -> dict:
    ops = sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(tr.idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
