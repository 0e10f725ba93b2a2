"""Helpers the metric readers share."""

from __future__ import annotations

import re

_COUNTING = re.compile(r"device_walk_kernel<false, *\d+, *true>")


def COUNTING_WALK(name: str) -> bool:
    """The counting walk's kernel: K4's walker with the count
    (``device_walk_kernel<false, VEC, true>``)."""
    return bool(_COUNTING.search(name))


def kernel_share(run, work_key: str, match) -> float | None:
    """100 x the bound of the traced window's work over the device time
    of the kernels ``match`` picks; None where either is missing."""
    tr = run.trace_summary
    bound = run.work.get(work_key, 0.0)
    if tr is None or bound <= 0:
        return None
    dev = tr.device_s(match)
    return 100.0 * bound / dev if dev > 0 else None
