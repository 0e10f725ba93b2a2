"""The traced window's task time over its iterations, an iteration
counted as one launch of the counting walk (one an iteration)."""

from harness.metric_util import COUNTING_WALK


def read(run):
    tr = run.trace_summary
    if tr is None:
        return None
    iters = tr.count(COUNTING_WALK)
    walls = [r["wall"] for r in run.done()]
    if not iters or not walls:
        return None
    return 1e3 * sum(walls) / iters
