"""The scans' share of their roofline: the least time of every traced
scan's windows by their shapes (``harness/roofline_repeat.py``, every cell
once, scores only, float64) over the device time of the scores-only PWM
launches of ``dp_fill_kernel``.  A scan's launches run one after another
on one stream, so their summed time is the union of their intervals.
None where the program records no ``repeat`` spans (device trace)."""

from harness import program_spans, roofline_repeat
from harness.metric_util import kernel_share


def read(run):
    if program_spans.load(run, "repeat") is None:
        return None
    return kernel_share(run, "scan_s", roofline_repeat.SCAN_KERNEL)
