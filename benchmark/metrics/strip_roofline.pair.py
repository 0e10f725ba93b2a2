"""The strip walk's share of its roofline: the least time the traced
window's alignments need by their shapes (``harness/roofline_pair.py``,
every cell once with its direction) over the device time of
``fill_strips_kernel`` (the pipeline's forward blocks and replay tiles).
None where the program records no ``pair`` spans (device trace)."""

from harness import program_spans
from harness.metric_util import kernel_share


def read(run):
    if program_spans.load(run, "pair") is None:
        return None
    return kernel_share(run, "strip_s", lambda name: "fill_strips_kernel" in name)
