"""The band walk's share of its roofline: the least time the traced
window's end scores need by their shapes (``harness/roofline_pair.py``,
every cell once, scores only) over the device time of ``band_walk_kernel``.
None where the program records no ``pair`` spans (device trace)."""

from harness import program_spans
from harness.metric_util import kernel_share


def read(run):
    if program_spans.load(run, "pair") is None:
        return None
    return kernel_share(run, "band_s", lambda name: "band_walk_kernel" in name)
