"""The batched fill's share of its roofline: the least time the window's
fills need by their unpadded problems (``harness/roofline.py``) over the
device time of the ``dp_fill_kernel`` launches in the traced window."""

from harness.metric_util import kernel_share


def read(run):
    return kernel_share(run, "fill_s", lambda name: "dp_fill_kernel" in name)
