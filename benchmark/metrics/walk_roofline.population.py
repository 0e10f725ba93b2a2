"""The counting walk's share of its roofline: the least time the traced
tasks' walks need by the steps the reference's loop walks
(``harness/roofline.py``) over the device time of the counting walk's
launches (``device_walk_kernel<false, VEC, true>``) in the traced window."""

from harness.metric_util import COUNTING_WALK, kernel_share


def read(run):
    return kernel_share(run, "walk_s", COUNTING_WALK)
