"""The 95th percentile of the wall of every task in the window, each from
its call to its return (host clock, linear interpolation between ranks)."""

import numpy as np


def read(run):
    walls = [r["wall"] for r in run.done()]
    if not walls:
        return None
    return float(np.percentile(walls, 95)) * 1e3
