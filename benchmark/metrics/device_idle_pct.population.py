"""The share of the traced window in which no kernel or copy ran on the
card (device trace)."""


def read(run):
    tr = run.trace_summary
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
