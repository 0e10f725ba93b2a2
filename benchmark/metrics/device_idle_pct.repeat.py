"""The share of the traced window in which no kernel or copy ran on the
card (device trace), where the program's ``repeat`` spans mark the window's
requests as repeat searches (None without them)."""

from harness import program_spans


def read(run):
    tr = run.trace_summary
    if tr is None or tr.window_s <= 0 or program_spans.load(run, "repeat") is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
