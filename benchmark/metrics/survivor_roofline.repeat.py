"""The survivors' pass's share of its roofline: the least time of the
traced cycles' full pass (``harness/roofline_repeat.py``, every cell once
with its two bits of direction, float64) over the tasks the overlap filter
keeps, counted from the ``repeat.cycle`` spans' [kept] at the full
window's length (a clipped window at the record's end counted whole), over
the device time of the PWM launches of ``dp_fill_kernel`` with directions
(device trace)."""

from harness import program_spans, roofline_repeat


def read(run):
    sp = program_spans.load(run, "repeat")
    tr = run.trace_summary
    if sp is None or tr is None:
        return None
    n = int(sp.count("repeat.cycle", "kept"))
    dev = tr.device_s(roofline_repeat.SURVIVOR_KERNEL)
    if n <= 0 or dev <= 0:
        return None
    o = run.config["options"]
    width = int(o["repeat_length"])
    length = min(width + int(o["query_offset"]), int(run.config["chromosome"]["bases"]))
    return 100.0 * roofline_repeat.fill(n, n * length, width, dirs=True) / dev
