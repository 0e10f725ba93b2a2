"""The replay walk's share of its roofline: the least time of the steps
that the traced alignments' ``pair.walk`` spans count
(``harness/roofline_pair.py``) over the device time of
``replay_walk_kernel`` (device trace)."""

from harness import program_spans, roofline_pair


def read(run):
    sp = program_spans.load(run, "pair")
    tr = run.trace_summary
    if sp is None or tr is None:
        return None
    steps = sp.count("pair.walk", "steps")
    dev = tr.device_s(lambda name: "replay_walk_kernel" in name)
    if steps <= 0 or dev <= 0:
        return None
    return 100.0 * roofline_pair.walk(int(steps)) / dev
