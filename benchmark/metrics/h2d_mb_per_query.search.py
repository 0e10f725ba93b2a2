"""Bytes handed to the card a query, in MB (1e6 bytes): the
``fill.upload`` spans' ``h2d_bytes`` (every host array a fill sends to its
device, the scoring matrix included), over the queries (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "search")
    if sp is None:
        return None
    return sp.count("fill.upload", "h2d_bytes") / 1e6 / len(sp.roots)
