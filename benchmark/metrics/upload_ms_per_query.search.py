"""The host's time handing the fills' arrays to the card a query: the
``fill.upload`` spans, over the queries (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "search")
    if sp is None:
        return None
    return sp.total_ns("fill.upload") / 1e6 / len(sp.roots)
