"""The search's own host time a query: each ``search`` span's duration
less the part its ``batch`` descendants cover (the records' encode, the
buckets, the ranking, the loop between launches), over the queries
(program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "search")
    if sp is None:
        return None
    ns = sum(sp.less_covered_ns(r, "batch") for r in sp.roots)
    return ns / 1e6 / len(sp.roots)
