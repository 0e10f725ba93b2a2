"""The host's own time a repeat search: each ``repeat`` span's duration
less the part that its ``repeat.scan`` and ``repeat.survivors`` descendants
cover (the record's encode, the statistics, the overlap filter,
the frequency sums and the transform, the calls between them), over the
requests (program spans)."""

from harness import program_spans

COVERED = ("repeat.scan", "repeat.survivors")


def read(run):
    sp = program_spans.load(run, "repeat")
    if sp is None:
        return None
    ns = 0
    for r in sp.roots:
        kids = [(max(d.start_ns, r.start_ns), min(d.end_ns, r.end_ns))
                for d in sp.descendants(r) if d.name in COVERED]
        ns += (r.end_ns - r.start_ns) - program_spans._union(kids)
    return ns / 1e6 / len(sp.roots)
