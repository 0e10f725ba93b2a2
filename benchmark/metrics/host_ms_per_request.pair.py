"""The host's own time a pair: each ``pair`` span's duration less the part
that its ``pair.forward``, ``pair.replay`` and ``pair.walk`` descendants
cover (the operands' preparation, the engine pick, the decode of the step
stream, the calls between them), over the requests (program spans)."""

from harness import program_spans

COVERED = ("pair.forward", "pair.replay", "pair.walk")


def read(run):
    sp = program_spans.load(run, "pair")
    if sp is None:
        return None
    ns = 0
    for r in sp.roots:
        kids = [(max(d.start_ns, r.start_ns), min(d.end_ns, r.end_ns))
                for d in sp.descendants(r) if d.name in COVERED]
        ns += (r.end_ns - r.start_ns) - program_spans._union(kids)
    return ns / 1e6 / len(sp.roots)
