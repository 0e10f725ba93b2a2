"""The survivors' pass a repeat search: the ``repeat.survivors`` spans'
durations (the full-mode fill with directions, the walk, the decode and
the tasks built on the host), over the requests (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "repeat")
    if sp is None:
        return None
    return sp.total_ns("repeat.survivors") / 1e6 / len(sp.roots)
