"""The population's start a task: the ``population.start`` spans (the
starting matrices' transforms on the host and the uploads), over the
tasks (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "population")
    if sp is None:
        return None
    return sp.total_ns("population.start") / 1e6 / len(sp.roots)
