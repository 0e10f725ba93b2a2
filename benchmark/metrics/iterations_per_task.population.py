"""The population loop's iterations a task: the ``population`` spans'
``iterations``, over the tasks (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "population")
    if sp is None:
        return None
    return sp.count("population", "iterations") / len(sp.roots)
