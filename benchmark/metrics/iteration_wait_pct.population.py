"""The share of the population loop's iterations the host spends waiting
for the card: 100 x the ``population.done_read`` time inside
``population.iteration`` spans over those spans' time (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "population")
    if sp is None:
        return None
    total = sp.total_ns("population.iteration")
    if total <= 0:
        return None
    return 100.0 * sp.total_ns("population.done_read", "population.iteration") / total
