"""The fit's outer rounds a p-value: the ``pvalue.fit`` spans' ``rounds``,
over the p-values (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "pvalue")
    if sp is None:
        return None
    return sp.count("pvalue.fit", "rounds") / len(sp.roots)
