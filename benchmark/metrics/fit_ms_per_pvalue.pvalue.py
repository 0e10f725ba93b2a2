"""The fit of (k, lambda, h) on the host a p-value: the ``pvalue.fit``
spans, over the p-values (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "pvalue")
    if sp is None:
        return None
    return sp.total_ns("pvalue.fit") / 1e6 / len(sp.roots)
