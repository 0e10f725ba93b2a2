"""The 4,999 shuffles on the host a p-value: the ``pvalue.shuffle``
spans, over the p-values (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "pvalue")
    if sp is None:
        return None
    return sp.total_ns("pvalue.shuffle") / 1e6 / len(sp.roots)
