"""The host's preparation of the database's fills a query: the
``batch.pad`` (encode and pad the rows) and ``fill.check`` (the code-range
checks) spans under ``search.bucket``, over the queries (program spans)."""

from harness import program_spans


def read(run):
    sp = program_spans.load(run, "search")
    if sp is None:
        return None
    ns = sp.total_ns("batch.pad", "search.bucket") + sp.total_ns("fill.check", "search.bucket")
    return ns / 1e6 / len(sp.roots)
