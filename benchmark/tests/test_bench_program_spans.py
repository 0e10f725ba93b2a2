"""The readers of the program's spans (``harness/program_spans.py`` and the
``program_span`` metrics): on a synthetic span log beside a synthetic run,
with the spans of an earlier run in the same process left out; with no
spans (a program that records none) they give no number; and a traced run
of each small cell on the CPU reports every one of its span metrics."""

import pytest
import torch

import run as R
from aligner_tpu_torch.observability import SpanRecord
from harness import manifest, program_spans
from harness.record import Run

MS = 1_000_000


def _records(tree, t0_s, ids):
    """SpanRecords of ``tree`` (name, start ms, end ms, counts, children),
    its times in ms after a request's ``t0_s`` on the harness's clock, in
    the order spans close (a child before its parent)."""
    base = int(t0_s * 1e9) + program_spans.offset_ns()
    out = []

    def walk(node, parent, root):
        name, a, b, counts, kids = node
        sid = next(ids)
        root = sid if root is None else root
        for k in kids:
            walk(k, sid, root)
        out.append(SpanRecord(name, base + a * MS, base + b * MS, sid, parent, root, counts))

    walk(tree, None, None)
    return out


def _fill(a, check, upload, h2d, qb):
    """A ``fill`` span from ``a`` ms: its check and upload (ms), then a
    launch and the wait."""
    c1 = a + 1 + check
    u1 = c1 + 1 + upload
    return ("fill", a, u1 + 10, {"cells": 1, "shards": 1}, [
        ("fill.check", a + 1, c1, {}, []),
        ("fill.upload", c1 + 1, u1, {"h2d_bytes": h2d, "query_bytes": qb}, []),
        ("fill.launch", u1 + 1, u1 + 2, {}, []),
        ("fill.sync", u1 + 2, u1 + 9, {}, []),
    ])


def _batch(a, b, pad, check, upload, h2d, qb):
    return ("batch", a, b, {"rows": 8, "with_alignments": 0}, [
        ("batch.pad", a + 1, a + 1 + pad, {}, []),
        _fill(a + 2 + pad, check, upload, h2d, qb),
        ("batch.read", b - 2, b - 1, {}, []),
    ])


SEARCH = ("search", 1, 401, {"records": 100, "query_len": 30}, [
    ("search.encode", 2, 12, {}, []),
    ("search.buckets", 13, 15, {"buckets": 2}, []),
    ("search.bucket", 20, 120, {"rows": 60, "width": 40},
     [_batch(21, 119, 10, 2, 10, 1_000_000, 900_000)]),
    ("search.bucket", 130, 330, {"rows": 40, "width": 52},
     [_batch(131, 329, 20, 4, 20, 2_000_000, 1_800_000)]),
    ("search.rank", 340, 350, {}, []),
    ("search.alignments", 355, 395, {}, [_batch(360, 390, 2, 1, 2, 500_000, 50_000)]),
])
# per query: 400 less the batches' 98 + 198 + 30 (74); pads 10 + 2 and 20 + 4
# (the top hits' batch is no bucket's); uploads 10 + 20 + 2; 3.5 MB
SEARCH_WANT = {"search_host_ms_per_query.search": 74.0, "pad_ms_per_query.search": 36.0,
               "upload_ms_per_query.search": 32.0, "h2d_mb_per_query.search": 3.5}


def _iteration(k, read):
    a = 30 + 50 * k
    kids = [("population.fill", a + 1, a + 20, {}, []),
            ("population.counting_walk", a + 20, a + 25, {}, []),
            ("population.transform", a + 25, a + 30, {}, [])]
    if read:
        kids.append(("population.done_read", a + 30, a + 40, {}, []))
    return ("population.iteration", a, a + 40, {}, kids)


POPULATION = ("population", 1, 221, {"members": 64, "iterations": 3}, [
    ("population.start", 2, 22, {}, []),
    ("population.done_read", 23, 25, {}, []),
    _iteration(0, True), _iteration(1, True), _iteration(2, False),
    ("population.final", 190, 220, {}, [_batch(191, 219, 2, 1, 2, 10, 5)]),
])
# iterations 3; start 20 ms; waits 10 + 10 of 3 x 40 ms (the read before
# the loop belongs to no iteration)
POPULATION_WANT = {"iterations_per_task.population": 3.0, "start_ms_per_task.population": 20.0,
                   "iteration_wait_pct.population": 100.0 * 20 / 120}

PVALUE = ("pvalue", 1, 301, {}, [
    ("pvalue.shuffle", 2, 12, {"shuffles": 4999}, []),
    ("pvalue.fill", 13, 40, {}, [_batch(14, 39, 2, 1, 2, 10, 5)]),
    ("pvalue.fit", 41, 300, {"rounds": 7, "converged": 1, "repeat": 0, "maxiter": 0}, []),
])
PVALUE_WANT = {"fit_ms_per_pvalue.pvalue": 259.0, "fit_rounds_per_pvalue.pvalue": 7.0,
               "shuffle_ms_per_pvalue.pvalue": 10.0}

# an earlier run in the same process: other numbers, which must not count
STALE = {
    "search": ("search", 1, 9001, {}, [
        ("search.bucket", 2, 9000, {}, [_batch(3, 8999, 5000, 9, 3000, 9e9, 9e9)])]),
    "population": ("population", 1, 900, {"iterations": 50}, [
        ("population.start", 2, 800, {}, []),
        ("population.iteration", 801, 899, {}, [
            ("population.done_read", 802, 898, {}, [])])]),
    "pvalue": ("pvalue", 1, 9001, {}, [
        ("pvalue.shuffle", 2, 3000, {}, []),
        ("pvalue.fit", 3001, 9000, {"rounds": 10001, "maxiter": 1}, [])]),
}

CASES = {"search": (SEARCH, SEARCH_WANT), "population": (POPULATION, POPULATION_WANT),
         "pvalue": (PVALUE, PVALUE_WANT)}


def _run(requests):
    return Run(cell={}, config={}, traffic={}, seed=1, seconds=1.0, trace=True,
               device=torch.device("cpu"), requests=requests)


@pytest.mark.parametrize("root", sorted(CASES))
def test_readers_on_a_synthetic_log(root, monkeypatch):
    tree, want = CASES[root]
    ids = iter(range(1, 10_000))
    log = _records(STALE[root], 50.0, ids)  # the earlier run's request, 50.0-60.0 s
    requests = []
    for i, t0 in enumerate((100.0, 101.0)):
        log += _records(tree, t0, ids)
        requests.append({"i": i, "t0": t0, "t1": t0 + 0.5})
    requests.append({"i": 2, "t0": 102.0, "t1": 102.5, "error": "refused"})
    log += _records(tree, 102.0, ids)  # a request that failed: not a done one
    monkeypatch.setattr(program_spans, "_log", lambda: log)
    run = _run(requests)
    for name, value in want.items():
        assert manifest.reader(name).read(run) == pytest.approx(value, rel=1e-9), name
    # the earlier run's own requests read its spans alone
    stale = _run([{"i": 0, "t0": 50.0, "t1": 60.0}])
    for name, value in want.items():
        got = manifest.reader(name).read(stale)
        assert got is not None and got != pytest.approx(value), name


@pytest.mark.parametrize("root", sorted(CASES))
def test_readers_give_no_number_without_spans(root, monkeypatch):
    run = _run([{"i": 0, "t0": 100.0, "t1": 100.5}])
    for log in (None, []):
        monkeypatch.setattr(program_spans, "_log", lambda: log)
        for name in CASES[root][1]:
            assert manifest.reader(name).read(run) is None, name
    # spans that lie in no request of this run
    ids = iter(range(1, 10_000))
    log = _records(CASES[root][0], 300.0, ids)
    monkeypatch.setattr(program_spans, "_log", lambda: log)
    for name in CASES[root][1]:
        assert manifest.reader(name).read(run) is None, name


@pytest.mark.parametrize("cell", ["search.long-queries", "service.population",
                                  "service.pvalue"])
def test_a_small_traced_run_reports_every_span_metric(cell, small):
    bench = manifest.load()
    mine = [m["name"] for m in bench["per_layer"]
            if m["source"] == "program_span" and cell in m["workloads"]]
    assert mine
    run = R.run_cell(cell, 2**31 + 12345, 0.6, True, torch.device("cpu"), **small(cell))
    assert run.correct(), run.checks
    for name in mine:
        value = run.metrics.get(name, {}).get("value")
        assert isinstance(value, float) and value >= 0, (name, run.metrics)
