"""The port's spans (``aligner_tpu_torch.observability.span``) on its three
entries, ``search_database``, ``heuristic_align_population`` and
``calculate_p_value``, on the CPU: nothing is recorded without a profiler;
under ``torch.profiler`` each call is one request with the documented
tree, its counts are the host's own numbers (bytes handed to the fill,
iterations, the fit's rounds and end), each span lies on the profiler's
clock, and the results are the same with tracing on and off."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import aligner_tpu_torch as port
from aligner_tpu_torch import heuristic, observability, search, statistics
from aligner_tpu_torch.ops import dp_fill
from aligner_tpu_torch.search import search_database

torch.set_num_threads(1)

# each span's parent, by name, on these entries (None: a root)
TREE = {
    "search": None, "search.prepare": "search", "search.encode": "search.prepare",
    "search.buckets": "search.prepare", "search.verify": "search", "search.bucket": "search", "search.rank": "search", "search.alignments": "search",
    "batch": ("search.bucket", "search.alignments", "population.final", "pvalue.fill",
              "search"),
    "batch.pad": "batch", "batch.read": "batch", "batch.walk": "batch",
    "fill": "batch", "fill.check": "fill", "fill.upload": "fill", "fill.launch": "fill",
    "fill.sync": ("fill", "batch"),
    "population": None, "population.start": "population",
    "population.done_read": ("population", "population.iteration"),
    "population.iteration": "population", "population.fill": "population.iteration",
    "population.counting_walk": "population.iteration",
    "population.transform": "population.iteration", "population.final": "population",
    "pvalue": None, "pvalue.shuffle": "pvalue", "pvalue.fill": "pvalue", "pvalue.fit": "pvalue",
}


def _search():
    rng = np.random.default_rng(3)
    db = [rng.integers(0, 20, int(n)).astype(np.int8) for n in rng.integers(8, 60, 40)]
    q = rng.integers(0, 20, 30).astype(np.int8)
    db[5] = q.copy()
    hits = search_database(q, db, port.blosum62(), 11.0, 2.0, k=4, device="cpu")
    return [(h.index, h.score, h.coords, None if h.query_aligned is None
             else h.query_aligned.tolist(), None if h.target_aligned is None
             else h.target_aligned.tolist()) for h in hits]


def _population():
    rng = np.random.default_rng(5)
    q = rng.integers(0, 24, 40).astype(np.int8)
    t = q.copy()
    t[rng.integers(1, 40, 6)] = rng.integers(0, 24, 6)
    freqs = rng.random(24)
    h = port.Heuristics(kd=0.0, r_squared=1e5, frequencies=freqs / freqs.sum())
    mats = rng.integers(-1, 2, (5, 24, 24)).astype(np.float64) + 4 * np.eye(24)
    out = port.heuristic_align_population(q, t, mats, 11.0, 11.0, h, device="cpu")
    return [None if r is None else (r.alignment.f, r.alignment.coords,
                                    r.alignment.query.tolist(), r.alignment.target.tolist(),
                                    r.matrix.tolist()) for r in out]


def _pvalue():
    rng = np.random.default_rng(7)
    q = rng.integers(0, 20, 40).astype(np.int8)
    t = q.copy()
    t[rng.integers(0, 40, 8)] = rng.integers(0, 20, 8)
    p = statistics.calculate_p_value(q, t, 120.0, 11.0, 11.0, port.blosum62(),
                                     rng=np.random.default_rng(11), device="cpu",
                                     n_sequences=40)
    return np.float64(p).tobytes()


ENTRIES = {"search": _search, "population": _population, "pvalue": _pvalue}


def _traced(fn):
    """``fn()`` under a CPU profiler: its result, the span log, and the
    profiler's events."""
    observability.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    log = observability.spans()
    observability.clear_spans()
    return out, log, list(prof.profiler.kineto_results.events())


@pytest.fixture(autouse=True)
def _empty_log():
    observability.clear_spans()
    yield
    observability.clear_spans()


@pytest.fixture(autouse=True)
def _no_resident_database(monkeypatch):
    """Each test's first search prepares its database."""
    monkeypatch.setattr(search, "_resident", search._Resident())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_profiler_records_nothing_and_opens_no_range(entry, monkeypatch):
    opened = []
    monkeypatch.setattr(observability, "_range", lambda name: opened.append(name))
    ENTRIES[entry]()
    assert opened == []
    assert observability.spans() == [] and observability.dropped_spans() == 0


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_one_request_one_root_and_the_tree(entry):
    _, log, _ = _traced(ENTRIES[entry])
    roots = [s for s in log if s.parent is None]
    assert [r.name for r in roots] == [entry]
    root = roots[0]
    by_id = {s.id: s for s in log}
    assert len(by_id) == len(log)
    for s in log:
        assert s.root == root.id, s
        assert s.start_ns <= s.end_ns
        want = TREE[s.name]
        if want is None:
            continue
        parent = by_id[s.parent]
        assert parent.name in (want if isinstance(want, tuple) else (want,)), (s.name, parent.name)
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    names = Counter(s.name for s in log)
    expect = {
        "search": {"search", "search.prepare", "search.encode", "search.buckets",
                   "search.bucket", "search.rank",
                   "search.alignments", "batch", "batch.pad", "batch.read", "batch.walk",
                   "fill", "fill.check", "fill.upload", "fill.launch", "fill.sync"},
        "population": {"population", "population.start", "population.done_read",
                       "population.iteration", "population.fill", "population.counting_walk",
                       "population.transform", "population.final", "batch", "batch.pad",
                       "batch.read", "batch.walk", "fill", "fill.check", "fill.upload",
                       "fill.launch", "fill.sync"},
        "pvalue": {"pvalue", "pvalue.shuffle", "pvalue.fill", "pvalue.fit", "batch",
                   "batch.pad", "batch.read", "fill", "fill.check", "fill.upload",
                   "fill.launch", "fill.sync"},
    }[entry]
    assert set(names) == expect
    assert names["fill"] == names["fill.upload"] == names["fill.launch"]
    # the plain fill launches no kernel, so none of the lone design
    assert all(s.counts["lone"] == 0 for s in log if s.name == "fill")
    # a batch under the search itself is the score pass's one wait and read
    joins = [s for s in log if s.name == "batch" and by_id[s.parent].name == "search"]
    syncs = [s for s in log if s.name == "fill.sync"]
    if entry != "search":
        assert joins == [] and names["batch"] == names["fill"]
        assert all(by_id[s.parent].name == "fill" for s in syncs)
        return
    buckets = [s for s in log if s.name == "search.buckets"][0].counts["buckets"]
    assert names["search.bucket"] == buckets >= 2
    assert root.counts == {"records": 40, "query_len": 30, "resident": 0,
                           "in_flight": buckets, "streams": 0}
    rows = sum(s.counts["rows"] for s in log if s.name == "search.bucket")
    assert rows == 40
    # each bucket's batch and fill, the join, and the top hits' batch and fill
    (join,) = joins
    assert join.counts == {"batches": buckets}
    assert names["batch"] == names["fill"] + 1 == buckets + 2
    # one wait for the score pass (under the join), one for the top hits' fill
    assert [by_id[s.parent].name for s in sorted(syncs, key=lambda s: s.start_ns)] == [
        "batch", "fill"]
    assert Counter(s.name for s in log if s.parent == join.id) == {"fill.sync": 1,
                                                                   "batch.read": 1}
    # every bucket is launched before the wait
    assert all(s.end_ns <= join.start_ns for s in log if s.name == "search.bucket")


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_upload_bytes_are_the_arrays_handed_to_the_fill(entry, monkeypatch):
    """Each fill's upload counts the arrays it hands the fill that no
    earlier fill was handed: the search's score pass sends the matrix and
    the query's row once, with its first bucket."""
    handed = []
    seen = []  # the storages handed so far, kept alive so none is reused
    orig = dp_fill.fill

    def first(x):
        ptr = x.untyped_storage().data_ptr()
        if any(ptr == s.data_ptr() for s in seen):
            return 0
        seen.append(x.untyped_storage())
        # a query every problem reads (stride 0) was sent as its one row
        return x[0].nbytes if x.stride(0) == 0 else x.nbytes

    def counting(q, qlen, t, tlen, matrix, *a, **kw):
        qb = first(q)
        handed.append((qb + sum(first(x) for x in (qlen, t, tlen, matrix)), qb))
        return orig(q, qlen, t, tlen, matrix, *a, **kw)

    monkeypatch.setattr(dp_fill, "fill", counting)
    if entry == "population":
        # the loop's fills take the state already on the device (its uploads
        # are population.start's); the final alignments' fill is handed its
        # arrays
        monkeypatch.setattr(heuristic, "_population_loop",
                            _uncounted(heuristic._population_loop, handed))
    _, log, _ = _traced(ENTRIES[entry])
    uploads = [(s.counts["h2d_bytes"], s.counts["query_bytes"])
               for s in sorted(log, key=lambda s: s.start_ns) if s.name == "fill.upload"]
    assert uploads and uploads == handed


@pytest.mark.parametrize("shards", [1, 3])
def test_a_bucket_sends_its_query_once_a_device(shards, monkeypatch):
    """Under ``search.bucket`` the query is one padded row a device, sent
    once a score pass: ``query_bytes`` counts it once, with the first
    bucket enqueued (the tallest), as the matrix; ``batch`` counts the rows
    it served; no bucket waits (the pass's one ``fill.sync`` is under the
    join's ``batch``), and the spans the benchmark reads keep their
    names."""
    monkeypatch.setattr(port.align, "_shard_devices", lambda device: [device] * shards)
    monkeypatch.delenv("ALIGNER_AUTO_SHARD", raising=False)
    _, log, _ = _traced(_search)
    by_id = {s.id: s for s in log}

    def under(s, name):
        while s.parent is not None:
            s = by_id[s.parent]
            if s.name == name:
                return s
        return None

    buckets = sorted((s for s in log if s.name == "search.bucket"), key=lambda s: s.start_ns)
    assert len(buckets) >= 2
    widths = [b.counts["width"] for b in buckets]
    assert widths == sorted(widths, reverse=True)  # the tallest first
    for k, b in enumerate(buckets):
        (batch,) = [s for s in log if s.name == "batch" and s.parent == b.id]
        assert batch.counts["shared_query_rows"] == batch.counts["rows"] == b.counts["rows"]
        inside = Counter(s.name for s in log if under(s, "search.bucket") is b)
        assert inside["batch.pad"] == inside["fill.check"] == 1 and inside["fill.sync"] == 0
        uploads = [s for s in log if s.name == "fill.upload" and under(s, "search.bucket") is b]
        assert len(uploads) == shards
        # query_len 30: one row of 32 int32 codes, sent with the first
        # bucket's first shard (the shards share the one device), as the
        # float64 matrix is
        sent_once = 32 * 4 if k == 0 else 0
        assert [u.counts["query_bytes"] for u in uploads] == [sent_once] + [0] * (shards - 1)
        rows = -(-b.counts["rows"] // shards) * shards
        width = -(-b.counts["width"] // 8) * 8
        assert sum(u.counts["h2d_bytes"] for u in uploads) == (
            rows * (4 + 4 * width + 4) + (32 * 4 + 24 * 24 * 8 if k == 0 else 0))
    (join,) = [s for s in log if s.name == "batch" and by_id[s.parent].name == "search"]
    # the pass's one wait, and the top hits' fill's own
    (score_sync,) = [s for s in log if s.name == "fill.sync" and s.parent == join.id]
    (other,) = [s for s in log if s.name == "fill.sync" and s is not score_sync]
    assert under(other, "search.alignments") is not None


def test_distinct_queries_are_sent_row_by_row():
    rng = np.random.default_rng(8)
    queries = [rng.integers(0, 20, 30).astype(np.int8) for _ in range(2)] * 5
    targets = [rng.integers(0, 20, 20).astype(np.int8) for _ in range(10)]

    def run():
        return port.batch_align(queries, targets, port.blosum62(), 11.0, 2.0, device="cpu")

    _, log, _ = _traced(run)
    (batch,) = [s for s in log if s.name == "batch"]
    assert batch.counts["rows"] == 10 and batch.counts["shared_query_rows"] == 0
    (upload,) = [s for s in log if s.name == "fill.upload"]
    assert upload.counts["query_bytes"] == 10 * 32 * 4


def _uncounted(loop, handed):
    """``loop`` with what its fills were handed taken out of ``handed``."""
    def f(*a, **kw):
        n = len(handed)
        out = loop(*a, **kw)
        del handed[n:]
        return out
    return f


def test_population_iterations_are_its_fills(monkeypatch):
    calls = {"fill": 0}
    orig = dp_fill.fill

    def counting(*a, **kw):
        calls["fill"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(dp_fill, "fill", counting)
    _, log, _ = _traced(_population)
    root = [s for s in log if s.parent is None][0]
    # one fill an iteration, and one more for the final alignments
    assert root.counts["iterations"] == calls["fill"] - 1 >= 2
    assert root.counts["members"] == 5
    assert sum(s.name == "population.iteration" for s in log) == root.counts["iterations"]
    # the first read of the done flags precedes the loop; then one an iteration
    # but the last, which spends max_iters or finds every member done
    assert sum(s.name == "population.done_read" for s in log) == root.counts["iterations"] + 1


def _fit_counts(qlen, tl, scores):
    observability.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        p = statistics.calculate_distribution_params(qlen, tl, scores)
    (fit,) = [s for s in observability.spans() if s.name == "pvalue.fit"]
    assert fit.parent is None and fit.root == fit.id  # a root when called alone
    return p, fit.counts


def test_fit_counts_a_converging_fit():
    # tests/test_torch_statistics_pinned.py::test_fixture_converged_fit
    rng = np.random.default_rng(2026)
    n, qlen = 200, 400
    tl = 400 - rng.integers(0, 7, n)
    scores = np.round(rng.gumbel(loc=42, scale=9, size=n), 0)
    p, counts = _fit_counts(qlen, tl, scores)
    assert float(p.k).hex() == "0x1.59756076b55ebp-11"
    assert counts == {"rounds": 1, "converged": 1, "repeat": 0, "maxiter": 0}


def test_fit_counts_a_repeating_fit(monkeypatch):
    # tests/test_torch_statistics_pinned.py::test_stationary_shortcut_equals_exhausted_loop
    monkeypatch.setattr(statistics, "MAXITER", 400)
    rng = np.random.default_rng(70)
    tl = 400 - rng.integers(0, 7, 400)
    scores = np.round(rng.gumbel(loc=110.5, scale=3.7, size=400), 0)
    rounds = {"n": 0}
    orig = statistics._estimate_k_and_lambda

    def counting(*a):
        rounds["n"] += 1
        return orig(*a)

    monkeypatch.setattr(statistics, "_estimate_k_and_lambda", counting)
    _, counts = _fit_counts(400, tl, scores)
    assert counts == {"rounds": rounds["n"], "converged": 0, "repeat": 1, "maxiter": 0}
    assert 2 <= rounds["n"] < 50


def test_fit_counts_a_fit_that_spends_maxiter(monkeypatch):
    # tests/test_torch_statistics_pinned.py::test_fixture_truncated_restart_return
    monkeypatch.setattr(statistics, "MAXITER", 2)
    rng = np.random.default_rng(1)
    n = int(rng.integers(20, 120))
    qlen = int(rng.integers(30, 300))
    tl = rng.integers(30, 300, n)
    scores = np.round(rng.gumbel(loc=rng.uniform(5, 50), scale=rng.uniform(1, 12), size=n), 0)
    p, counts = _fit_counts(qlen, tl, scores)
    assert float(p.h).hex() == "0x1.a8abc7fb6b724p-2"
    assert counts == {"rounds": 3, "converged": 0, "repeat": 0, "maxiter": 1}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_lie_on_the_profilers_clock(entry):
    _, log, events = _traced(ENTRIES[entry])
    names = {s.name for s in log}
    ranges = {}
    for e in events:
        if e.name() in names:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in log if s.name == name)
        theirs = sorted(ranges.get(name, []))
        assert len(mine) == len(theirs), name
        for (a0, a1), (b0, b1) in zip(mine, theirs):
            assert abs(a0 - b0) < 1_000_000 and abs(a1 - b1) < 1_000_000, name


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_results_are_the_same_traced_and_not(entry):
    plain = ENTRIES[entry]()
    traced, log, _ = _traced(ENTRIES[entry])
    assert log and traced == plain


def test_the_log_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(observability, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with observability.span("x", i=i) as sp:
                sp.count(i=1, extra=2)
    assert [s.counts for s in observability.spans()] == [
        {"i": 1, "extra": 2}, {"i": 2, "extra": 2}, {"i": 3, "extra": 2}]
    assert observability.dropped_spans() == 2
    observability.clear_spans()
    assert observability.spans() == [] and observability.dropped_spans() == 0


def test_a_span_closes_when_its_block_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with observability.span("outer"):
                with observability.span("inner", n=1):
                    raise ValueError("refused")
        with observability.span("next"):
            pass
    inner, outer, nxt = observability.spans()
    assert (inner.name, outer.name, nxt.name) == ("inner", "outer", "next")
    assert inner.parent == outer.id and inner.root == outer.id and inner.counts == {"n": 1}
    assert outer.parent is None and nxt.parent is None and nxt.root == nxt.id


# ---------------------------------------------------------------------------
# the pair: align_global and global_end_score on a wavefront route
# ---------------------------------------------------------------------------

PAIR_TREE = {"pair": None, "pair.forward": "pair", "pair.gather": "pair.forward",
             "pair.replay": "pair", "pair.walk": "pair.replay", "pair.decode": "pair"}
DNA = np.where(np.eye(4, dtype=bool), 1.0, -3.0)
PAIR_LEN = 600  # three column blocks of 256 on the pipeline
ENGINE = {name: i for i, name in enumerate(observability.PAIR_ENGINES)}
# route -> (backend, aligned, the spans, the root's blocks and engine); the
# pipeline's alignment runs one row block of 640 rows (its forward block,
# whole replay tiles of 64), its end score one of 608 (the padded target)
PAIR_ROUTES = {
    "pipeline-align": ("wavefront_sp", 1, {"pair", "pair.forward", "pair.gather", "pair.replay",
                                           "pair.walk", "pair.decode"}, (1, 3, "pallas")),
    "pipeline-score": ("wavefront_sp", 0, {"pair", "pair.forward"}, (1, 3, "pallas")),
    "plane-align": (None, 1, {"pair", "pair.forward", "pair.decode"}, (1, 1, "row_scan")),
    "chunked-align": ("chunked", 1, {"pair", "pair.forward", "pair.replay", "pair.walk",
                                     "pair.decode"}, (1, 1, "row_scan")),
    "plane-score": (None, 0, {"pair", "pair.forward"}, (1, 1, "diag")),
}


def _pair_inputs():
    """A query and a homolog of it: 15 % substituted, 9 bases deleted and 9
    appended."""
    rng = np.random.default_rng(13)
    q = rng.integers(0, 4, PAIR_LEN).astype(np.int8)
    t = q.copy()
    sub = rng.random(PAIR_LEN) < 0.15
    t[sub] = rng.integers(0, 4, int(sub.sum()))
    t = np.delete(t, rng.choice(PAIR_LEN, 9, replace=False))
    return q, np.concatenate([t, rng.integers(0, 4, 9).astype(np.int8)])


@pytest.fixture
def pair_call(request, monkeypatch):
    """The route's call, its blocks cut small: the pipeline's column block to
    256 columns and its replay tile to 64 rows, the chunked route's tile to
    128 rows (its direct plane budget 0)."""
    from aligner_tpu_torch.ops import wavefront as wf
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    backend, aligned, _, _ = PAIR_ROUTES[request.param]
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")
    monkeypatch.setattr(sp, "CB_COLS", 256)
    monkeypatch.setitem(sp.sharded_global_align.__kwdefaults__, "tb_rows", 64)
    if backend == "chunked":
        backend = None
        monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 0)
        monkeypatch.setitem(wf.align_single_global_chunked.__kwdefaults__, "tb_rows", 128)
    q, t = _pair_inputs()

    def call():
        if aligned:
            a = port.align_global(q, t, DNA, 5.0, 2.0, alphabet=port.DNA, backend=backend,
                                  device="cpu").alignment
            return a.query.tolist(), a.target.tolist(), a.coords
        return port.global_end_score(q, t, DNA, 5.0, 2.0, alphabet=port.DNA, backend=backend,
                                     device="cpu")
    return call


@pytest.mark.parametrize("pair_call", sorted(PAIR_ROUTES), indirect=True)
def test_a_pair_records_nothing_without_a_profiler(pair_call, monkeypatch):
    opened = []
    monkeypatch.setattr(observability, "_range", lambda name: opened.append(name))
    pair_call()
    assert opened == []
    assert observability.spans() == [] and observability.dropped_spans() == 0


@pytest.mark.parametrize("pair_call", sorted(PAIR_ROUTES), indirect=True)
def test_a_pair_is_one_root_with_its_tree_and_counts(pair_call, request):
    from aligner_tpu_torch.ops import wavefront as wf

    route = request.node.callspec.params["pair_call"]
    _, aligned, names, (row_blocks, col_blocks, engine) = PAIR_ROUTES[route]
    out, log, _ = _traced(pair_call)
    assert out == pair_call()
    roots = [s for s in log if s.parent is None]
    assert [r.name for r in roots] == ["pair"]
    root, by_id = roots[0], {s.id: s for s in log}
    for s in log:
        assert s.root == root.id and s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.name == PAIR_TREE[s.name], (s.name, parent.name)
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert {s.name for s in log} == names
    q, t = _pair_inputs()
    assert root.counts == {"cells": len(q) * len(t), "aligned": aligned,
                           "row_blocks": row_blocks, "col_blocks": col_blocks,
                           "engine": ENGINE[engine]}
    forward = [s for s in log if s.name == "pair.forward"]
    assert len(forward) == 1
    launches = {"pipeline": row_blocks * col_blocks, "row_scan": 1 + (route == "plane-align"),
                "diag": row_blocks}
    assert forward[0].counts == {"launches": launches[engine if engine != "pallas"
                                                      else "pipeline"]}
    if "pair.replay" in names:
        (replay,) = [s for s in log if s.name == "pair.replay"]
        walks = [s for s in log if s.name == "pair.walk"]
        tile = (64 * 256) if route.startswith("pipeline") else 128 * len(q)
        assert replay.counts == {"tiles": len(walks), "cells": len(walks) * tile}
        assert len(walks) >= 2
        _, steps = wf.alignment_steps(np.array(out[0]), np.array(out[1]))
        assert sum(w.counts["steps"] for w in walks) == steps


@pytest.mark.parametrize("pair_call", ["pipeline-align", "plane-score"], indirect=True)
def test_a_pairs_spans_lie_on_the_profilers_clock(pair_call):
    _, log, events = _traced(pair_call)
    for name in {s.name for s in log}:
        mine = sorted((s.start_ns, s.end_ns) for s in log if s.name == name)
        theirs = sorted((e.start_ns(), e.end_ns()) for e in events if e.name() == name)
        assert len(mine) == len(theirs), name
        for (a0, a1), (b0, b1) in zip(mine, theirs):
            assert abs(a0 - b0) < 1_000_000 and abs(a1 - b1) < 1_000_000, name


# the repeat search's spans: each one's parent, by name (the survivors'
# full pass is a batched fill, its ``fill`` tree under ``repeat.survivors``)
REPEAT_TREE = {
    "repeat": None, "repeat.start": "repeat", "repeat.cycle": "repeat",
    "repeat.scan": ("repeat.start", "repeat.cycle"), "repeat.survivors": "repeat.cycle",
    "repeat.filter": "repeat.cycle", "repeat.matrix": "repeat.cycle",
    "fill": "repeat.survivors", "fill.check": "fill", "fill.upload": "fill",
    "fill.launch": "fill", "fill.sync": "fill",
}
REPEAT_W, REPEAT_OFFSET, REPEAT_BASES = 30, 3, 6000


def _repeat_chromosome():
    """Uniform bases with four copies of one 33-base query, every 4th base
    of copy k redrawn from phase k."""
    rng = np.random.default_rng(17)
    seq = rng.integers(0, 4, REPEAT_BASES)
    query = rng.integers(0, 4, REPEAT_W + REPEAT_OFFSET)
    for k in range(4):
        copy = query.copy()
        copy[k::4] = rng.integers(0, 4, len(copy[k::4]))
        pos = (k + 1) * (REPEAT_BASES // 5)
        seq[pos:pos + len(copy)] = copy
    return np.frombuffer(b"ATCG", np.uint8)[seq].tobytes()


def _repeat():
    from aligner_tpu_torch.repeat import engine

    opts = engine.SearchOptions(repeat_length=REPEAT_W, query_offset=REPEAT_OFFSET,
                                deletions=30.0, extension=7.0, device="cpu")
    out = engine.perform_calculation_per_sequence(opts, _repeat_chromosome(), "chromosome",
                                                  np.random.default_rng(23))
    (res,) = out.values()
    return res


def test_a_repeat_search_is_one_root_with_its_tree_and_counts():
    from aligner_tpu_torch.repeat import engine

    res, log, _ = _traced(_repeat)
    plain = _repeat()
    assert [(t.left_coord, t.right_coord, t.z, t.f) for t in res.tasks] == \
        [(t.left_coord, t.right_coord, t.z, t.f) for t in plain.tasks]
    assert res.scans == plain.scans and np.array_equal(res.matrix, plain.matrix)
    roots = [s for s in log if s.parent is None]
    assert [r.name for r in roots] == ["repeat"]
    root, by_id = roots[0], {s.id: s for s in log}
    for s in log:
        assert s.root == root.id and s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = by_id[s.parent]
            want = REPEAT_TREE[s.name]
            assert parent.name in (want if isinstance(want, tuple) else (want,)), s.name
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    named = Counter(s.name for s in log)
    cycles = [s for s in log if s.name == "repeat.cycle"]
    scans = [s for s in log if s.name == "repeat.scan"]
    survivors = [s for s in log if s.name == "repeat.survivors"]
    filters = [s for s in log if s.name == "repeat.filter"]
    windows = len(engine.windows_of(REPEAT_BASES, engine.SearchOptions(
        repeat_length=REPEAT_W, query_offset=REPEAT_OFFSET), REPEAT_OFFSET))
    # the starting scan and one a cycle; the last cycle kept no window
    assert named["repeat.start"] == 1 and res.scans == len(scans) == 1 + len(cycles) >= 3
    assert len(survivors) == len(cycles) and len(filters) == len(cycles) - 1
    assert named["repeat.matrix"] == len(cycles) - 1
    assert cycles[-1].counts == {"windows": windows, "survivors": 0}
    cells = sum(min(REPEAT_W + REPEAT_OFFSET, REPEAT_BASES - j)
                for j in range(0, REPEAT_BASES, REPEAT_OFFSET)) * REPEAT_W
    for s in scans:
        assert s.counts == {"windows": windows, "cells": cells, "chunks": 1}
    # the survivors' full pass aligns the tasks the filter keeps
    for cyc, surv in zip(cycles, survivors):
        assert by_id[surv.parent] is cyc and cyc.counts["windows"] == windows
        assert surv.counts["windows"] == cyc.counts.get("kept", 0)
        assert surv.counts["cells"] <= surv.counts["windows"] * (REPEAT_W + REPEAT_OFFSET) * REPEAT_W
    for cyc, f in zip(cycles, filters):
        assert by_id[f.parent] is cyc and f.end_ns <= by_id[survivors[cycles.index(cyc)].id].start_ns
        assert f.counts == {"tasks_in": cyc.counts["survivors"], "tasks_out": cyc.counts["kept"]}
        assert cyc.counts["kept"] < cyc.counts["survivors"]
    assert cycles[-2].counts["kept"] == len(res.tasks) > 0
    assert root.counts == {"scans": res.scans, "windows": windows * res.scans,
                           "survivors": sum(c.counts["survivors"] for c in cycles)}


def _bench_readers():
    """The benchmark's readers of the repeat search's per-layer metrics and
    its run record, loaded with the benchmark's folder on the path."""
    import importlib
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    sys.path.insert(0, bench)
    try:
        manifest = importlib.import_module("harness.manifest")
        record = importlib.import_module("harness.record")
        trace = importlib.import_module("harness.trace")
        names = [m["name"] for m in manifest.load()["per_layer"]
                 if m["name"].endswith(".repeat")]
        return {n: manifest.reader(n) for n in names}, record.Run, trace.Trace
    finally:
        sys.path.remove(bench)


def test_the_repeat_readers_give_no_number_without_the_programs_spans(monkeypatch):
    """A program that records none of the repeat search's spans, as the one
    before them: each reader gives None, and raises nothing."""
    import time

    from aligner_tpu_torch.repeat import engine

    readers, Run, Trace = _bench_readers()
    assert sorted(readers) == ["device_idle_pct.repeat", "host_ms_per_request.repeat",
                               "scan_roofline.repeat", "survivor_ms_per_request.repeat",
                               "survivor_roofline.repeat"]
    monkeypatch.setattr(engine, "span", lambda *a, **kw: observability._OFF)
    t0 = time.perf_counter()
    _, log, _ = _traced(_repeat)
    t1 = time.perf_counter()
    assert log and "repeat" not in {s.name for s in log}
    monkeypatch.setattr(observability, "spans", lambda: log)
    run = Run(cell={}, config={"options": {"repeat_length": REPEAT_W,
                                           "query_offset": REPEAT_OFFSET},
                               "chromosome": {"bases": REPEAT_BASES}},
              traffic={}, seed=1, seconds=1.0, trace=True, device=torch.device("cpu"),
              requests=[{"i": 0, "t0": t0, "t1": t1, "cells": 1}])
    run.trace_summary = Trace(window_s=t1 - t0, busy_s=0.0, kernels={}, idle={})
    run.work["scan_s"] = 1.0
    for name, reader in readers.items():
        assert reader.read(run) is None, name
