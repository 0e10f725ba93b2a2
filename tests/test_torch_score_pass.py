"""The search's score pass (``align.ScorePass``): every bucket's scores-only
fill enqueued, tallest first, before one wait and one read.  Held here, on
the CPU, bit for bit against the bucket-by-bucket path it replaces (one
``batch_align`` of ``[q] * n`` a bucket, read as it returns), on seeded
databases of several buckets with one-record buckets and zero-length
records, in local and global mode, on one shard and on three shards of one
device; ``search_database`` against the same search built on that path
(scores, ranking, alignments); the ``search`` span's ``in_flight`` and
``streams`` counts; and a refused code in a later bucket."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import aligner_tpu_torch as port
from aligner_tpu_torch import align, observability
from aligner_tpu_torch.errors import ValidationError
from aligner_tpu_torch.search import length_buckets, search_database

torch.set_num_threads(1)


def _database(seed, qlen=45, longest=420):
    """A query and a database whose buckets include one-record buckets (a
    record far longer than the rest stands alone) and zero-length records,
    with the query itself and a piece of it among the records."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 24, qlen).astype(np.int8)
    lens = np.concatenate([rng.integers(1, 30, 70), rng.integers(60, 90, 25),
                           [0, 0, 0, longest // 3, longest]])
    rng.shuffle(lens)
    db = [rng.integers(0, 24, int(n)).astype(np.int8) for n in lens]
    db[7] = q.copy()
    db[11] = q[5:30].copy()
    return q, db


def _shards(monkeypatch, shards):
    monkeypatch.setattr(align, "_shard_devices", lambda device: [device] * shards)
    monkeypatch.delenv("ALIGNER_AUTO_SHARD", raising=False)


def _buckets(db):
    buckets = length_buckets([len(s) for s in db])
    sizes = [len(b) for b in buckets]
    assert len(buckets) >= 3 and 1 in sizes
    assert any(len(db[i]) == 0 for b in buckets for i in b)
    return buckets


def _same_scores(a, b):
    for f in ("fmax", "fy", "fx", "end"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_pass_equals_the_buckets_one_by_one(seed, mode, shards, monkeypatch):
    q, db = _database(seed)
    _shards(monkeypatch, shards)
    m = port.blosum62()
    buckets = _buckets(db)
    want = [port.batch_align([q] * len(b), [db[i] for i in b], m, 11.0, 2.0, mode=mode,
                             device="cpu") for b in buckets]
    order = list(range(len(buckets)))[::-1]  # the tallest first, as the search
    with align.ScorePass(q, m, 11.0, 2.0, mode=mode, device="cpu") as fills:
        for k in order:
            fills.enqueue([db[i] for i in buckets[k]])
        got = fills.read()
    assert fills.in_flight == len(buckets) and fills.streams == set()
    assert len(got) == len(buckets)
    for k, res in zip(order, got):
        _same_scores(res, want[k])


def _serial_search(q, db, m, mode, k):
    """The search bucket by bucket, each bucket one ``batch_align`` read
    before the next: the scores, then the top hits' alignments."""
    lengths = np.array([len(s) for s in db])
    scores = np.full(len(db), -np.inf)
    for b in length_buckets(lengths):
        res = port.batch_align([q] * len(b), [db[i] for i in b], m, 11.0, 2.0, mode=mode,
                               device="cpu")
        scores[b] = res.fmax if mode == "local" else res.end
    scores[lengths == 0] = -np.inf
    top = np.argsort(-scores, kind="stable")[:k]
    ok = [int(i) for i in top if lengths[i] > 0 and (mode != "local" or scores[i] > 0)]
    aln = port.batch_align([q] * len(ok), [db[i] for i in ok], m, 11.0, 2.0, mode=mode,
                           device="cpu", with_alignments=True)
    by = dict(zip(ok, aln))
    out = []
    for i in top:
        r = by.get(int(i))
        out.append((int(i), np.float64(scores[i]).tobytes(),
                    None if r is None else r.alignment.coords,
                    None if r is None else r.alignment.query.tolist(),
                    None if r is None else r.alignment.target.tolist()))
    return out


def _hits(hits):
    return [(h.index, np.float64(h.score).tobytes(), h.coords,
             None if h.query_aligned is None else h.query_aligned.tolist(),
             None if h.target_aligned is None else h.target_aligned.tolist())
            for h in hits]


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("mode", ["local", "global"])
def test_search_equals_the_bucket_by_bucket_search(mode, shards, monkeypatch):
    q, db = _database(3)
    _buckets(db)
    _shards(monkeypatch, shards)
    m = port.blosum62()
    want = _serial_search(q, db, m, mode, k=12)
    got = _hits(search_database(q, db, m, 11.0, 2.0, k=12, mode=mode, device="cpu"))
    assert got == want
    assert got[0][0] == 7  # the query's own copy ranks first


@pytest.mark.parametrize("shards", [1, 3])
def test_the_search_span_counts_every_bucket_in_flight(shards, monkeypatch):
    q, db = _database(4, qlen=12, longest=200)  # small: the profiler records every op
    buckets = _buckets(db)
    _shards(monkeypatch, shards)
    observability.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        search_database(q, db, port.blosum62(), 11.0, 2.0, k=3, device="cpu")
    log = observability.spans()
    observability.clear_spans()
    (root,) = [s for s in log if s.parent is None]
    assert root.counts["in_flight"] == len(buckets)
    assert root.counts["streams"] == 0  # the CPU's fills run in turn, on no stream
    assert sum(s.name == "search.bucket" for s in log) == len(buckets)


def test_a_refused_code_in_a_later_bucket_raises_and_the_next_search_runs():
    q, db = _database(5)
    bad = [s.copy() for s in db]
    short = min((i for i, s in enumerate(bad) if len(s) > 0), key=lambda i: len(bad[i]))
    bad[short][0] = 30  # outside BLOSUM62's 24 symbols, in the shortest bucket: the last
    with pytest.raises(ValidationError, match="target codes"):
        search_database(q, bad, port.blosum62(), 11.0, 2.0, k=3, device="cpu")
    hits = search_database(q, db, port.blosum62(), 11.0, 2.0, k=3, device="cpu")
    assert _hits(hits) == _serial_search(q, db, port.blosum62(), "local", k=3)
