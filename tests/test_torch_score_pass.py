"""The search's score pass (``align.ScorePass``): every bucket's scores-only
fill enqueued, tallest first, before one wait and one read.  Held here, on
the CPU, bit for bit against the bucket-by-bucket path it replaces (one
``batch_align`` of ``[q] * n`` a bucket, read as it returns), on seeded
databases of several buckets with one-record buckets and zero-length
records, in local and global mode, on one shard and on three shards of one
device; ``search_database`` against the same search built on that path
(scores, ranking, alignments); the ``search`` span's ``in_flight`` and
``streams`` counts; and a refused code in a later bucket.

The database kept between searches: two queries against one database
answer what two fresh processes answer, the second reading ``resident`` 1
and sending only its query row and the matrix; every edit of the records
(a code changed in place, a record replaced, appended or swapped, text
for codes) and another bucket growth or alphabet is a miss with the fresh
answer, also where the mismatch is found after the pass was enqueued; and
a matrix too small for the kept codes refuses them only when they are the
call's."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import aligner_tpu_torch as port
from aligner_tpu_torch import align, observability, search
from aligner_tpu_torch.errors import ValidationError
from aligner_tpu_torch.search import length_buckets, search_database

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_resident_database(monkeypatch):
    """Each test starts as a fresh process does: no database kept."""
    monkeypatch.setattr(search, "_resident", search._Resident())


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
            fills.enqueue(align.TargetBucket([db[i] for i in buckets[k]]))
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


def _fresh(*args, **kw):
    """``search_database`` as a fresh process answers it: with no database
    kept (the one kept is put back after)."""
    kept = search._resident
    search._resident = search._Resident()
    try:
        return _hits(search_database(*args, **kw))
    finally:
        search._resident = kept


def _traced(*args, **kw):
    """``search_database`` under a profiler: its hits, its root span's
    counts, and its spans."""
    observability.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        hits = search_database(*args, **kw)
    log = observability.spans()
    observability.clear_spans()
    (root,) = [s for s in log if s.parent is None]
    return _hits(hits), root.counts, log


def _small(seed):
    """A query and a database of at least two buckets, small enough for
    the plain fill."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 24, 14).astype(np.int8)
    lens = np.concatenate([rng.integers(1, 12, 30), rng.integers(40, 50, 10), [0, 90]])
    db = [rng.integers(0, 24, int(n)).astype(np.int8) for n in lens]
    db[3] = q.copy()
    return q, db


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("mode", ["local", "global"])
def test_two_queries_against_one_database_answer_as_two_fresh_processes(mode, shards,
                                                                         monkeypatch):
    q, db = _small(6)
    q2 = db[-1][20:31].copy()
    _shards(monkeypatch, shards)
    m = port.blosum62()
    want = [_fresh(x, db, m, 11.0, 2.0, k=6, mode=mode, device="cpu") for x in (q, q2)]
    first, counts1, _ = _traced(q, db, m, 11.0, 2.0, k=6, mode=mode, device="cpu")
    second, counts2, log = _traced(q2, db, m, 11.0, 2.0, k=6, mode=mode, device="cpu")
    assert [first, second] == want
    assert (counts1["resident"], counts2["resident"]) == (0, 1)
    assert not {"search.prepare", "search.encode", "search.buckets"} & {s.name for s in log}
    # the second pass sends its query row (16 int32 codes) and the float64
    # matrix, once, and nothing of the database
    by_id = {s.id: s for s in log}
    uploads = [s for s in log if s.name == "fill.upload"
               and by_id[by_id[by_id[s.parent].parent].parent].name == "search.bucket"]
    assert len(uploads) >= 2 * shards
    assert sum(u.counts["query_bytes"] for u in uploads) == 16 * 4
    assert sum(u.counts["h2d_bytes"] for u in uploads) == 16 * 4 + 24 * 24 * 8


def _in_place(db):
    db[5][0] = (db[5][0] + 1) % 24
    return db


def _replaced(db):
    db[35] = np.random.default_rng(9).integers(0, 24, len(db[35])).astype(np.int8)
    return db


def _swapped(db):
    db[1], db[33] = db[33], db[1]
    return db


EDITS = {
    "a code changed in place": (_in_place, {}),
    "a record replaced": (_replaced, {}),
    "a record appended": (lambda db: db + [db[0][::-1].copy()], {}),
    "two records swapped": (_swapped, {}),
    "text for codes": (lambda db: [port.Protein.decode(s) for s in db], {}),
    "another bucket growth": (lambda db: db, {"bucket_growth": 2.0}),
    "another alphabet": (lambda db: db, {"alphabet": port.DNA}),
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_an_edit_of_the_database_is_a_miss_with_the_fresh_answer(edit):
    q, db = _small(7)
    change, kw = EDITS[edit]
    m = port.blosum62()
    _, counts, _ = _traced(q, db, m, 11.0, 2.0, k=5, device="cpu")
    assert counts["resident"] == 0
    edited = change(db)
    want = _fresh(q, edited, m, 11.0, 2.0, k=5, device="cpu", **kw)
    got, counts, _ = _traced(q, edited, m, 11.0, 2.0, k=5, device="cpu", **kw)
    assert counts["resident"] == 0 and got == want
    got, counts, _ = _traced(q, edited, m, 11.0, 2.0, k=5, device="cpu", **kw)
    assert counts["resident"] == 1 and got == want


@pytest.mark.parametrize("edited", [False, True], ids=["same", "one-code-changed"])
def test_records_of_another_dtype_are_compared_by_their_codes(edited):
    """The kept database's records as int64 arrays and lists: the same
    codes are found, one code changed is a miss with the fresh answer."""
    q, db = _small(12)
    m = port.blosum62()
    search_database(q, db, m, 11.0, 2.0, k=5, device="cpu")
    other = [s.astype(np.int64) for s in db[:20]] + [s.tolist() for s in db[20:]]
    if edited:
        other[25][1] = (other[25][1] + 1) % 24
    want = _fresh(q, other, m, 11.0, 2.0, k=5, device="cpu")
    got, counts, _ = _traced(q, other, m, 11.0, 2.0, k=5, device="cpu")
    assert got == want and counts["resident"] == int(not edited)


def test_a_mismatch_found_under_the_pass_answers_afresh():
    """The records keep their count and lengths, so the pass over the kept
    buckets is enqueued before the codes are compared: its scores are
    dropped, and the database prepared and searched again."""
    q, db = _small(8)
    m = port.blosum62()
    search_database(q, db, m, 11.0, 2.0, k=5, device="cpu")
    db[3][4] = (db[3][4] + 5) % 24  # the query's own copy: the best hit changes
    want = _fresh(q, db, m, 11.0, 2.0, k=5, device="cpu")
    got, counts, log = _traced(q, db, m, 11.0, 2.0, k=5, device="cpu")
    assert got == want and counts["resident"] == 0
    names = [s.name for s in log]
    buckets = len(length_buckets([len(s) for s in db]))
    assert names.count("search.bucket") == 2 * buckets
    assert names.count("search.verify") == names.count("search.prepare") == 1
    (verify,) = [s for s in log if s.name == "search.verify"]
    (prepare,) = [s for s in log if s.name == "search.prepare"]
    assert verify.end_ns <= prepare.start_ns
    # the dropped pass is not read
    assert names.count("batch.read") == 2  # the second pass's and the top hits'


def test_a_matrix_too_small_for_the_kept_codes_raises_and_the_database_stays():
    q, db = _small(10)
    m = port.blosum62()
    want = _fresh(q, db, m, 11.0, 2.0, k=4, device="cpu")
    search_database(q, db, m, 11.0, 2.0, k=4, device="cpu")
    dna = np.where(np.eye(4, dtype=bool), 1.0, -3.0)
    with pytest.raises(ValidationError, match="target codes"):
        search_database(q % 4, db, dna, 5.0, 2.0, k=4, device="cpu")
    got, counts, _ = _traced(q, db, m, 11.0, 2.0, k=4, device="cpu")
    assert counts["resident"] == 1 and got == want


def test_a_refusal_of_the_kept_codes_is_not_the_calls():
    """Records of the same count and lengths as the kept ones, all within
    a 4-symbol matrix, where the kept codes are not: the pass over the kept
    buckets refuses them, the call's records are found to differ, and the
    call is answered from its own."""
    q, db = _small(11)
    search_database(q, db, port.blosum62(), 11.0, 2.0, k=4, device="cpu")
    dna = np.where(np.eye(4, dtype=bool), 1.0, -3.0)
    small = [s % 4 for s in db]
    want = _fresh(q % 4, small, dna, 5.0, 2.0, k=4, device="cpu")
    got, counts, _ = _traced(q % 4, small, dna, 5.0, 2.0, k=4, device="cpu")
    assert got == want and counts["resident"] == 0
