"""One-vs-many database search and observability counters of the port
(``aligner_tpu_torch/search.py``, ``observability.py``), on the inputs of
the reference's ``tests/test_search_observability.py``: the same six tests
with ``device="cpu"`` in place of ``backend="xla"`` (the kernels' plain
versions), each also held against the JAX package's answer on the same
inputs, and the scores against ``aligner_tpu/oracle.py``'s fill."""

import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.search import search_database as ref_search
from aligner_tpu_torch.observability import counters
from aligner_tpu_torch.search import length_buckets, search_database

torch.set_num_threads(1)


def same_hits(got, want):
    assert [(h.index, h.score) for h in got] == [(h.index, h.score) for h in want]
    for a, b in zip(got, want):
        for f in ("query_aligned", "target_aligned"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(np.asarray(x), np.asarray(y))


def test_length_buckets():
    lengths = [10] * 100 + [13] * 100 + [100] * 10 + [1000]
    buckets = length_buckets(lengths, growth=1.3, min_size=64)
    covered = np.concatenate(buckets)
    assert sorted(covered) == list(range(len(lengths)))
    for b in buckets:
        ls = [lengths[i] for i in b]
        assert max(ls) >= min(ls)
    from aligner_tpu.search import length_buckets as ref_buckets

    want = ref_buckets(lengths, growth=1.3, min_size=64)
    assert [list(b) for b in buckets] == [list(b) for b in want]


def test_search_database_topk(rng):
    M = port.blosum62()
    query = rng.integers(0, 24, 50).astype(np.int8)
    # database: random decoys + two planted near-copies of the query
    db = [rng.integers(0, 24, int(rng.integers(20, 80))).astype(np.int8)
          for _ in range(40)]
    planted1 = query.copy()
    planted2 = query.copy()
    planted2[::7] = (planted2[::7] + 1) % 24
    db[13] = planted1
    db[29] = planted2
    hits = search_database(query, db, M, 11.0, 2.0, k=5, device="cpu")
    assert len(hits) == 5
    assert hits[0].index == 13  # exact copy wins
    assert {13, 29}.issubset({h.index for h in hits[:3]})
    assert hits[0].score >= hits[1].score >= hits[2].score
    assert hits[0].query_aligned is not None
    # exact-copy alignment has no gaps
    assert not (np.asarray(hits[0].query_aligned) == 98).any()
    same_hits(hits, ref_search(query, db, ref.blosum62(), 11.0, 2.0, k=5, backend="xla"))


def test_search_scores_match_singles(rng):
    M = port.blosum62()
    query = rng.integers(0, 24, 30).astype(np.int8)
    db = [rng.integers(0, 24, int(rng.integers(10, 60))).astype(np.int8)
          for _ in range(12)]
    hits = search_database(query, db, M, 11.0, 2.0, k=12, device="cpu",
                           with_alignments=False)
    for h in hits:
        single = ref.align_local(query, db[h.index], ref.blosum62(), 11.0, 2.0,
                                 backend="oracle")
        assert h.score == single.alignment.f
        assert h.score == port.align_local(query, db[h.index], M, 11.0, 2.0,
                                           device="cpu").alignment.f


def test_counters_record(rng, monkeypatch):
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")
    counters.reset()
    M = port.blosum62()
    qs = [rng.integers(0, 24, 16).astype(np.int8) for _ in range(4)]
    ts = [rng.integers(0, 24, 16).astype(np.int8) for _ in range(4)]
    port.batch_align(qs, ts, M, 11.0, 2.0, device="cpu")
    snap = counters.snapshot()
    assert "cpu/local" in snap
    s = snap["cpu/local"]
    assert s.launches == 1
    assert s.problems == 4
    assert s.cells == 4 * 16 * 16
    assert "GCUPS" in counters.report()


def test_search_global_empty_records_never_rank(rng):
    """A zero-length db record has NO alignment; its masked batch score
    (0) must not outrank real sequences' negative global gap scores."""
    M = port.blosum62()
    query = rng.integers(0, 24, 12).astype(np.int8)
    db = [rng.integers(0, 24, 12).astype(np.int8),
          np.zeros(0, np.int8),
          rng.integers(0, 24, 10).astype(np.int8)]
    hits = search_database(query, db, M, 11.0, 2.0, k=3, mode="global", device="cpu")
    assert [h.index for h in hits if h.score != -np.inf] != []
    assert all(h.index != 1 or h.score == -np.inf for h in hits)
    # the empty record sorts last
    assert hits[-1].index == 1 and hits[-1].score == -np.inf
    same_hits(hits, ref_search(query, db, ref.blosum62(), 11.0, 2.0, k=3, mode="global",
                               backend="xla"))


def test_search_names_length_mismatch_raises(rng):
    M = port.blosum62()
    query = rng.integers(0, 24, 12).astype(np.int8)
    db = [rng.integers(0, 24, 12).astype(np.int8) for _ in range(4)]
    with pytest.raises(port.ValidationError):
        search_database(query, db, M, 11.0, 2.0, k=2, names=["a", "b"], device="cpu")
