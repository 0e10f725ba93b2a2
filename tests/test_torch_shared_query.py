"""A batch whose problems all share one query object (``[q] * n``, as the
search, the p-value and the population's final alignments build theirs):
``batch_align`` encodes, pads and checks that query once and hands the fill
one row that every problem reads (a batch axis of stride 0).  Held here, on
the CPU, bit for bit against the same batch built of distinct copies of the
query (the general path), through the scores, the alignments, ``skip``,
``pad_to``, the host walk, per-problem matrices and shards on a repeated
device; the fill's plain version against the replicated rows; the code check
on the one row; and ``search_database`` against the JAX package."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu_torch import align
from aligner_tpu_torch.errors import ValidationError
from aligner_tpu_torch.ops import dp_fill
from aligner_tpu_torch.ops.scan_engine import fill_batch

torch.set_num_threads(1)

B = 21


def _problems(seed, qlen=37):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 24, qlen).astype(np.int8)
    ts = [rng.integers(0, 24, int(n)).astype(np.int8) for n in rng.integers(1, 60, B)]
    ts[4] = q.copy()  # one hit of the whole query
    ts[9] = q[5:30].copy()
    return q, ts


def _same_scores(a, b):
    for f in ("fmax", "fy", "fx", "end"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def _same_alignments(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is None:
            continue
        x, y = x.alignment, y.alignment
        assert np.float64(x.f).tobytes() == np.float64(y.f).tobytes()
        assert tuple(map(tuple, x.coords)) == tuple(map(tuple, y.coords))
        assert x.query.dtype == y.query.dtype and x.target.dtype == y.target.dtype
        np.testing.assert_array_equal(x.query, y.query)
        np.testing.assert_array_equal(x.target, y.target)


# (name, batch_align's keyword arguments); "repeated" shards over one device
# named three times, "batched" gives every problem its own matrix
CASES = [
    ("scores", {}),
    ("noargmax", {"track_argmax": False}),
    ("alignments", {"with_alignments": True}),
    ("skip", {"skip": np.arange(B) % 3 == 1}),
    ("skip-alignments", {"skip": np.arange(B) % 4 == 2, "with_alignments": True}),
    ("pad_to", {"pad_to": 32}),
    ("pad_to-alignments", {"pad_to": 25, "with_alignments": True}),
    ("host-walk", {"with_alignments": True, "walk": "host"}),
    ("repeated", {}),
    ("repeated-alignments", {"with_alignments": True}),
    ("batched", {"with_alignments": True}),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_one_query_object_equals_distinct_copies(name, kw, mode, dtype, monkeypatch):
    q, ts = _problems(1)
    matrix = np.asarray(port.blosum62())
    if name == "batched":
        rng = np.random.default_rng(2)
        matrix = matrix[None] + rng.integers(-1, 2, (B, 24, 24))
    if name.startswith("repeated"):
        monkeypatch.setattr(align, "_shard_devices", lambda device: [device] * 3)
        monkeypatch.delenv("ALIGNER_AUTO_SHARD", raising=False)
    handed = []
    orig = dp_fill.fill

    def spying(q_, *a, **k):
        handed.append(q_.stride(0))
        return orig(q_, *a, **k)

    monkeypatch.setattr(dp_fill, "fill", spying)
    run = dict(mode=mode, device="cpu", dtype=dtype, **kw)
    got = align.batch_align([q] * B, ts, matrix, 11.0, 2.0, **run)
    assert handed and set(handed) == {0}  # every shard read the one row
    handed.clear()
    want = align.batch_align([q.copy() for _ in range(B)], ts, matrix, 11.0, 2.0, **run)
    assert handed and 0 not in handed
    if kw.get("with_alignments"):
        _same_alignments(got, want)
        assert any(r is not None for r in got)
    else:
        _same_scores(got, want)


@pytest.mark.parametrize("one_object", [True, False], ids=["shared", "distinct"])
@pytest.mark.parametrize("where", [0, 36], ids=["first", "last"])
def test_a_query_code_out_of_range_is_refused_alike(one_object, where):
    q, ts = _problems(3)
    q[where] = 24  # BLOSUM62 has 24 symbols
    queries = [q] * B if one_object else [q.copy() for _ in range(B)]
    with pytest.raises(ValidationError,
                       match=r"^query codes must lie in the 24-symbol scoring alphabet$"):
        align.batch_align(queries, ts, port.blosum62(), 11.0, 2.0, device="cpu")


@pytest.mark.parametrize("dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("mode", ["local", "global"])
def test_the_fill_reads_a_broadcast_query_as_its_replicated_rows(mode, dirs):
    rng = np.random.default_rng(4)
    row = torch.as_tensor(rng.integers(0, 24, 40), dtype=torch.int32)
    ql = torch.as_tensor(rng.integers(0, 41, 33), dtype=torch.int32)
    t = torch.as_tensor(rng.integers(0, 24, (33, 29)), dtype=torch.int32)
    tl = torch.as_tensor(rng.integers(0, 30, 33), dtype=torch.int32)
    m = torch.as_tensor(np.array(port.blosum62()), dtype=torch.float64)
    kw = dict(mode=mode, with_dirs=dirs)
    got = dp_fill.fill(row.expand(33, -1), ql, t, tl, m, 11.0, 2.0, **kw)
    want = fill_batch(row.repeat(33, 1), ql, t, tl, m, 11.0, 2.0, **kw)
    for f in ("fmax", "fy", "fx", "end", "words"):
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None)
        assert x is None or (x.dtype == y.dtype and torch.equal(x, y)), f


def test_the_fill_checks_the_one_row_and_its_layout():
    row = torch.zeros(16, dtype=torch.int32)
    row[7] = 30
    ql = torch.full((5,), 16, dtype=torch.int32)
    t = torch.zeros((5, 8), dtype=torch.int32)
    tl = torch.full((5,), 8, dtype=torch.int32)
    m = torch.zeros((24, 24), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"q codes must lie in \[0, 24\)"):
        dp_fill.fill(row.expand(5, -1), ql, t, tl, m, 11.0, 2.0)
    # a stride-0 batch over a row that is not contiguous is refused
    every_other = torch.zeros(32, dtype=torch.int32)[::2]
    with pytest.raises(ValueError, match="q must be contiguous"):
        dp_fill.fill(every_other.expand(5, -1), ql, t, tl, m, 11.0, 2.0)


@pytest.mark.parametrize("with_alignments", [True, False], ids=["alignments", "scores"])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("seed", [5, 6])
def test_search_database_matches_the_jax_package(seed, mode, with_alignments):
    rng = np.random.default_rng(seed)
    query = rng.integers(0, 24, int(rng.integers(20, 50))).astype(np.int8)
    db = [rng.integers(0, 24, int(n)).astype(np.int8) for n in rng.integers(5, 120, 70)]
    db[11] = query.copy()
    db[40] = query[4:].copy()
    db[3] = np.zeros(0, np.int8)
    kw = dict(k=6, mode=mode, with_alignments=with_alignments)
    a = port.search_database(query, db, ref.blosum62(), 11.0, 2.0, device="cpu", **kw)
    b = ref.search_database(query, db, ref.blosum62(), 11.0, 2.0, **kw)
    assert [(h.index, h.name, h.score, h.coords) for h in a] == \
        [(h.index, h.name, h.score, h.coords) for h in b]
    for x, y in zip(a, b):
        assert (x.query_aligned is None) == (y.query_aligned is None)
        if x.query_aligned is not None:
            np.testing.assert_array_equal(x.query_aligned, y.query_aligned)
            np.testing.assert_array_equal(x.target_aligned, y.target_aligned)
