"""The port's main path as a whole against the JAX package, bit for bit:
``batch_align`` (scores only and with alignments, ``pad_to``/``skip``,
the empty local problem), ``search_database`` and the ``aligner-search``
CLI, ``calculate_p_value``, and the frozen golden fixtures of
``book_example_1``.  Runs on the CPU through the kernels' plain
versions."""

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.cli import search as ref_cli
from aligner_tpu_torch.cli import search as port_cli
from aligner_tpu_torch.io import FastaRecord, read_fasta_file, write_fasta

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "fixtures" / "examples_golden.json").read_text())


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the JAX batch path would otherwise shard over conftest's 8 devices
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def _pairs(rng, n, related):
    qs = [rng.integers(0, 24, rng.integers(1, 24)).astype(np.int8) for _ in range(n)]
    if related:
        ts = []
        for q in qs:
            t = q.copy()
            t[rng.integers(0, len(t), max(1, len(t) // 6))] = rng.integers(0, 24)
            ts.append(t)
        return qs, ts
    return qs, [rng.integers(0, 24, rng.integers(1, 24)).astype(np.int8)
                for _ in range(n)]


def _same_alignments(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if y is None:
            assert x is None
            continue
        assert np.array_equal(x.alignment.query, y.alignment.query)
        assert np.array_equal(x.alignment.target, y.alignment.target)
        assert x.alignment.coords == y.alignment.coords
        assert x.alignment.f == y.alignment.f


@pytest.mark.parametrize("mode", ["local", "global"])
def test_batch_align_scores(rng, mode):
    qs, ts = _pairs(rng, 12, related=False)
    m = ref.blosum62()
    a = port.batch_align(qs, ts, m, 11.0, 2.0, mode=mode)
    b = ref.batch_align(qs, ts, m, 11.0, 2.0, mode=mode)
    for f in ("fmax", "fy", "fx", "end"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and np.array_equal(x, y), f


@pytest.mark.parametrize("mode", ["local", "global"])
def test_batch_align_alignments(rng, mode):
    qs, ts = _pairs(rng, 11, related=(mode == "local"))
    m = ref.blosum62()
    a = port.batch_align(qs, ts, m, 11.0, 2.0, mode=mode, with_alignments=True)
    b = ref.batch_align(qs, ts, m, 11.0, 2.0, mode=mode, with_alignments=True)
    _same_alignments(a, b)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_batch_align_pad_to_and_skip(rng, mode):
    qs, ts = _pairs(rng, 9, related=True)
    m = ref.blosum62()
    skip = np.zeros(9, bool)
    skip[[1, 4, 7]] = True
    kw = dict(mode=mode, pad_to=16, skip=skip)
    a = port.batch_align(qs, ts, m, 11.0, 2.0, with_alignments=True, **kw)
    b = ref.batch_align(qs, ts, m, 11.0, 2.0, with_alignments=True, **kw)
    _same_alignments(a, b)
    assert all(a[i] is None for i in (1, 4, 7))
    sa = port.batch_align(qs, ts, m, 11.0, 2.0, **kw)
    sb = ref.batch_align(qs, ts, m, 11.0, 2.0, **kw)
    assert sa.fmax.shape == (9,) and np.array_equal(sa.fmax, sb.fmax)
    assert np.array_equal(sa.end, sb.end) and np.all(sa.fmax[skip] == 0)


def test_empty_local_problem_is_none():
    """A local problem with no positive-scoring cell yields None for just
    that entry; its neighbours still align."""
    m = np.full((24, 24), -5.0)
    m[np.arange(8, 24), np.arange(8, 24)] = 4.0  # only codes 8.. can match
    qs = [np.arange(8, dtype=np.int8), np.arange(8, 16, dtype=np.int8)]
    ts = [np.arange(8, dtype=np.int8)[::-1].copy(), np.arange(8, 16, dtype=np.int8)]
    a = port.batch_align(qs, ts, m, 11.0, 2.0, with_alignments=True)
    b = ref.batch_align(qs, ts, m, 11.0, 2.0, with_alignments=True)
    _same_alignments(a, b)
    assert a[0] is None and a[1] is not None


def test_search_database_and_cli_match_reference(rng, tmp_path):
    query = rng.integers(0, 24, 30).astype(np.int8)
    db = [rng.integers(0, 24, int(rng.integers(20, 46))).astype(np.int8)
          for _ in range(40)]
    db[7] = query.copy()
    db[21] = query[3:].copy()
    m = ref.blosum62()
    for mode in ("local", "global"):
        a = port.search_database(query, db, m, 11.0, 2.0, k=5, mode=mode)
        b = ref.search_database(query, db, m, 11.0, 2.0, k=5, mode=mode)
        assert [(h.index, h.name, h.score, h.coords) for h in a] == \
            [(h.index, h.name, h.score, h.coords) for h in b]
        for x, y in zip(a, b):
            assert np.array_equal(x.query_aligned, y.query_aligned)
            assert np.array_equal(x.target_aligned, y.target_aligned)

    dec = ref.Protein.decode
    (tmp_path / "q.fasta").write_text(write_fasta([FastaRecord("query", dec(query).encode())]))
    (tmp_path / "db.fasta").write_text(write_fasta(
        [FastaRecord(f"seq{i}", dec(s).encode()) for i, s in enumerate(db)]))
    args = ["-q", str(tmp_path / "q.fasta"), "-i", str(tmp_path / "db.fasta"), "-k", "4"]
    outs = []
    for main, extra in ((port_cli.main, ["--device", "cpu"]), (ref_cli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(args + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].startswith("1\tseq7\t")


def test_p_value_matches_reference():
    """50 shuffles from one seed: the same scores, fit and p-value."""
    recs = read_fasta_file(ROOT / "examples" / "protein.fasta")
    q = port.Protein.encode(recs[0].seq, strict=True)[:30]
    t = port.Protein.encode(recs[1].seq, strict=True)[30:60]
    m = ref.blosum62()
    f = float(port.batch_align([q], [t], m, 11.0, 2.0).fmax[0])
    assert f == float(ref.batch_align([q], [t], m, 11.0, 2.0).fmax[0])
    a = port.calculate_p_value(q, t, f, 11.0, 2.0, m, n_sequences=50,
                               rng=np.random.default_rng(7))
    b = ref.calculate_p_value(q, t, f, 11.0, 2.0, m, n_sequences=50,
                              rng=np.random.default_rng(7))
    assert isinstance(a, float) and 0.0 < a < 1.0
    assert a == b


def test_golden_fixtures_book_example():
    recs = read_fasta_file(ROOT / "examples" / "book_example_1.fasta")
    q = port.Protein.encode(recs[0].seq, strict=True)
    t = port.Protein.encode(recs[1].seq, strict=True)
    for key, want in GOLDEN["book_example_1"].items():
        mode, d, e = key.split("_")
        (r,) = port.batch_align([q], [t], port.blosum62(), float(d[1:]), float(e[1:]),
                                mode=mode, with_alignments=True)
        aln = r.alignment
        assert aln.f == want["f"], key
        assert tuple(map(tuple, aln.coords)) == tuple(map(tuple, want["coords"])), key
        assert port.Protein.decode(aln.query) == want["query"], key
        assert port.Protein.decode(aln.target) == want["target"], key
