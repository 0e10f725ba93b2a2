"""The plain reference against the JAX package's scalar oracle and its
statistics on small cases (the tests may import it; the reference may
not)."""

import numpy as np
import pytest
import torch

from aligner_tpu import oracle
from aligner_tpu import statistics as jax_statistics
from aligner_tpu.heuristic import Heuristics, heuristic_align
from aligner_tpu.matrices import blosum62
from reference import heuristic as ref_heuristic
from reference import search as ref_search
from reference import statistics as ref_statistics
from reference.fill import local_bound, local_fill, local_fill_columns, pad, traceback

B62 = np.array(blosum62(), np.float64)


def _case(seed, n, real, ext):
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 20, rng.integers(1, 30)) for _ in range(n)]
    ts = [rng.integers(0, 20, rng.integers(1, 26)) for _ in range(n)]
    mats = rng.normal(0, 3, (n, 24, 24)) if real else None
    return qs, ts, mats, ext


@pytest.mark.parametrize("seed,real,ext", [(1, False, 2.0), (2, True, 2.0), (3, False, 0.7),
                                           (4, True, 11.0), (5, False, 11.0)])
def test_fill_and_traceback_against_the_oracle(seed, real, ext):
    qs, ts, mats, ext = _case(seed, 10, real, ext)
    q, ql = pad(qs, "cpu")
    t, tl = pad(ts, "cpu")
    m = torch.as_tensor(mats if real else B62)
    r = local_fill(q, ql, t, tl, m, 11.0, ext, with_dirs=True)
    w = traceback(r.dirs.numpy(), r.fy.numpy(), r.fx.numpy(), q.numpy(), t.numpy())
    for b in range(len(qs)):
        mm = mats[b] if real else B62
        a, _ = oracle.fill_local(qs[b], ts[b], mm, 11.0, ext)
        assert float(r.f[b]) == a.max()
        assert (int(r.fy[b]), int(r.fx[b])) == oracle.argmax_first_rowmajor(a)
        if r.fy[b] and r.fx[b]:
            o = oracle.align_local(qs[b], ts[b], mm, 11.0, ext)
            assert np.array_equal(o.query_aligned, w.query[b])
            assert np.array_equal(o.target_aligned, w.target[b])
            assert o.coords == w.coords[b]
        else:
            assert w.query[b] is None


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_column_fill_against_the_oracle_on_integral_scoring(seed):
    qs, ts, _, _ = _case(seed, 16, False, 2.0)
    q, ql = pad(qs, "cpu")
    t, tl = pad(ts, "cpu")
    r = local_fill_columns(q, ql, t, tl, torch.as_tensor(B62), 11.0, 2.0, with_dirs=True)
    w = traceback(r.dirs.numpy(), r.fy.numpy(), r.fx.numpy(), q.numpy(), t.numpy(),
                  by_column=True)
    for b in range(len(qs)):
        a, _ = oracle.fill_local(qs[b], ts[b], B62, 11.0, 2.0)
        assert float(r.f[b]) == a.max()
        assert (int(r.fy[b]), int(r.fx[b])) == oracle.argmax_first_rowmajor(a)
        if r.fy[b] and r.fx[b]:
            o = oracle.align_local(qs[b], ts[b], B62, 11.0, 2.0)
            assert np.array_equal(o.query_aligned, w.query[b])
            assert np.array_equal(o.target_aligned, w.target[b]) and o.coords == w.coords[b]


def test_the_penalties_of_row_one_settle_over_passes():
    """Integral scoring puts exact zeros on bottom rows, so row 1's
    penalties take more than one pass; the result is the oracle's."""
    qs, ts, _, _ = _case(9, 24, False, 2.0)
    q, ql = pad(qs, "cpu")
    t, tl = pad(ts, "cpu")
    r = local_fill(q, ql, t, tl, torch.as_tensor(B62), 11.0, 2.0)
    assert r.passes > 1
    for b in range(len(qs)):
        assert float(r.f[b]) == oracle.fill_local(qs[b], ts[b], B62, 11.0, 2.0)[0].max()


def test_the_bound_is_never_below_the_score():
    qs, ts, _, _ = _case(6, 30, False, 2.0)
    q, ql = pad(qs, "cpu")
    t, tl = pad(ts, "cpu")
    bound = local_bound(q, ql, t, tl, torch.as_tensor(B62), 2.0)
    f = local_fill(q, ql, t, tl, torch.as_tensor(B62), 11.0, 2.0).f
    assert bool((bound.double() >= f).all())


def test_top_hits_against_every_oracle_score():
    rng = np.random.default_rng(3)
    query = rng.integers(0, 20, 25)
    db = [rng.integers(0, 20, rng.integers(5, 40)) for _ in range(60)]
    db[17] = query[3:20].copy()
    scores = np.array([oracle.fill_local(query, s, B62, 11.0, 2.0)[0].max() for s in db])
    order = np.argsort(-scores, kind="stable")[:10]
    hits = ref_search.top_hits(query, db, B62, 11.0, 2.0, 10, device="cpu", first=4)
    assert [h.index for h in hits] == [int(i) for i in order]
    assert [h.score for h in hits] == [float(scores[i]) for i in order]
    for h in hits:
        o = oracle.align_local(query, db[h.index], B62, 11.0, 2.0)
        assert np.array_equal(o.query_aligned, h.query) and o.coords == h.coords


def test_populations_against_the_host_loop():
    rng = np.random.default_rng(4)
    q = rng.integers(0, 20, 22).astype(np.int8)
    t = np.concatenate([q[:15], rng.integers(0, 20, 6)]).astype(np.int8)
    freqs = np.bincount(np.concatenate([q, t]), minlength=24)[:24] / (len(q) + len(t))
    starts = rng.integers(-1, 2, (5, 24, 24)).astype(np.float64)
    (got,), _ = ref_heuristic.populations([(q, t, starts, freqs)], 11.0, 11.0, 0.0, 1e5,
                                          device="cpu")
    h = Heuristics(kd=0.0, r_squared=1e5, frequencies=freqs)
    for m, g in zip(starts, got):
        want = heuristic_align(q, t, m, 11.0, 11.0, h, backend="oracle")
        assert g.f == want.alignment.f
        assert np.array_equal(g.query, want.alignment.query)
        assert np.array_equal(g.target, want.alignment.target)
        assert np.array_equal(g.matrix, want.matrix)


def test_p_value_against_the_jax_packages_statistics():
    """The same seeded shuffles, their oracle scores, and the JAX package's
    fit on them (its batched fill is held to the oracle elsewhere)."""
    rng = np.random.default_rng(5)
    q = rng.integers(0, 20, 18).astype(np.int8)
    t = rng.integers(0, 20, 16).astype(np.int8)
    m = rng.normal(0, 3, (24, 24))
    (lengths, scores), = ref_statistics.shuffled_scores_many(
        [(q, t, m, np.random.default_rng(8))], 11.0, 11.0, 40, device="cpu")
    r2 = np.random.default_rng(8)
    shuffles = [jax_statistics.shuffle_and_randomize_sequence(t, r2) for _ in range(39)]
    assert list(lengths) == [len(s) for s in shuffles]
    want_scores = [oracle.fill_local(q, s, m, 11.0, 11.0)[0].max() for s in shuffles]
    assert list(scores) == want_scores
    init = float(oracle.fill_local(q, t, m, 11.0, 11.0)[0].max())
    got = ref_statistics.p_value(q, t, init, lengths, scores)
    params = jax_statistics.calculate_distribution_params(
        len(q), np.concatenate([[len(t)], lengths]), np.concatenate([[init], scores]))
    want = params.get_p_value(len(q), len(t), init)
    assert (np.isnan(got) and np.isnan(want)) or got == want
