"""The generators: the same seed gives the same inputs; another seed other
residues and order on the same sizes."""

import numpy as np
import pytest

from harness import manifest, traffic


def _db(seed, over):
    cfg = manifest.config(manifest.load(), "protein-search")
    cfg["database"].update(over)
    pool = traffic.query_pool({"count": 5, "length": {"median": 50, "sigma": 0.6, "min": 30,
                                                      "max": 90}, "length_seed": 2,
                               "order": "seeded"}, seed)
    return pool, traffic.database(cfg["database"], pool, seed)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**33 + 1])
def test_search_inputs_repeat_from_the_seed(seed):
    over = {"sequences": 300}
    (p1, d1), (p2, d2) = _db(seed, over), _db(seed, over)
    assert all(np.array_equal(a, b) for a, b in zip(p1 + d1, p2 + d2))
    p3, d3 = _db(seed + 1, over)
    assert [len(s) for s in p1 + d1] == [len(s) for s in p3 + d3]
    assert not all(np.array_equal(a, b) for a, b in zip(d1, d3))
    assert len(d1) == 300 + 3 * len(p1)
    assert all(s.dtype == np.int8 and s.min() >= 0 and s.max() < 20 for s in d1)


def test_homologs_are_windows_of_their_query():
    pool, db = _db(4, {"sequences": 10, "homologs": {"per_query": 3, "substituted": 0.25,
                                                      "max_length": 40}})
    for k, q in enumerate(pool):
        for j, h in enumerate(db[10 + 3 * k:13 + 3 * k]):
            assert len(h) == min(len(q), 40)
            starts = np.linspace(0, len(q) - len(h), 3).round().astype(int)
            same = (h == q[starts[j]:starts[j] + len(h)]).mean()
            assert 0.6 < same < 0.95


def test_query_order():
    fixed = traffic.query_order({"order": "fixed"}, 3, 9)
    assert [next(fixed) for _ in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    a = traffic.query_order({"order": "seeded"}, 8, 9)
    b = traffic.query_order({"order": "seeded"}, 8, 9)
    first = [next(a) for _ in range(8)]
    assert first == [next(b) for _ in range(8)] and sorted(first) == list(range(8))


def test_service_inputs_repeat_from_the_seed():
    cfg = manifest.config(manifest.load(), "align-service")
    r1, r2 = traffic.service_records(cfg), traffic.service_records(cfg)
    assert all(np.array_equal(a, b) for a, b in zip(r1, r2))
    assert [len(r) for r in r1] == [340, 341, 340, 341]
    assert traffic.pairs(r1) == [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    m1 = traffic.population(24, 8, traffic.rng_for(7, 7, 0))
    m2 = traffic.population(24, 8, traffic.rng_for(7, 7, 0))
    assert np.array_equal(m1, m2) and set(np.unique(m1)) <= {-1.0, 0.0, 1.0}
    for i in range(8):
        for j in range(i):
            assert np.linalg.norm(m1[i] - m1[j]) >= 24.6
    f = traffic.symbol_frequencies(r1[0], r1[1], 24)
    assert abs(f.sum() - 1.0) < 1e-12
    p = traffic.pvalue_matrix(cfg["request"], r1[0], r1[1], 7, 0)
    assert abs((p * p).sum() - 1e5) < 1e-6 * 1e5


def test_every_seed_draws_the_same_pool_in_its_own_order():
    pool = {"per_pair": 5, "seed": 1}
    for seed in (3, 2**31 + 3):
        entries = [traffic.pool_entry(pool, seed, i, 6) for i in range(30)]
        assert [p for p, _ in entries] == [i % 6 for i in range(30)]
        for pair in range(6):
            assert sorted(k for p, k in entries if p == pair) == list(range(5))
    assert ([traffic.pool_entry(pool, 3, i, 6) for i in range(30)]
            != [traffic.pool_entry(pool, 4, i, 6) for i in range(30)])


def test_excluded_pool_entries_are_never_drawn():
    pool = {"per_pair": 4, "seed": 1, "exclude": [[2, 1], [5, 3]]}
    entries = {traffic.pool_entry(pool, 8, i, 6) for i in range(60)}
    assert (2, 1) not in entries and (5, 3) not in entries
    assert len(entries) == 6 * 4 - 2
