"""The general traffic generator: inputs made from a cell's parameters and
the run's seed.

Frozen copies of the program's own generators, named where each is
defined: ``chip_smoke.py:1178`` (``make_database``: lengths log-normal,
residues uniform), ``chip_smoke.py:424`` (a homolog: the sequence with a
quarter of its positions substituted), ``chip_smoke.py:1691``
(``service_fasta``: the two records and a homolog of each),
``aligner_tpu_torch/service/dispatcher.py:54`` (``generate_pairs``) and
``:63`` (``symbol_frequencies``), ``aligner_tpu_torch/service/store.py:423``
(``get_population``: {-1, 0, 1} matrices at a least distance, from an
empty store).

What sets the work comes from seeds fixed in the parameters, so every
run's seed gives the same set of work: the search's lengths (its residues
come from the run's seed), the service's records and its pools of
matrices and shuffle generators, of which the run's seed sets the order.
"""

from __future__ import annotations

import numpy as np

from reference.heuristic import get_threshold, transform_matrix

LETTERS = "ARNDCQEGHILKMFPSTWYVBJZX"  # the protein alphabet's codes (enums.rs:55-167)
STANDARD = 20  # residues are drawn from the 20 standard amino acids


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def encode(seq: str) -> np.ndarray:
    """Codes of a protein string; characters outside the alphabet are
    skipped, as the service encodes (``strict=False``)."""
    idx = {c: i for i, c in enumerate(LETTERS)}
    return np.array([idx[c] for c in seq.upper() if c in idx], dtype=np.int8)


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths log-normal around ``median`` with ``sigma``, rounded
    and clipped to [min, max]."""
    raw = rng.lognormal(np.log(float(spec["median"])), float(spec["sigma"]), n)
    return np.clip(np.round(raw), spec["min"], spec["max"]).astype(np.int64)


def residues(lens, rng: np.random.Generator) -> list[np.ndarray]:
    """Uniform residue codes for sequences of the given lengths, drawn in
    one call."""
    flat = rng.integers(0, STANDARD, int(np.sum(lens))).astype(np.int8)
    ends = np.cumsum(lens)
    return [flat[e - n:e] for e, n in zip(ends, lens)]


def homolog(seq: np.ndarray, substituted: float, rng: np.random.Generator) -> np.ndarray:
    out = np.array(seq, dtype=np.int8)
    mask = rng.random(len(out)) < substituted
    out[mask] = rng.integers(0, STANDARD, int(mask.sum()))
    return out


def query_pool(spec: dict, seed: int) -> list[np.ndarray]:
    """The cell's queries: fixed ``lengths``, or ``count`` lengths drawn
    from ``length`` with the fixed ``length_seed``; residues from the run's
    seed."""
    if "lengths" in spec:
        lens = np.array(spec["lengths"], np.int64)
    else:
        lens = lengths(spec["length"], int(spec["count"]), rng_for(spec["length_seed"]))
    return residues(lens, rng_for(seed, 2))


def query_order(spec: dict, n: int, seed: int):
    """Indices into the pool, repeated for as long as the loop asks:
    the pool's order, or a seeded permutation of it."""
    order = (np.arange(n) if spec["order"] == "fixed"
             else rng_for(seed, 3).permutation(n))
    i = 0
    while True:
        yield int(order[i % n])
        i += 1


def database(db: dict, pool: list[np.ndarray], seed: int) -> list[np.ndarray]:
    """The database: ``sequences`` of lengths drawn with the fixed
    ``length_seed``, residues from the run's seed, and for each query of
    ``pool`` ``per_query`` homologs appended: windows of at most
    ``max_length`` spread evenly along the query, each with ``substituted``
    of its positions replaced."""
    lens = lengths(db["length"], int(db["sequences"]), rng_for(db["length_seed"]))
    seqs = residues(lens, rng_for(seed, 1))
    h = db["homologs"]
    rng = rng_for(seed, 4)
    for q in pool:
        w = min(len(q), int(h["max_length"]))
        starts = np.linspace(0, len(q) - w, int(h["per_query"])).round().astype(int)
        for s in starts:
            seqs.append(homolog(q[s:s + w], float(h["substituted"]), rng))
    return seqs


def service_records(cfg: dict) -> list[np.ndarray]:
    """The request's records: the configuration's records and a homolog of
    each, from the configuration's fixed seed."""
    recs = [encode(r["seq"]) for r in cfg["records"]]
    rng = rng_for(int(cfg["homologs"]["seed"]), 5)
    return recs + [homolog(r, float(cfg["homologs"]["substituted"]), rng) for r in recs]


def pool_entry(pool: dict, seed: int, i: int, n_pairs: int) -> tuple[int, int]:
    """Request ``i``'s pair (the pairs in turn) and its entry in that
    pair's pool of ``per_pair``, less the [pair, entry] of ``exclude``, in
    an order drawn from the run's seed."""
    pair = i % n_pairs
    out = {tuple(e) for e in pool.get("exclude", [])}
    entries = [k for k in range(int(pool["per_pair"])) if (pair, k) not in out]
    order = rng_for(seed, 10, pair).permutation(len(entries))
    return pair, entries[int(order[(i // n_pairs) % len(entries)])]


def pairs(records: list) -> list[tuple[int, int]]:
    """All unordered pairs of records in order, (query, target)
    (handlers.rs:253-264)."""
    return [(i, j) for i in range(len(records)) for j in range(i + 1, len(records))]


def symbol_frequencies(q: np.ndarray, t: np.ndarray, dim: int) -> np.ndarray:
    """Each code's share of both sequences, codes at or past ``dim`` left
    out of the counts but not of the length (handlers.rs:209-224)."""
    enc = np.concatenate([q, t]).astype(np.int64)
    counts = np.bincount(enc[enc < dim], minlength=dim).astype(np.float64)[:dim]
    return counts / max(len(q) + len(t), 1)


def population(dim: int, count: int, rng: np.random.Generator) -> np.ndarray:
    """``count`` {-1, 0, 1} matrices, each at least ``get_threshold(dim)``
    from every earlier one (repository/mod.rs:336-387, an empty store)."""
    threshold = get_threshold(dim)
    out: list[np.ndarray] = []
    while len(out) < count:
        m = rng.integers(-1, 2, size=(dim, dim)).astype(np.float64)
        if all(np.linalg.norm(m - o) >= threshold for o in out):
            out.append(m)
    return np.stack(out)


def pvalue_matrix(req: dict, q, t, seed: int, pair: int) -> np.ndarray:
    """A pair's p-value matrix: one starting matrix of the population rule
    (from the fixed ``seed``) transformed by the service's rule with the
    pair's frequencies."""
    start = population(req["dimValue"], 1, rng_for(seed, 6, pair))[0]
    freqs = symbol_frequencies(q, t, req["dimValue"])
    r2 = float(req["rSquaredValue"]) or float(start.size)
    return transform_matrix(start, float(req["kdValue"]), r2, freqs)
