"""One huge global DNA pair a request: one client sends the pool's pairs in
the seed's order, each first to ``aligner_tpu_torch.align_global`` (the
aligned strings and coordinates), then to ``global_end_score`` (the end
score), with the configuration's scoring, the default backend and engine
pick, on the card.

The pool: ``pairs.substituted`` pairs of ``lengths`` bases, uniform over
ATCG from the run's seed; each target made from its query by substituting
that share of its bases (each by another base) and deleting, and inserting
after, a tenth of that share (``pairs.indel_share``), then cut, or filled
with seeded bases, back to the length.

Answers checked: a pair the window both aligned and scored, picked by the
seed: every aligned answer against :func:`reference.global_pair.global_pair`
step by step (codes, coordinates and length), every end score against its
H[R, C].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness import roofline_pair, traffic
from reference.global_pair import global_pair

BASES = 4  # A, T, C, G (enums.rs:138-167)


@dataclasses.dataclass
class State:
    pool: list  # (query, target) int8 codes
    matrix: np.ndarray
    scoring: dict
    order: np.ndarray  # pool indices in the seed's order
    device: object


def homolog_pair(length: int, substituted: float, indel_share: float,
                 rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A query of ``length`` bases and its target: ``substituted`` of the
    bases replaced by another base, ``substituted x indel_share`` deleted
    and as many single bases inserted (after a kept base), then cut or
    filled back to ``length``."""
    q = rng.integers(0, BASES, length).astype(np.int8)
    t = q.copy()
    sub = rng.random(length) < substituted
    t[sub] = (q[sub] + rng.integers(1, BASES, int(sub.sum()))) % BASES
    rate = substituted * indel_share
    t = t[rng.random(length) >= rate]
    after = np.flatnonzero(rng.random(len(t)) < rate) + 1
    t = np.insert(t, after, rng.integers(0, BASES, len(after)).astype(np.int8))
    if len(t) < length:
        t = np.concatenate([t, rng.integers(0, BASES, length - len(t)).astype(np.int8)])
    return q, np.ascontiguousarray(t[:length])


def inputs(run) -> State:
    cfg = run.config
    n = int(cfg["lengths"]["query"])
    if int(cfg["lengths"]["target"]) != n:
        raise ValueError("the pool's pairs have one length")
    rng = traffic.rng_for(run.seed, 20)
    pairs = cfg["pairs"]
    pool = [homolog_pair(n, float(s), float(pairs["indel_share"]), rng)
            for s in pairs["substituted"]]
    order = traffic.rng_for(run.seed, 21).permutation(len(pool))
    return State(pool, np.array(cfg["scoring"]["matrix"], np.float64), cfg["scoring"], order,
                 run.device)


def setup(run) -> State:
    from aligner_tpu_torch.observability import counters

    st = inputs(run)
    request(st, 0)  # every kernel and plan of the window: one alignment,
    request(st, 1)  # one end score, on the first pair
    counters.reset()
    return st


def pair_of(st: State, i: int) -> int:
    """Request ``i``'s pair: each pair in the seed's order twice running."""
    return int(st.order[(i // 2) % len(st.order)])


def request(st: State, i: int) -> dict:
    import aligner_tpu_torch as port

    k = pair_of(st, i)
    q, t = st.pool[k]
    sc = st.scoring
    rec = {"pair": k, "cells": len(q) * len(t)}
    if i % 2 == 0:
        res = port.align_global(q, t, st.matrix, sc["del"], sc["ext"], alphabet=port.DNA,
                                device=st.device)
        rec.update(kind="align", qa=np.asarray(res.alignment.query),
                   ta=np.asarray(res.alignment.target), coords=res.alignment.coords)
    else:
        rec.update(kind="score", end=port.global_end_score(
            q, t, st.matrix, sc["del"], sc["ext"], alphabet=port.DNA, device=st.device))
    return rec


def spans(st: State) -> list:
    sp = "aligner_tpu_torch.parallel.wavefront_sp"
    return [(sp, "sharded_global_align", "pipeline.align"),
            (sp, "sharded_global_end_score", "pipeline.score")]


def counters(st: State) -> dict:
    from aligner_tpu_torch.observability import counters as c

    return {k: dataclasses.asdict(v) for k, v in c.snapshot().items()}


def path_wrong(rec: dict, want) -> int:
    """Steps of an aligned answer that differ from the reference's ``want``
    = (end, qa, ta, coords): the columns whose codes differ, the columns
    one has past the other, and 1 for other coordinates."""
    _, qa, ta, coords = want
    n = min(len(qa), len(rec["qa"]))
    bad = int(np.count_nonzero((rec["qa"][:n] != qa[:n]) | (rec["ta"][:n] != ta[:n])))
    bad += abs(len(qa) - len(rec["qa"])) + abs(len(ta) - len(rec["ta"]))
    return bad + (tuple(map(tuple, rec["coords"])) != coords)


def reference(st: State, k: int, **kw):
    q, t = st.pool[k]
    sc = st.scoring
    return global_pair(q, t, st.matrix, sc["del"], sc["ext"], device=st.device, **kw)


def check(st: State, run) -> list:
    done = run.done()
    work(st, run)
    kinds = {kind: {r["pair"] for r in done if r["kind"] == kind} for kind in ("align", "score")}
    both = sorted(kinds["align"] & kinds["score"])
    if not both:
        return [("pairs_answered_both_ways", 0, -1)]
    rng = traffic.rng_for(run.seed, 9)
    n = max(1, min(int(run.traffic["check_requests"]) // 2, len(both)))
    paths = ends = 0
    for k in (int(v) for v in rng.choice(both, size=n, replace=False)):
        want = reference(st, k)
        for r in done:
            if r["pair"] != k:
                continue
            if r["kind"] == "align":
                paths += path_wrong(r, want)
            else:
                ends += r["end"] != want[0]
    return [("path_wrong", paths, 0), ("end_wrong", ends, 0)]


def work(st: State, run) -> None:
    """The window's fills' bounds: each aligned pair's alignment (``strip_s``),
    each scored pair's end score (``band_s``)."""
    vol = st.matrix.shape[0]
    run.work["strip_s"] = run.work["band_s"] = 0.0
    for r in run.done():
        q, t = st.pool[r["pair"]]
        if r["kind"] == "align":
            run.work["strip_s"] += roofline_pair.alignment(len(t), len(q), vol)
        else:
            run.work["band_s"] += roofline_pair.end_score(len(t), len(q), vol)


def control(st: State, run, dtype) -> list:
    """The reference in ``dtype`` in the program's place, on the first pair
    the window aligns and scores."""
    k = pair_of(st, 0)
    low = reference(st, k, dtype=dtype)
    want = reference(st, k)
    rec = {"qa": low[1], "ta": low[2], "coords": low[3]}
    return [("path_wrong", path_wrong(rec, want), 0), ("end_wrong", int(low[0] != want[0]), 0)]
