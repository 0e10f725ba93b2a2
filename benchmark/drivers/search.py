"""Database search: one client sends the cell's queries, one after
another, to ``aligner_tpu_torch.search.search_database`` against the
database the process holds.

Answers checked: a seeded sample of the queries answered (every answer to
each), each hit's database position, score, coordinates and aligned codes
against :func:`reference.search.top_hits`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness import roofline, traffic
from reference import search as ref_search


@dataclasses.dataclass
class State:
    pool: list
    db: list
    db_lengths: np.ndarray
    residues: int
    matrix: np.ndarray
    scoring: dict
    order: object
    device: object


def inputs(run) -> State:
    cfg, tr = run.config, run.traffic
    pool = traffic.query_pool(tr["queries"], run.seed)
    db = traffic.database(cfg["database"], pool, run.seed)
    lens = np.array([len(s) for s in db], np.int64)
    st = State(pool, db, lens, int(lens.sum()), np.array(cfg["scoring"]["matrix"], np.float64),
               cfg["scoring"], traffic.query_order(tr["queries"], len(pool), run.seed),
               run.device)
    return st


def setup(run) -> State:
    from aligner_tpu_torch.observability import counters

    st = inputs(run)
    pool = st.pool
    # every kernel and bucket plan the window uses, from the pool's shortest
    # query (the plans depend on the buckets, not on the query's length)
    search(st, pool[int(np.argmin([len(q) for q in pool]))])
    counters.reset()
    return st


def search(st: State, query):
    from aligner_tpu_torch.search import search_database

    sc = st.scoring
    return search_database(query, st.db, st.matrix, sc["del"], sc["ext"], k=sc["k"],
                           mode="local", with_alignments=True, device=st.device)


def request(st: State, i: int) -> dict:
    qi = next(st.order)
    hits = search(st, st.pool[qi])
    return {"query": qi, "qlen": len(st.pool[qi]), "cells": len(st.pool[qi]) * st.residues,
            "hits": [(h.index, h.score, h.coords,
                      None if h.query_aligned is None else np.array(h.query_aligned),
                      None if h.target_aligned is None else np.array(h.target_aligned))
                     for h in hits]}


def spans(st: State) -> list:
    def fill(args, kw):
        return "search.topk_alignments" if kw.get("with_alignments") else "search.bucket_fill"
    return [("aligner_tpu_torch.search", "batch_align", fill)]


def counters(st: State) -> dict:
    from aligner_tpu_torch.observability import counters as c

    return {k: dataclasses.asdict(v) for k, v in c.snapshot().items()}


def _coords(c):
    return None if c is None else tuple(tuple(int(v) for v in p) for p in c)


def wrong_hits(got: list, want: list) -> int:
    """Hits of ``got`` that differ from ``want``'s in position, score,
    coordinates or aligned codes (a missing or extra hit counts)."""
    bad = abs(len(got) - len(want))
    for (idx, score, coords, qa, ta), (w_idx, w_score, w_coords, w_qa, w_ta) in zip(got, want):
        same = (idx == w_idx and float(score) == float(w_score)
                and _coords(coords) == _coords(w_coords)
                and (qa is None) == (w_qa is None)
                and (qa is None or (np.array_equal(qa, w_qa) and np.array_equal(ta, w_ta))))
        bad += not same
    return bad


def reference_answers(st: State, qi: int, **kw) -> list:
    sc = st.scoring
    ref = ref_search.top_hits(st.pool[qi], st.db, st.matrix, sc["del"], sc["ext"], sc["k"],
                              device=st.device, **kw)
    return [(h.index, h.score, h.coords, h.query, h.target) for h in ref]


def check(st: State, run) -> list:
    done = run.done()
    work(st, run)
    if not done:
        return [("queries_answered", 0, -1)]
    queries = sorted({r["query"] for r in done})
    rng = traffic.rng_for(run.seed, 9)
    n = min(int(run.traffic["check_requests"]), len(queries))
    picked = [int(q) for q in rng.choice(queries, size=n, replace=False)]
    bad = 0
    for qi in picked:
        want = reference_answers(st, qi)
        for r in done:
            if r["query"] == qi:
                bad += wrong_hits(r["hits"], want)
    return [("hits_wrong", bad, 0)]


def work(st: State, run) -> None:
    """The fills' bounds over the window's queries: every database
    sequence's scores-only fill, then the alignable hits' fill with
    directions."""
    vol = st.matrix.shape[0]
    total = 0.0
    for r in run.done():
        total += roofline.shared_query_fill(r["qlen"], st.db_lengths, "f32", vol)
        top = [(r["qlen"], int(st.db_lengths[h[0]])) for h in r["hits"] if h[3] is not None]
        if top:
            total += roofline.fill(top, "f32", dirs=True, vol=vol)
    run.work["fill_s"] = total


def control(st: State, run, dtype) -> list:
    """The reference in ``dtype`` in the program's place, on the queries a
    window answers first."""
    n = min(int(run.traffic["check_requests"]), len(st.pool))
    first = []
    while len(first) < n:
        qi = next(st.order)
        if qi not in first:
            first.append(qi)
    bad = sum(wrong_hits(reference_answers(st, qi, dtype=dtype), reference_answers(st, qi))
              for qi in first)
    return [("hits_wrong", bad, 0)]
