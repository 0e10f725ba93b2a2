"""The alignment service's p-value: one client asks
``aligner_tpu_torch.statistics.calculate_p_value`` for one p-value after
another, as ``aligner-torch-calc`` does, on the request's pairs in turn,
each with the pair's transformed matrix and a generator seeded for the
request.

Answers checked: a seeded sample of the p-values answered, each against
:mod:`reference.statistics` on the same seeded shuffles (a NaN is a value
the reference can give too).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from harness import roofline, traffic
from reference import statistics as ref
from reference.fill import local_fill, pad


@dataclasses.dataclass
class State:
    records: list
    pairs: list
    matrices: list
    initial: list
    n: int
    gap: float
    device: object
    seed: int
    pool: dict


def inputs(run) -> State:
    cfg = run.config
    req = cfg["request"]
    recs = traffic.service_records(cfg)
    pairs = traffic.pairs(recs)
    pool = run.traffic["pool"]
    mats = [traffic.pvalue_matrix(req, recs[a], recs[b], int(pool["seed"]), k)
            for k, (a, b) in enumerate(pairs)]
    # each pair's own local score under its matrix, by the reference
    init = []
    for (a, b), m in zip(pairs, mats):
        q, ql = pad([recs[a]], run.device)
        t, tl = pad([recs[b]], run.device)
        init.append(float(local_fill(q, ql, t, tl, torch.as_tensor(m, device=run.device),
                                     float(req["delValue"]), float(req["delValue"])).f[0]))
    return State(recs, pairs, mats, init, int(cfg["pvalue"]["n_sequences"]),
                 float(req["delValue"]), run.device, run.seed, pool)


def generator(st: State, i: int) -> tuple[int, np.random.Generator]:
    """Request ``i``'s pair and shuffle generator: its pair's pool entry."""
    pair, k = traffic.pool_entry(st.pool, st.seed, i, len(st.pairs))
    return pair, traffic.rng_for(int(st.pool["seed"]), 8, pair, k)


def setup(run) -> State:
    st = inputs(run)
    p_value(st, *generator(st, 0))  # the kernels and the native fit
    return st


def p_value(st: State, pair: int, rng) -> float:
    from aligner_tpu_torch.statistics import calculate_p_value

    a, b = st.pairs[pair]
    return calculate_p_value(st.records[a], st.records[b], st.initial[pair], st.gap, st.gap,
                             st.matrices[pair], rng=rng, device=st.device,
                             n_sequences=st.n)


def request(st: State, i: int) -> dict:
    pair, rng = generator(st, i)
    t0 = time.perf_counter()
    p = p_value(st, pair, rng)
    return {"pair": pair, "wall": time.perf_counter() - t0, "p": p}


def spans(st: State) -> list:
    return [("aligner_tpu_torch.statistics", "batch_align", "pvalue.fill"),
            ("aligner_tpu_torch.statistics", "calculate_distribution_params", "pvalue.fit")]


def same(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or a == b


def reference(st: State, picked: list, fit_seconds=None, **kw) -> list:
    """The reference's p-value of each request of ``picked``, the shuffles
    of all of them in one batch; a fit given ``fit_seconds`` that does not
    end in them gives None."""
    items = []
    for i in picked:
        pair, rng = generator(st, i)
        a, b = st.pairs[pair]
        items.append((st.records[a], st.records[b], st.matrices[pair], rng))
    scored = ref.shuffled_scores_many(items, st.gap, st.gap, st.n, device=st.device, **kw)
    out = []
    for i, (lengths, scores) in zip(picked, scored):
        a, b = st.pairs[i % len(st.pairs)]
        deadline = None if fit_seconds is None else time.monotonic() + fit_seconds
        try:
            p = ref.p_value(st.records[a], st.records[b], st.initial[i % len(st.pairs)],
                            lengths, scores, deadline)
        except ref.OutOfTime:
            p = None
        out.append((p, lengths))
    return out


def check(st: State, run) -> list:
    done = run.done()
    if not done:
        return [("pvalues_answered", 0, -1)]
    n = min(int(run.traffic["check_requests"]), len(done))
    picked = sorted(int(i) for i in traffic.rng_for(run.seed, 9).choice(
        [r["i"] for r in done], size=n, replace=False))
    want = reference(st, picked)
    by_i = {r["i"]: r for r in done}
    bad = sum(not same(by_i[i]["p"], w) for i, (w, _) in zip(picked, want))
    if run.trace:
        work(st, run, {i: lengths for i, (_, lengths) in zip(picked, want)})
    return [("pvalues_wrong", bad, 0)]


def work(st: State, run, known: dict) -> None:
    """The fills' bounds over the window's p-values: each shuffle scored
    once, scores only.  The shuffles' lengths come from each request's
    seeded generator."""
    total = 0.0
    vol = st.matrices[0].shape[0]
    for r in run.done():
        i = r["i"]
        a, b = st.pairs[i % len(st.pairs)]
        lengths = known.get(i)
        if lengths is None:
            _, rng = generator(st, i)
            lengths = [len(ref.shuffle_sequence(st.records[b], rng)) for _ in range(st.n - 1)]
        total += roofline.fill([(len(st.records[a]), int(n)) for n in lengths], "f64",
                               dirs=False, vol=vol)
    run.work["fill_s"] = total


def control(st: State, run, dtype) -> list:
    """The reference with its fill in ``dtype`` in the program's place, on
    the p-values a window answers first.  Its fits on other scores may not
    end: one that runs past a minute gives no number, which fails."""
    picked = list(range(int(run.traffic["check_requests"])))
    got = reference(st, picked, fit_seconds=60.0, dtype=dtype)
    want = reference(st, picked)
    bad = sum(g is None or not same(g, w) for (g, _), (w, _) in zip(got, want))
    return [("pvalues_wrong", bad, 0)]
