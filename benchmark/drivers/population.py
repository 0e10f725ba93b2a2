"""The alignment service's population: one worker computes one task at a
time, ``aligner_tpu_torch.heuristic_align_population`` of a request's
fresh starting matrices on one of the request's pairs, the pairs in turn.

Answers checked: a seeded sample of the tasks answered, every member's
score, coordinates, aligned codes and matrix (or its having no alignment)
against :func:`reference.heuristic.populations`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from harness import roofline, traffic
from reference import heuristic as ref


@dataclasses.dataclass
class State:
    records: list
    pairs: list
    freqs: list
    req: dict
    device: object
    seed: int
    pool: dict


def inputs(run) -> State:
    cfg = run.config
    req = cfg["request"]
    recs = traffic.service_records(cfg)
    pairs = traffic.pairs(recs)
    freqs = [traffic.symbol_frequencies(recs[a], recs[b], req["dimValue"]) for a, b in pairs]
    return State(recs, pairs, freqs, req, run.device, run.seed, run.traffic["pool"])


def setup(run) -> State:
    import aligner_tpu_torch as at

    st = inputs(run)
    req = st.req
    recs, pairs = st.records, st.pairs
    for a, b in pairs:
        at.warmup_population(recs[a], recs[b], req["matricesVolumeValue"], req["delValue"],
                             req["delValue"], device=run.device)
    # one task, so the loop's kernels are loaded before the window
    population(st, *task(st, run.seed, 0))
    return st


def task(st: State, seed: int, i: int) -> tuple[int, np.ndarray]:
    """Task ``i``'s pair and starting matrices: its pair's pool entry."""
    pair, k = traffic.pool_entry(st.pool, seed, i, len(st.pairs))
    return pair, traffic.population(st.req["dimValue"], st.req["matricesVolumeValue"],
                                    traffic.rng_for(int(st.pool["seed"]), 7, pair, k))


def population(st: State, pair: int, mats: np.ndarray):
    import aligner_tpu_torch as at

    a, b = st.pairs[pair]
    req = st.req
    h = at.Heuristics(kd=float(req["kdValue"]), r_squared=float(req["rSquaredValue"]),
                      frequencies=st.freqs[pair])
    return at.heuristic_align_population(st.records[a], st.records[b], mats,
                                         float(req["delValue"]), float(req["delValue"]), h,
                                         device=st.device)


def request(st: State, i: int) -> dict:
    """Task ``i``: its matrices are drawn before its clock starts."""
    pair, mats = task(st, st.seed, i)
    t0 = time.perf_counter()
    res = population(st, pair, mats)
    wall = time.perf_counter() - t0
    return {"pair": pair, "wall": wall, "members": members(res)}


def members(results) -> list:
    out = []
    for r in results:
        if r is None:
            out.append(None)
            continue
        a = r.alignment
        out.append((float(a.f), a.coords, np.array(a.query), np.array(a.target),
                    np.array(r.matrix)))
    return out


def spans(st: State) -> list:
    return [("aligner_tpu_torch.heuristic", "_population_loop", "population.loop"),
            ("aligner_tpu_torch.heuristic", "batch_align", "population.final_alignments"),
            ("aligner_tpu_torch.heuristic", "transform_matrix_torch", "population.transform"),
            ("aligner_tpu_torch.ops.dp_fill", "fill", "population.fill"),
            ("aligner_tpu_torch.ops.device_walk", "walk_counts", "population.counting_walk")]


def _coords(c):
    return tuple(tuple(int(v) for v in p) for p in c)


def wrong_members(got: list, want: list) -> int:
    bad = abs(len(got) - len(want))
    for g, w in zip(got, want):
        if g is None or w is None:
            bad += (g is None) != (w is None)
            continue
        f, coords, qa, ta, m = g
        same = (f == w.f and _coords(coords) == _coords(w.coords)
                and np.array_equal(qa, w.query) and np.array_equal(ta, w.target)
                and np.array_equal(m, w.matrix))
        bad += not same
    return bad


def reference(st: State, seed: int, picked: list, **kw):
    req = st.req
    tasks = []
    for i in picked:
        pair, mats = task(st, seed, i)
        a, b = st.pairs[pair]
        tasks.append((st.records[a], st.records[b], mats, st.freqs[pair]))
    return ref.populations(tasks, float(req["delValue"]), float(req["delValue"]),
                           float(req["kdValue"]), float(req["rSquaredValue"]),
                           device=st.device, **kw)


def check(st: State, run) -> list:
    done = run.done()
    if not done:
        return [("tasks_answered", 0, -1)]
    # the traced run checks every task it traced: their loops give the
    # kernels' work
    n = len(done) if run.trace else min(int(run.traffic["check_requests"]), len(done))
    picked = sorted(int(i) for i in traffic.rng_for(run.seed, 9).choice(
        [r["i"] for r in done], size=n, replace=False))
    want, traces = reference(st, run.seed, picked)
    by_i = {r["i"]: r for r in done}
    bad = sum(wrong_members(by_i[i]["members"], w) for i, w in zip(picked, want))
    work(st, run, picked, want, traces)
    return [("members_wrong", bad, 0)]


def work(st: State, run, picked, want, traces) -> None:
    """The fills' and counting walks' bounds of the tasks checked (in the
    traced run, every task of the window)."""
    vol = st.req["dimValue"]
    fill_s = walk_s = 0.0
    for i, w, tr in zip(picked, want, traces):
        a, b = st.pairs[i % len(st.pairs)]  # task i's pair (the pairs in turn)
        shape = (len(st.records[a]), len(st.records[b]))
        for k, steps, pairs in zip(tr.members_aligned, tr.walk_steps, tr.walk_pairs):
            fill_s += roofline.fill([shape] * k, "f64", dirs=True, vol=vol, matrices=k)
            walk_s += roofline.counting_walk(steps, pairs, k, vol)
        alive = [m for m in w if m is not None]
        if alive:  # the final alignments
            fill_s += roofline.fill([shape] * len(alive), "f64", dirs=True, vol=vol,
                                    matrices=len(alive))
    run.work.update(fill_s=fill_s, walk_s=walk_s)


def as_members(answer: list) -> list:
    return [None if m is None else (m.f, m.coords, m.query, m.target, m.matrix) for m in answer]


def control(st: State, run, dtype) -> list:
    """The reference in ``dtype`` in the program's place, on the tasks a
    window answers first."""
    picked = list(range(int(run.traffic["check_requests"])))
    got, _ = reference(st, run.seed, picked, dtype=dtype)
    want, _ = reference(st, run.seed, picked)
    return [("members_wrong", sum(wrong_members(as_members(g), w) for g, w in zip(got, want)), 0)]
