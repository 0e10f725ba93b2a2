"""Each cell run at a small size on the CPU, past the harness's look for a
card: sound, it is correct; with the program broken underneath in each way
the cell can be, it is not; and its control (the reference one precision
lower in the program's place) fails its comparison."""

import contextlib

import numpy as np
import pytest
import torch

import control
import run as R


@contextlib.contextmanager
def patched(module, attr, make):
    old = getattr(module, attr)
    setattr(module, attr, make(old))
    try:
        yield
    finally:
        setattr(module, attr, old)


def _run(cell, small, seed=3):
    return R.run_cell(cell, seed, 0.6, False, torch.device("cpu"), **small(cell))


def _search_altered(old):
    def f(*a, **kw):
        res = old(*a, **kw)
        if not kw.get("with_alignments") and len(res.fmax) > 1:
            res.fmax[-1] += 1  # one database score, altered where it is made
        return res
    return f


def _search_half(old):
    def f(queries, targets, *a, **kw):
        if kw.get("with_alignments"):
            return old(queries, targets, *a, **kw)
        n = (len(targets) + 1) // 2  # half the bucket scored, the rest copies
        res = old(queries[:n], targets[:n], *a, **kw)
        for name in ("fmax", "fy", "fx", "end"):
            v = getattr(res, name)
            setattr(res, name, np.resize(v, len(targets)))
        return res
    return f


def _search_answer(old):
    def f(*a, **kw):
        hits = old(*a, **kw)
        hits[0].score += 1.0
        return hits
    return f


def _pop_unchanged(old):
    def f(q2, ql0, t2, tl0, state, *a, **kw):
        return None  # the loop returns its state as it got it
    return f


def _pop_half(old):
    def f(q, ql, t, tl, *a, **kw):
        ql = ql.clone()
        ql[ql.shape[0] // 2:] = 0  # half of the members left out of the fill
        return old(q, ql, t, tl, *a, **kw)
    return f


def _pop_answer(old):
    def f(*a, **kw):
        out = old(*a, **kw)
        out[0] = out[0].clone()
        out[0][0, 0] = torch.nextafter(out[0][0, 0], out[0][0, 0] + 1)
        return out
    return f


def _pv_half(old):
    def f(queries, targets, *a, **kw):
        n = len(targets) // 2
        res = old(queries[:n], targets[:n], *a, **kw)
        res.fmax = np.resize(res.fmax, len(targets))
        return res
    return f


def _pv_answer(old):
    def f(*a, **kw):
        p = old(*a, **kw)  # the p-value, altered where it is computed
        return 1.0 if np.isnan(p) else float(np.nextafter(p, 2.0))
    return f


def test_sound_runs_are_correct(small):
    for cell in ("search.long-queries", "service.population", "service.pvalue"):
        run = _run(cell, small)
        assert run.correct(), (cell, run.checks)


@pytest.mark.parametrize("cell,target,make", [
    ("search.long-queries", ("aligner_tpu_torch.search", "batch_align"), _search_altered),
    ("search.long-queries", ("aligner_tpu_torch.search", "batch_align"), _search_half),
    ("search.long-queries", ("aligner_tpu_torch.search", "search_database"), _search_answer),
    ("service.population", ("aligner_tpu_torch.heuristic", "_population_loop"), _pop_unchanged),
    ("service.population", ("aligner_tpu_torch.ops.dp_fill", "fill"), _pop_half),
    ("service.population", ("aligner_tpu_torch.heuristic", "transform_matrix_torch"),
     _pop_answer),
    ("service.pvalue", ("aligner_tpu_torch.statistics", "batch_align"), _pv_half),
    ("service.pvalue", ("aligner_tpu_torch.statistics", "DistributionParams.get_p_value"),
     _pv_answer),
], ids=["search-score-altered", "search-half-the-database", "search-hit-altered",
        "population-state-unchanged", "population-half-the-members",
        "population-matrix-altered", "pvalue-half-the-shuffles", "pvalue-altered"])
def test_a_broken_program_is_not_correct(cell, target, make, small):
    import importlib

    owner = importlib.import_module(target[0])
    *outer, attr = target[1].split(".")
    for name in outer:
        owner = getattr(owner, name)
    with patched(owner, attr, make):
        run = _run(cell, small)
    assert not run.correct(), (cell, run.checks)


@pytest.mark.parametrize("cell", ["search.long-queries", "service.population", "service.pvalue"])
def test_the_control_fails_the_comparison(cell, small):
    kw = small(cell)
    if cell.startswith("search"):
        # homologs long enough to score past bfloat16's exact integers (256)
        kw["traffic_overrides"] = {"queries": {"lengths": [300, 260]}, "check_requests": 2}
    checks = control.control_checks(cell, 11, torch.device("cpu"), **kw)
    assert any(v > lim for _, v, lim in checks), checks
