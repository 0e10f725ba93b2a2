"""Numeric pinning of the port's statistics ML fit, the fit
``aligner-torch-calc`` stores: the mirror of tests/test_statistics_pinned.py
against aligner_tpu_torch/statistics.py (the same interpreter, the same
frozen hex floats).

The production module (aligner_tpu_torch/statistics.py) is a *reorganized*
vectorization of aligner-core/src/statistics/mod.rs; a transcription
error in any of its six documented quirks would previously have passed
the finiteness/monotonicity tests.  These tests close that hole two
ways:

1. bit-for-bit cross-validation against tests/rust_stats_interpreter.py,
   an independent statement-for-statement transcription of mod.rs whose
   control flow mirrors the Rust source line by line (so the same
   transcription error cannot plausibly exist in both); and
2. frozen hex-float fixtures for k, lambda, h and a p-value, one per
   quirk regime (converged fit, truncated MAXITER restart-return,
   negative-log-likelihood instant convergence).

Summation note: both sides use numpy pairwise summation while Rust
ndarray sums sequentially, so values here are shared-bit-exact with each
other, not with a hypothetical Rust run; the quirks pinned are control
flow and expression structure (association order follows mod.rs exactly,
including powi lowering to multiplies).
"""

from __future__ import annotations

import numpy as np
import pytest

import rust_stats_interpreter as R
from aligner_tpu_torch import statistics as S


@pytest.fixture(autouse=True)
def _restore_maxiter():
    old = S.MAXITER
    yield
    S.MAXITER = old


def _dataset(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 400))
    qlen = int(rng.integers(80, 500))
    tl = rng.integers(80, 500, n)
    scores = np.round(rng.gumbel(loc=30, scale=8, size=n), 0)
    return qlen, tl, scores


def _k0_lam0(qlen, tl, scores):
    """The initial (outer, shadowed) estimates of mod.rs:50,57."""
    scores = np.asarray(scores, np.float64)
    var = ((scores - scores.mean()) ** 2).mean()
    lam0 = float(np.float64(1.0) / np.float64(var))
    nn = float(qlen) * np.asarray(tl, np.float64)
    k0 = float(
        np.float64(float(len(tl))) / (nn * np.exp(-lam0 * scores)).sum()
    )
    return k0, lam0


def test_fit_matches_rust_interpreter_bitwise():
    """20 random EVD-like datasets: production == interpreter, bit for
    bit, across every quirk path the datasets happen to exercise."""
    rng = np.random.default_rng(42)
    for _ in range(20):
        n = int(rng.integers(50, 400))
        qlen = int(rng.integers(80, 500))
        tl = rng.integers(80, 500, n)
        scores = np.round(rng.gumbel(loc=30, scale=8, size=n), 0)
        p = S.calculate_distribution_params(qlen, tl, scores)
        ki, li, hi = R.calculate_distribution_params(
            qlen, tl, scores, maxiter=10000
        )
        assert p.k == ki and p.lambda_ == li and p.h == hi


def test_fit_matches_interpreter_truncated_maxiter():
    """Same equivalence with a tiny iteration budget, which drives the
    shadowed-restart + exhaustion-return paths (mod.rs:68-76,122)."""
    S.MAXITER = 3
    for seed in (2026, 7, 99):
        qlen, tl, scores = _dataset(seed)
        p = S.calculate_distribution_params(qlen, tl, scores)
        ki, li, hi = R.calculate_distribution_params(qlen, tl, scores, maxiter=3)
        assert p.k == ki and p.lambda_ == li and p.h == hi


def test_fixture_converged_fit():
    """Frozen values for a 200-sample Gumbel fit.  h == 1.0 pins the
    negative-log-likelihood instant-convergence quirk: the ln-based
    initial likelihood (mod.rs:59) is negative, so the signed relative
    test (mod.rs:99) passes on the first outer iteration and the fit
    returns the first inner (k, lambda) with h untouched."""
    rng = np.random.default_rng(2026)
    n, qlen = 200, 400
    tl = 400 - rng.integers(0, 7, n)
    scores = np.round(rng.gumbel(loc=42, scale=9, size=n), 0)
    p = S.calculate_distribution_params(qlen, tl, scores)
    assert float(p.k).hex() == "0x1.59756076b55ebp-11"
    assert float(p.lambda_).hex() == "0x1.c6b10890f5047p-4"
    assert float(p.h).hex() == "0x1.0000000000000p+0"
    pv = p.get_p_value(qlen, 400, 75.0)
    assert float(pv).hex() == "0x1.93a5b98fee480p-6"
    # and the interpreter's p-value formula agrees exactly
    assert pv == R.get_p_value(p.k, p.lambda_, p.h, qlen, 400, 75.0)


def test_fixture_truncated_restart_return():
    """Frozen values for MAXITER=3 on the same data: the outer loop
    exhausts without converging on this dataset and must return the
    *initial* k0/lambda0 (the immutable outer bindings that the inner
    `let (k, lambda)` shadows, mod.rs:69/122) with the final h."""
    S.MAXITER = 2
    rng = np.random.default_rng(1)
    n = int(rng.integers(20, 120))
    qlen = int(rng.integers(30, 300))
    tl = rng.integers(30, 300, n)
    scores = np.round(
        rng.gumbel(loc=rng.uniform(5, 50), scale=rng.uniform(1, 12), size=n), 0
    )
    p = S.calculate_distribution_params(qlen, tl, scores)
    k0, lam0 = _k0_lam0(qlen, tl, scores)
    assert p.k == k0 and p.lambda_ == lam0  # restart quirk, exactly
    assert p.h != 1.0  # ...but h kept its progress
    assert float(p.h).hex() == "0x1.a8abc7fb6b724p-2"


def test_inner_estimators_match_interpreter():
    """Unit-level equivalence of the Newton/fixed-point and step-search
    estimators on shared inputs (mod.rs:125-189, 191-238)."""
    qlen, tl, scores = _dataset(11)
    tlf = np.asarray(tl, np.float64)
    sc = np.asarray(scores, np.float64)
    k0, lam0 = _k0_lam0(qlen, tl, scores)
    kp, lp = S._estimate_k_and_lambda(float(qlen), tlf, sc, k0, lam0, 1.0)
    ki, li = R.estimate_k_and_lambda_by_parameters(
        qlen, tl, sc, k0, lam0, 1.0, 10000
    )
    assert kp == ki and lp == li
    hp = S._estimate_h(float(qlen), tlf, sc, kp, lp, 1.0)
    hi = R.estimate_h_by_parameters(qlen, tl, sc, kp, lp, 1.0, 10000)
    assert hp == hi


def test_native_h_matches_python_loop():
    """The compiled h-search (native.an_estimate_h: numpy-pairwise sums,
    -ffp-contract=off) is bit-identical to the Python oracle loop across
    regimes (converging, non-converging, halving-heavy, NaN)."""
    from aligner_tpu_torch import native

    if not native.available():
        pytest.skip("native ext unavailable")
    assert S._native_h_ok()  # the first-use self-check itself
    rng0 = np.random.default_rng(77)
    for trial in range(40):
        rng = np.random.default_rng(trial)
        n = int(rng0.integers(1, 700))
        qlen = float(rng0.integers(50, 1200))
        tl = np.asarray(rng0.integers(50, 1200) - rng.integers(0, 7, n), np.float64)
        scores = np.round(
            rng.gumbel(rng0.uniform(2, 150), rng0.uniform(0.5, 40), n), 0
        )
        k = float(10.0 ** rng0.uniform(-8, 3))
        lam = float(10.0 ** rng0.uniform(-4, 2))
        h0 = float(rng0.uniform(0.05, 5))
        mi = int(rng0.integers(1, 500))
        with np.errstate(all="ignore"):
            log_kqt = np.log(k * qlen * tl)
            kexp = k * np.exp(-lam * scores)
        a = native.estimate_h(log_kqt, kexp, tl, qlen, h0, mi,
                              S.THRESHOLD_LOCAL)
        b = S._estimate_h_loop(log_kqt, kexp, tl, qlen, h0, mi)
        assert a == b or (np.isnan(a) and np.isnan(b))


def test_stationary_shortcut_equals_exhausted_loop():
    """The outer-loop stationarity early-exit returns EXACTLY what the
    full MAXITER exhaustion would (the interpreter runs the loop in
    full): the common real-workload regime where the fit walks into
    h = NaN and freezes burns 10001 iterations in the reference but
    must produce the same (k0, lam0, h)."""
    S.MAXITER = 400  # enough for the interpreter to run honestly
    rng = np.random.default_rng(70)
    n = 400
    tl = 400 - rng.integers(0, 7, n)
    # heavy-tailed scores drive the NaN-freeze (observed on real
    # shuffled-alignment score sets for most seeds)
    scores = np.round(rng.gumbel(loc=110.5, scale=3.7, size=n), 0)

    calls = {"n": 0}
    orig = S._estimate_k_and_lambda

    def counting(*a):
        calls["n"] += 1
        return orig(*a)

    S._estimate_k_and_lambda = counting
    try:
        p = S.calculate_distribution_params(400, tl, scores)
    finally:
        S._estimate_k_and_lambda = orig
    ki, li, hi = R.calculate_distribution_params(400, tl, scores, maxiter=400)
    assert p.k == ki and p.lambda_ == li
    assert p.h == hi or (np.isnan(p.h) and np.isnan(hi))
    # and the shortcut actually fired (far fewer than 401 iterations)
    assert calls["n"] < 50
