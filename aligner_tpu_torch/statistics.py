"""Karlin-Altschul-style score statistics and p-values.

Faithful transcription of aligner-core/src/statistics/mod.rs with the
5,000-shuffle score generation batched onto the device (one scores-only
kernel launch replaces the reference's 10-OS-thread fan-out,
statistics/mod.rs:253-291).  Counterpart of ``aligner_tpu.statistics``:
the shuffles stay on numpy's generator and the fit stays numpy plus the
native h-search, so one seed gives the same p-value in both packages.

Reproduced quirks (load-bearing for output parity):

* the outer ML loop *shadows* k and lambda — every outer iteration
  restarts the Newton/fixed-point estimate from the initial
  ``k0 = n/Σ(nn·e)``, ``λ0 = 1/variance``; only ``h`` and the active
  (outlier-filtered) arrays persist (statistics/mod.rs:69-80 ``let (k,
  lambda) = ...`` inside the loop);
* after MAXITER outer iterations the *initial* k and λ are returned with
  the final h (statistics/mod.rs:122);
* the initial log-likelihood uses ``ln`` while the in-loop one uses
  ``log10`` (statistics/mod.rs:59,93);
* inside the Newton iteration the exponential sums are recomputed with
  the not-yet-updated λ, so each step's f/fd uses one-step-stale sums
  (statistics/mod.rs:160-166);
* the thread-quota quirk: thread 5 runs 499 alignments instead of 500,
  so exactly 5,000 scores including the initial one
  (statistics/mod.rs:263-266);
* each shuffle drops a random 0..=6-character tail before permuting
  (statistics/mod.rs:309-320).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .align import batch_align
from .alphabet import Alphabet, Protein
from .errors import ValidationError

MAXITER = 10000
THREADS = 10
SEQUENCES = 5000
THRESHOLD_GLOBAL = 1e-6
THRESHOLD_LOCAL = 1e-4


@dataclasses.dataclass
class DistributionParams:
    k: float
    lambda_: float
    h: float

    def get_p_value(self, query_length: int, target_length: int, score: float) -> float:
        """p = 1 - exp(-k·n'·exp(-λ·S)) with edge-corrected n'
        (statistics/mod.rs:23-33)."""
        l = np.log(self.k * query_length * target_length) / self.h
        nn = (query_length - l) * (target_length - l)
        return float(1.0 - np.exp(-self.k * nn * np.exp(-self.lambda_ * score)))


def _nn_edge(k: float, h: float, qlen: float, tl: np.ndarray) -> np.ndarray:
    l = np.log(k * qlen * tl) / h
    return (qlen - l) * (tl - l)


def _estimate_k_and_lambda(qlen, tl, scores, old_k, old_lambda, h):
    """Newton on λ + fixed-point k (statistics/mod.rs:125-189).

    All scalars are np.float64 so division by zero yields ±inf like Rust
    f64 (caught by the is_finite guards) instead of raising."""
    k, lam = np.float64(old_k), np.float64(old_lambda)
    n = np.float64(len(tl))
    with np.errstate(all="ignore"):
        nn = _nn_edge(k, h, qlen, tl)
        e = np.exp(-lam * scores)
        s = (nn * e).sum()
        ws = (nn * scores * e).sum()
        ssum = scores.sum()
        scores_sq = scores * scores
        for _ in range(MAXITER + 1):
            lam_f = np.float64(1.0) / lam - ssum / n + ws / s
            # association follows mod.rs:150-152 exactly: powi(-2) is
            # 1/(λ·λ), the middle term groups nn·(s²)·e, and powi(2) is
            # u·u — ULP-identical to the Rust expression tree
            wss = ws / s
            lam_fd = (
                -(np.float64(1.0) / (lam * lam))
                - (nn * scores_sq * e).sum() / s
                + wss * wss
            )
            if not (np.isfinite(lam_f) and np.isfinite(lam_fd)):
                return float(k), float(lam)
            new_lam = lam - lam_f / lam_fd
            # recomputed with the *old* λ — one-step-stale by construction
            e = np.exp(-lam * scores)
            s = (nn * e).sum()
            ws = (nn * scores * e).sum()
            new_k = n / s
            if not np.isfinite(new_k) or new_k <= 0.0:
                return float(k), float(lam)
            k, lam = new_k, new_lam
            if abs(lam_f) < THRESHOLD_LOCAL:
                return float(k), float(lam)
            nn = _nn_edge(k, h, qlen, tl)
    return float(k), float(lam)


def _estimate_h_loop(log_kqt, kexp, tl, qlen, h, maxiter):
    """The h-search loop body as the pure-Python semantics oracle
    (statistics/mod.rs:191-238; see :func:`_estimate_h`)."""
    for _ in range(maxiter + 1):
        with np.errstate(all="ignore"):
            l = log_kqt / h
            nn = (qlen - l) * (tl - l)
            a = 2.0 * l - qlen - tl
            b = 1.0 / nn - kexp
            c = -l / h
            h_g = (a * b * c).sum()
            # association follows mod.rs:213-216 exactly: (2·b)·(c²),
            # (a·c/nn) squared by self-multiplication, ((2·a)·b·c)/h
            u = a * c / nn
            h_gd = (2.0 * b * (c * c) - u * u - 2.0 * a * b * c / h).sum()
        if abs(h_g) < THRESHOLD_LOCAL:
            return float(h)
        if h_gd > 0.0:
            h = h * 2.0 if h_g > 0.0 else h / 2.0
        elif h_g <= 0.0:
            h = h / 2.0
        else:
            with np.errstate(all="ignore"):
                h = h - h_g / h_gd
    return float(h)


_NATIVE_H: bool | None = None  # None = not yet self-checked


def _native_h_ok() -> bool:
    """One-time bitwise self-check of the compiled h-search against the
    Python loop.  The native path replays the same expression structure
    with numpy-pairwise sums and FMA contraction disabled, so it SHOULD
    be bit-identical on any IEEE-754 platform; this probe proves it on
    the running one (three regimes: converging, slow-diverging, and a
    step-halving-heavy search) and falls back permanently if not."""
    global _NATIVE_H
    if _NATIVE_H is None:
        from . import native

        if not native.available():
            _NATIVE_H = False
            return False
        rng = np.random.default_rng(12345)
        qlen = 400.0
        ok = True
        # probe several array LENGTHS, not just a multiple of 8: the
        # outlier filter shrinks the active set to arbitrary sizes, and
        # the pairwise-sum transcription's remainder/tail handling is
        # exactly the code a power-of-two-only probe cannot reach
        for n in (160, 157, 5):
            tl = np.asarray(400 - rng.integers(0, 7, n), np.float64)
            scores = np.round(rng.gumbel(30.0, 8.0, n), 0)
            for k, lam, h0 in (
                (2e-3, 0.25, 1.0),       # converges
                (1.39e-5, 7.55e-3, 1.0),  # slow non-converging regime
                (0.5, 4.5, 0.3),          # halving/doubling-heavy
            ):
                with np.errstate(all="ignore"):
                    log_kqt = np.log(k * qlen * tl)
                    kexp = k * np.exp(-lam * scores)
                a = native.estimate_h(log_kqt, kexp, tl, qlen, h0, 600,
                                      THRESHOLD_LOCAL)
                b = _estimate_h_loop(log_kqt, kexp, tl, qlen, h0, 600)
                if not (a == b or (np.isnan(a) and np.isnan(b))):
                    ok = False
                    break
            if not ok:
                break
        _NATIVE_H = ok
    return _NATIVE_H


def _estimate_h(qlen, tl, scores, k, lam, old_h):
    """Step-halving/doubling search on h (statistics/mod.rs:191-238).

    Only ``h`` changes across iterations, so the two transcendental
    arrays — ``log(k·qlen·tl)`` and ``k·exp(-lam·scores)`` — are hoisted
    out of the loop verbatim (same expressions, same association:
    bit-identical results, pinned by test_statistics_pinned).  The loop
    itself — the measured cost center: a non-converging search burns the
    reference's full MAXITER=10000 iterations, compiled in Rust but
    interpreted here — runs in the native C++ ext (an_estimate_h) when
    the one-time bitwise self-check passes, else in the Python oracle
    loop.  Both paths are pinned bit-identical by test_statistics_pinned.
    """
    with np.errstate(all="ignore"):
        log_kqt = np.log(k * qlen * tl)
        kexp = k * np.exp(-lam * scores)
    if _native_h_ok():
        from . import native

        return native.estimate_h(
            log_kqt, kexp, tl, qlen, old_h, MAXITER, THRESHOLD_LOCAL
        )
    return _estimate_h_loop(log_kqt, kexp, tl, qlen, old_h, MAXITER)


def calculate_distribution_params(
    query_length: int, target_lengths: np.ndarray, scores: np.ndarray
) -> DistributionParams:
    """ML fit of (k, λ, h) (statistics/mod.rs:36-123)."""
    tl = np.asarray(target_lengths, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if len(scores) != len(tl):
        raise ValidationError("scores and target_lengths length mismatch")

    var = float(((scores - scores.mean()) ** 2).mean())  # central_moment(2)
    if not np.isfinite(var):
        raise ValidationError("degenerate score distribution")
    with np.errstate(all="ignore"):
        lam0 = float(np.float64(1.0) / np.float64(var))  # inf when var == 0, like Rust
    h = 1.0
    qlen = float(query_length)
    n = float(len(tl))

    with np.errstate(all="ignore"):
        nn = qlen * tl
        k0 = float(np.float64(n) / (nn * np.exp(-lam0 * scores)).sum())
        log_likelihood = float(
            n * np.log(lam0 * k0)
            + (np.log(nn) - lam0 * scores - k0 * nn * np.exp(-lam0 * scores)).sum()
        )

    active_tl = tl.copy()
    active_scores = scores.copy()

    # Exact early-exit for stationary non-convergence: the loop body is
    # a pure function of (h, log_likelihood, active set) — the k/λ
    # estimate restarts from the constant (k0, lam0) every iteration
    # (the shadowing quirk) and tl/scores never change.  If one
    # iteration reproduces its own input state BIT FOR BIT, every later
    # iteration must repeat it too, so the loop provably runs to
    # MAXITER and returns (k0, lam0, h) — which we can do immediately.
    # This is the common regime on real score sets (the fit walks into
    # h = NaN, the outlier filter empties the active set, and the state
    # freezes; measured 6/8 real-shuffle seeds burn all 10001
    # iterations this way).  Bit-identical by construction and pinned
    # by test_statistics_pinned against the full-loop interpreter.
    def _state_sig(k, lam, h, ll, keep):
        return (
            np.float64(k).tobytes(), np.float64(lam).tobytes(),
            np.float64(h).tobytes(), np.float64(ll).tobytes(),
            keep.tobytes(),
        )

    prev_sig = None
    for _ in range(MAXITER + 1):
        # NOTE: restarts from (k0, lam0) each outer iteration — the Rust
        # `let (k, lambda)` shadows the outer immutable bindings.
        k, lam = _estimate_k_and_lambda(qlen, active_tl, active_scores, k0, lam0, h)
        h = _estimate_h(qlen, active_tl, active_scores, k, lam, h)

        with np.errstate(all="ignore"):
            nn = _nn_edge(k, h, qlen, tl)
            ll_new = float(
                n * np.log10(lam * k)
                + (
                    np.log10(nn)
                    - lam * scores
                    - k * nn * np.exp(-lam * scores)
                ).sum()
            )
        with np.errstate(all="ignore"):
            rel = np.float64(abs(ll_new - log_likelihood)) / np.float64(log_likelihood)
        if rel < THRESHOLD_GLOBAL:
            return DistributionParams(k, lam, h)
        log_likelihood = ll_new

        with np.errstate(all="ignore"):
            keep = n * (1.0 - np.exp(-k * nn * np.exp(-lam * scores))) >= 1.0
        sig = _state_sig(k, lam, h, ll_new, keep)
        if sig == prev_sig:
            return DistributionParams(k0, lam0, h)  # provably exhausts
        prev_sig = sig
        active_tl = tl[keep]
        active_scores = scores[keep]

    return DistributionParams(k0, lam0, h)


def shuffle_and_randomize_sequence(seq: np.ndarray, rng: np.random.Generator):
    """Shuffled copy with a random 0..=6-char tail dropped
    (statistics/mod.rs:309-320).

    Sequences shorter than 7 are rejected: the reference's usize
    ``len - lock`` panics whenever lock > len (and a lock == len draw
    would score an empty shuffle), so over thousands of shuffles a <7
    target crashes it with certainty — raising deterministically beats
    Python's silent negative-slice wrap, which would quietly feed
    wrong-length shuffles into the fit."""
    if len(seq) < 7:
        raise ValidationError(
            "shuffle tail drop needs len(seq) >= 7 (a 0..=6-char tail "
            "is removed, statistics/mod.rs:309-320)"
        )
    lock = int(rng.integers(0, 7))
    out = np.array(seq[: len(seq) - lock])
    rng.shuffle(out)
    return out


def calculate_p_value(
    query,
    target,
    initial_score: float,
    del_: float,
    ins: float,
    matrix: np.ndarray,
    *,
    alphabet: type[Alphabet] = Protein,
    rng: np.random.Generator | None = None,
    device=None,
    n_sequences: int = SEQUENCES,
) -> float:
    """End-to-end p-value (statistics/mod.rs:240-307).

    The 4,999 shuffled local alignments run as one batched scores-only
    launch.  Unlike the reference (unseeded thread_rng), pass ``rng`` for
    reproducibility.
    """
    from .align import _encode

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    rng = rng or np.random.default_rng()

    if n_sequences < 2:
        raise ValidationError(
            "calculate_p_value needs n_sequences >= 2 — the fit runs "
            "over n-1 shuffled alignments (statistics/mod.rs:263-266)"
        )
    # thread-quota quirk (9 full quotas + thread 5 short by 1,
    # mod.rs:263-266) telescopes to exactly n - 1 shuffles for every n
    total = n_sequences - 1

    shuffles = [shuffle_and_randomize_sequence(t, rng) for _ in range(total)]
    res = batch_align(
        [q] * total, shuffles, matrix, del_, ins,
        mode="local", alphabet=alphabet, device=device,
        track_argmax=False,  # only f is consumed — skip argmax bookkeeping
    )
    scores = np.concatenate([[initial_score], np.asarray(res.fmax, np.float64)])
    lengths = np.concatenate([[len(t)], [len(s) for s in shuffles]])

    params = calculate_distribution_params(len(q), lengths, scores)
    return params.get_p_value(len(q), len(t), initial_score)
