"""The reference's p-value, in plain NumPy and the plain fill of
:mod:`reference.fill`.

Frozen copies (from ``aligner_tpu_torch/statistics.py``, itself a
transcription of aligner-core ``statistics/mod.rs:23-320``) of the shuffle
rule, the maximum-likelihood fit of (k, λ, h) with the reference's quirks,
and the p-value.  The h-search runs as its Python loop; the stationary
early exit of the outer loop returns what the full loop would, bit for bit
(its state repeats exactly, so every later iteration repeats it).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .fill import local_fill, pad

MAXITER = 10000
THRESHOLD_GLOBAL = 1e-6
THRESHOLD_LOCAL = 1e-4


def shuffle_sequence(seq: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A shuffled copy with a random 0..=6-character tail dropped
    (statistics/mod.rs:309-320): one draw of the tail, then the shuffle."""
    lock = int(rng.integers(0, 7))
    out = np.array(seq[: len(seq) - lock])
    rng.shuffle(out)
    return out


def _nn_edge(k, h, qlen, tl):
    l = np.log(k * qlen * tl) / h
    return (qlen - l) * (tl - l)


def _estimate_k_and_lambda(qlen, tl, scores, old_k, old_lambda, h):
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
            wss = ws / s
            lam_fd = (
                -(np.float64(1.0) / (lam * lam))
                - (nn * scores_sq * e).sum() / s
                + wss * wss
            )
            if not (np.isfinite(lam_f) and np.isfinite(lam_fd)):
                return float(k), float(lam)
            new_lam = lam - lam_f / lam_fd
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


class OutOfTime(RuntimeError):
    """The fit passed its deadline (a control's fit may not end in time)."""


def _estimate_h(qlen, tl, scores, k, lam, h, deadline=None):
    with np.errstate(all="ignore"):
        log_kqt = np.log(k * qlen * tl)
        kexp = k * np.exp(-lam * scores)
    for step in range(MAXITER + 1):
        if deadline is not None and step % 1000 == 0 and time.monotonic() > deadline:
            raise OutOfTime("the h-search passed its deadline")
        with np.errstate(all="ignore"):
            l = log_kqt / h
            nn = (qlen - l) * (tl - l)
            a = 2.0 * l - qlen - tl
            b = 1.0 / nn - kexp
            c = -l / h
            h_g = (a * b * c).sum()
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


def fit(query_length: int, target_lengths, scores,
        deadline: float | None = None) -> tuple[float, float, float]:
    """(k, λ, h) by the reference's ML fit (statistics/mod.rs:36-123);
    :class:`OutOfTime` past ``deadline`` (``time.monotonic()``), if given."""
    tl = np.asarray(target_lengths, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    var = float(((scores - scores.mean()) ** 2).mean())
    if not np.isfinite(var):
        raise ValueError("degenerate score distribution")
    with np.errstate(all="ignore"):
        lam0 = float(np.float64(1.0) / np.float64(var))
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
    active_tl, active_scores = tl.copy(), scores.copy()
    prev = None
    for _ in range(MAXITER + 1):
        # k and λ restart from (k0, λ0) every iteration (the reference's
        # shadowed bindings); only h and the active set carry over
        k, lam = _estimate_k_and_lambda(qlen, active_tl, active_scores, k0, lam0, h)
        h = _estimate_h(qlen, active_tl, active_scores, k, lam, h, deadline)
        with np.errstate(all="ignore"):
            nn = _nn_edge(k, h, qlen, tl)
            ll_new = float(
                n * np.log10(lam * k)
                + (np.log10(nn) - lam * scores - k * nn * np.exp(-lam * scores)).sum()
            )
            rel = np.float64(abs(ll_new - log_likelihood)) / np.float64(log_likelihood)
        if rel < THRESHOLD_GLOBAL:
            return k, lam, h
        log_likelihood = ll_new
        with np.errstate(all="ignore"):
            keep = n * (1.0 - np.exp(-k * nn * np.exp(-lam * scores))) >= 1.0
        sig = tuple(np.float64(v).tobytes() for v in (k, lam, h, ll_new)) + (keep.tobytes(),)
        if sig == prev:
            return k0, lam0, h  # the state repeats: the loop would run out
        prev = sig
        active_tl, active_scores = tl[keep], scores[keep]
    return k0, lam0, h


def p_value_of(k: float, lam: float, h: float, qlen: int, tlen: int, score: float) -> float:
    """p = 1 - exp(-k·n'·exp(-λ·S)), n' edge-corrected (statistics/mod.rs:23-33)."""
    l = np.log(k * qlen * tlen) / h
    nn = (qlen - l) * (tlen - l)
    return float(1.0 - np.exp(-k * nn * np.exp(-lam * score)))


def shuffled_scores_many(items, del_, ins, n_sequences, *, device, dtype=torch.float64):
    """For each (query, target, matrix, seeded rng) of ``items``: the
    ``n_sequences - 1`` shuffles of the target that the p-value draws from
    the rng (statistics/mod.rs:263-266), and their local scores against the
    query, all in one batch.  Returns (lengths, scores) per item."""
    per = n_sequences - 1
    qs, ts, mats = [], [], []
    for q, t, matrix, rng in items:
        for _ in range(per):
            ts.append(shuffle_sequence(t, rng))
            qs.append(q)
        mats.append(np.asarray(matrix, np.float64))
    qd, qld = pad(qs, device)
    td, tld = pad(ts, device)
    m = torch.as_tensor(np.repeat(np.stack(mats), per, axis=0), device=device)
    f = local_fill(qd, qld, td, tld, m, del_, ins, dtype=dtype).f.to(torch.float64).cpu().numpy()
    lens = np.array([len(s) for s in ts])
    return [(lens[k * per:(k + 1) * per], f[k * per:(k + 1) * per]) for k in range(len(items))]


def p_value(q, t, initial_score, lengths, scores, deadline=None) -> float:
    """The p-value from the shuffles' lengths and scores (the initial
    alignment first, as statistics/mod.rs:253-291 gathers them)."""
    all_scores = np.concatenate([[initial_score], scores])
    all_lengths = np.concatenate([[len(t)], lengths])
    k, lam, h = fit(len(q), all_lengths, all_scores, deadline)
    return p_value_of(k, lam, h, len(q), len(t), initial_score)
