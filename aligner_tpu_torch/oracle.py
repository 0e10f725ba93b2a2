"""Scalar reference engine ("oracle") — exact transcription of the
reference DP semantics in NumPy float64.

This module is the framework's ground truth: the Pallas kernels, the XLA
fallback and the C++ native engine are all validated against it, and it is
validated against the golden fixtures from the reference repository.

Semantics reproduced (see SURVEY.md §2.3 for the full contract):

* Column-major fill: outer loop over the DP *columns* (query for the simple
  aligners, PWM positions for the PWM aligner), inner loop over rows
  (aligner-core/src/simple/mod.rs:74-97, pwm/mod.rs:54-74).
* Single mutable gap-penalty state: ``penalty`` starts at ``del`` and after
  every cell becomes ``ext`` unless that cell's direction was ``Beginning``
  (simple/mod.rs:72,88-92).  This couples each cell to its fill-order
  predecessor; in global mode only cell (1,1) ever uses ``del``.
* Tie-breaking top > left > diagonal with f64-epsilon compare
  (enums.rs:18-46); in local/PWM mode ``max == 0`` exactly yields
  ``Beginning`` (no clamping — scores may go negative).
* Global border init ``-(i)*del`` with the two far corner cells overwritten
  by ``-(len+1)*del`` (simple/mod.rs:59-70).
* Local argmax = first maximum in row-major order over the full (rows+1,
  cols+1) plane including borders (ndarray QuantileExt::argmax,
  simple/mod.rs:212).
* Traceback seeding: local seeds with the characters at the argmax cell,
  global with the last characters of both sequences; the PWM walk seeds
  nothing (simple/mod.rs:99-106,213-218; pwm/mod.rs:77-79).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import BLANK
from .errors import ResultIsEmpty

# Direction codes — match the Rust enum discriminants (enums.rs:9-15).
TOP = 0
LEFT = 1
DIAG = 2
BEG = 3

_EPS = float(np.finfo(np.float64).eps)


def _direction(top: float, left: float, diagonal: float) -> tuple[float, int]:
    """Max of three with tie priority top > left > diagonal (enums.rs:18-28)."""
    m = max(top, left, diagonal)
    if abs(m - top) < _EPS:
        return m, TOP
    if abs(m - left) < _EPS:
        return m, LEFT
    return m, DIAG


def _direction_with_beginning(
    top: float, left: float, diagonal: float
) -> tuple[float, int]:
    """Same, but an exact zero maximum maps to Beginning (enums.rs:30-46)."""
    m = max(top, left, diagonal)
    if m == 0.0:
        return m, BEG
    if abs(m - top) < _EPS:
        return m, TOP
    if abs(m - left) < _EPS:
        return m, LEFT
    return m, DIAG


@dataclasses.dataclass
class OracleResult:
    """Full DP result: planes + traceback, mirroring AlignmentResult
    (aligner-core/src/alignment_result.rs:7-13)."""

    score: np.ndarray  # (rows+1, cols+1) float64
    directions: np.ndarray  # (rows+1, cols+1) uint8
    query_aligned: np.ndarray  # int16 codes incl. BLANK
    target_aligned: np.ndarray  # int16 codes incl. BLANK (PWM: int32 numbered, 0=gap)
    coords: tuple[tuple[int, int], tuple[int, int]]
    f: float


def fill_local(
    query: np.ndarray, target: np.ndarray, matrix: np.ndarray, del_: float, ext: float
) -> tuple[np.ndarray, np.ndarray]:
    """Local (SW-style) fill (simple/mod.rs:179-210).

    Plane dims (len(target)+1, len(query)+1); columns = query positions.
    """
    q = np.asarray(query, dtype=np.int64)
    t = np.asarray(target, dtype=np.int64)
    rows, cols = len(t), len(q)
    a = np.zeros((rows + 1, cols + 1), dtype=np.float64)
    d = np.full((rows + 1, cols + 1), BEG, dtype=np.uint8)
    pen = del_
    for x in range(1, cols + 1):
        qc = q[x - 1]
        for y in range(1, rows + 1):
            s = matrix[t[y - 1], qc]
            v, dr = _direction_with_beginning(
                a[y - 1, x] - pen, a[y, x - 1] - pen, a[y - 1, x - 1] + s
            )
            pen = ext if dr != BEG else del_
            a[y, x] = v
            d[y, x] = dr
    return a, d


def fill_global(
    query: np.ndarray, target: np.ndarray, matrix: np.ndarray, del_: float, ext: float
) -> tuple[np.ndarray, np.ndarray]:
    """Global (NW-style) fill with the reference's border quirk
    (simple/mod.rs:53-97)."""
    q = np.asarray(query, dtype=np.int64)
    t = np.asarray(target, dtype=np.int64)
    rows, cols = len(t), len(q)
    a = np.zeros((rows + 1, cols + 1), dtype=np.float64)
    d = np.full((rows + 1, cols + 1), BEG, dtype=np.uint8)
    for x in range(1, cols + 1):
        a[0, x] = -float(x) * del_
        d[0, x] = LEFT
    for y in range(1, rows + 1):
        a[y, 0] = -float(y) * del_
        d[y, 0] = TOP
    # far-corner overwrite (simple/mod.rs:69-70)
    a[0, cols] = -(cols + 1.0) * del_
    a[rows, 0] = -(rows + 1.0) * del_

    pen = del_
    for x in range(1, cols + 1):
        qc = q[x - 1]
        for y in range(1, rows + 1):
            s = matrix[t[y - 1], qc]
            v, dr = _direction(
                a[y - 1, x] - pen, a[y, x - 1] - pen, a[y - 1, x - 1] + s
            )
            pen = ext if dr != BEG else del_  # never BEG → always ext after (1,1)
            a[y, x] = v
            d[y, x] = dr
    return a, d


def fill_pwm(
    query: np.ndarray, pwm: np.ndarray, del_: float, ext: float
) -> tuple[np.ndarray, np.ndarray]:
    """PWM fill (pwm/mod.rs:44-74): plane dims (len(query)+1, W+1),
    columns = PWM positions, score = pwm[query_char, col-1]."""
    q = np.asarray(query, dtype=np.int64)
    rows, cols = len(q), pwm.shape[1]
    a = np.zeros((rows + 1, cols + 1), dtype=np.float64)
    d = np.full((rows + 1, cols + 1), BEG, dtype=np.uint8)
    pen = del_
    for x in range(1, cols + 1):
        for y in range(1, rows + 1):
            s = pwm[q[y - 1], x - 1]
            v, dr = _direction_with_beginning(
                a[y - 1, x] - pen, a[y, x - 1] - pen, a[y - 1, x - 1] + s
            )
            pen = ext if dr != BEG else del_
            a[y, x] = v
            d[y, x] = dr
    return a, d


def argmax_first_rowmajor(a: np.ndarray) -> tuple[int, int]:
    """First maximum in row-major order (ndarray QuantileExt::argmax)."""
    flat = int(np.argmax(a))
    return flat // a.shape[1], flat % a.shape[1]


def _walk(
    d: np.ndarray,
    cy: int,
    cx: int,
    query: np.ndarray,
    target: np.ndarray | None,
    qa: list[int],
    ta: list[int],
    pwm_mode: bool,
) -> tuple[int, int]:
    """Shared traceback walk (simple/mod.rs:107-127/220-242, pwm:81-103).

    In pwm_mode the roles are: rows = query, cols = numbered positions;
    ``ta`` receives numbered positions (0 = gap), ``qa`` query codes.
    """
    while True:
        dr = d[cy, cx]
        if dr == BEG:
            break
        if dr == TOP:
            if pwm_mode:
                ta.append(0)
                qa.append(int(query[cy - 1]))
            else:
                qa.append(BLANK)
                ta.append(int(target[cy - 1]))
            cy -= 1
        elif dr == LEFT:
            if pwm_mode:
                ta.append(cx)
                qa.append(BLANK)
            else:
                qa.append(int(query[cx - 1]))
                ta.append(BLANK)
            cx -= 1
        else:  # DIAG
            if pwm_mode:
                ta.append(cx)
                qa.append(int(query[cy - 1]))
            else:
                qa.append(int(query[cx - 1]))
                ta.append(int(target[cy - 1]))
            cx -= 1
            cy -= 1
    return cy, cx


def align_local(
    query: np.ndarray,
    target: np.ndarray,
    matrix: np.ndarray,
    del_: float,
    ext: float,
) -> OracleResult:
    """Local alignment end-to-end (simple/mod.rs:168-264)."""
    if len(query) == 0 or len(target) == 0:
        raise ResultIsEmpty("empty sequence")
    a, d = fill_local(query, target, matrix, del_, ext)
    my, mx = argmax_first_rowmajor(a)
    if my == 0 or mx == 0:
        # reference panics here (index underflow, simple/mod.rs:213-215)
        raise ResultIsEmpty("local alignment has no positive-scoring cell")
    qa = [int(query[mx - 1])]
    ta = [int(target[my - 1])]
    cy, cx = _walk(d, my, mx, query, target, qa, ta, pwm_mode=False)
    qa.reverse()
    ta.reverse()
    return OracleResult(
        score=a,
        directions=d,
        query_aligned=np.array(qa, dtype=np.int16),
        target_aligned=np.array(ta, dtype=np.int16),
        coords=((cx + 1, mx + 1), (cy + 1, my + 1)),
        f=float(a.max()),
    )


def align_global(
    query: np.ndarray,
    target: np.ndarray,
    matrix: np.ndarray,
    del_: float,
    ext: float,
) -> OracleResult:
    """Global alignment end-to-end (simple/mod.rs:42-144).

    Note ``f`` is 0 for global results (simple/mod.rs:139) and coords are
    always ((1, qlen), (1, tlen)) (simple/mod.rs:138).
    """
    if len(query) == 0 or len(target) == 0:
        raise ResultIsEmpty("empty sequence")
    a, d = fill_global(query, target, matrix, del_, ext)
    qa = [int(query[-1])]
    ta = [int(target[-1])]
    _walk(d, len(target), len(query), query, target, qa, ta, pwm_mode=False)
    qa.reverse()
    ta.reverse()
    return OracleResult(
        score=a,
        directions=d,
        query_aligned=np.array(qa, dtype=np.int16),
        target_aligned=np.array(ta, dtype=np.int16),
        coords=((1, len(query)), (1, len(target))),
        f=0.0,
    )


def align_pwm(
    query: np.ndarray, pwm: np.ndarray, del_: float, ext: float
) -> OracleResult:
    """Query-vs-PWM alignment end-to-end (pwm/mod.rs:29-126).

    ``target_aligned`` holds the "numbered" positions (1..=W, 0 for gap);
    no seed characters are pushed before the walk.
    """
    if pwm.shape[0] != 4:
        from .errors import MatrixShapeError

        raise MatrixShapeError(f"PWM must have 4 rows, got {pwm.shape[0]}")
    a, d = fill_pwm(query, pwm, del_, ext)
    my, mx = argmax_first_rowmajor(a)
    qa: list[int] = []
    ta: list[int] = []
    cy, cx = _walk(d, my, mx, query, None, qa, ta, pwm_mode=True)
    qa.reverse()
    ta.reverse()
    return OracleResult(
        score=a,
        directions=d,
        query_aligned=np.array(qa, dtype=np.int16),
        # int32: PWM "numbered" positions run 1..=W and W can exceed
        # int16 (the device/native paths use int32 too, traceback.py)
        target_aligned=np.array(ta, dtype=np.int32),
        coords=((cx + 1, mx + 1), (cy + 1, my + 1)),
        f=float(a.max()),
    )


# ---------------------------------------------------------------------------
# Legacy-crate semantics (src/align/aligner_core.rs) — used only to validate
# this oracle against the golden matrices in src/tests/test_alignment.rs.
# Differences: integer scores, single gap penalty, standard SW zero-clamp,
# `>=`-scan argmax (last maximum in fill order), traceback starts one cell
# up-left of the end (global) / at the argmax without +1 coords (local).
# ---------------------------------------------------------------------------


def legacy_global(
    query: np.ndarray, target: np.ndarray, matrix: np.ndarray, del_: int
) -> tuple[np.ndarray, np.ndarray, list[int], list[int]]:
    """Legacy integer NW (src/align/aligner_core.rs:93-180)."""
    q = np.asarray(query, dtype=np.int64)
    t = np.asarray(target, dtype=np.int64)
    rows, cols = len(t), len(q)
    a = np.zeros((rows + 1, cols + 1), dtype=np.int64)
    d = np.full((rows + 1, cols + 1), BEG, dtype=np.uint8)
    for x in range(1, cols + 1):
        a[0, x] = -x * del_
        d[0, x] = LEFT
    for y in range(1, rows + 1):
        a[y, 0] = -y * del_
        d[y, 0] = TOP
    a[rows, 0] = -(rows + 1) * del_
    a[0, cols] = -(cols + 1) * del_
    for x in range(1, cols + 1):
        for y in range(1, rows + 1):
            top = a[y - 1, x] - del_
            left = a[y, x - 1] - del_
            diag = a[y - 1, x - 1] + int(matrix[t[y - 1], q[x - 1]])
            m = max(top, left, diag)
            a[y, x] = m
            d[y, x] = TOP if m == top else LEFT if m == left else DIAG
    qa = [int(q[-1])]
    ta = [int(t[-1])]
    cy, cx = rows - 1, cols - 1  # legacy starts one cell up-left (:146-151)
    _walk(d, cy, cx, q, t, qa, ta, pwm_mode=False)
    qa.reverse()
    ta.reverse()
    return a, d, qa, ta


def legacy_local(
    query: np.ndarray, target: np.ndarray, matrix: np.ndarray, del_: int
) -> tuple[np.ndarray, np.ndarray, list[int], list[int]]:
    """Legacy integer SW with zero clamp (src/align/aligner_core.rs:182-278)."""
    q = np.asarray(query, dtype=np.int64)
    t = np.asarray(target, dtype=np.int64)
    rows, cols = len(t), len(q)
    a = np.zeros((rows + 1, cols + 1), dtype=np.int64)
    d = np.full((rows + 1, cols + 1), BEG, dtype=np.uint8)
    max_f, max_x, max_y = 0, 0, 0
    for x in range(1, cols + 1):
        for y in range(1, rows + 1):
            top = a[y - 1, x] - del_
            left = a[y, x - 1] - del_
            diag = a[y - 1, x - 1] + int(matrix[t[y - 1], q[x - 1]])
            m = max(top, left, diag, 0)
            a[y, x] = m
            d[y, x] = (
                BEG if m == 0 else TOP if m == top else LEFT if m == left else DIAG
            )
            if m >= max_f:  # `>=` — last maximum in fill order (:224-228)
                max_f, max_x, max_y = m, x - 1, y - 1
    qa = [int(q[max_x])]
    ta = [int(t[max_y])]
    _walk(d, max_y, max_x, q, t, qa, ta, pwm_mode=False)
    qa.reverse()
    ta.reverse()
    return a, d, qa, ta
