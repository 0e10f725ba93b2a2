"""Host-side traceback over direction planes.

The DP fill runs on device and returns a uint8 direction plane; the walk
itself is a short, data-dependent pointer chase (output length ≤ rows+cols)
so it runs on host, exactly reproducing the reference's walks:

* local: seed with the characters at the argmax cell, then walk
  (simple/mod.rs:213-242);
* global: seed with the last characters, walk from [tlen, qlen]
  (simple/mod.rs:99-127);
* pwm: no seed, "numbered" positions 1..=W with 0 for gaps
  (pwm/mod.rs:77-103).

Reported coords are ``((end_x+1, start_x+1), (end_y+1, start_y+1))``
(simple/mod.rs:253-258) and always ``((1,qlen),(1,tlen))`` for global.
"""

from __future__ import annotations

import numpy as np

from .errors import ResultIsEmpty
from .oracle import _walk


def traceback_local(
    dirs: np.ndarray, my: int, mx: int, q: np.ndarray, t: np.ndarray
) -> tuple[np.ndarray, np.ndarray, tuple]:
    if my == 0 or mx == 0:
        # the reference panics on index underflow here (simple/mod.rs:213-215)
        raise ResultIsEmpty("local alignment has no positive-scoring cell")
    qa = [int(q[mx - 1])]
    ta = [int(t[my - 1])]
    cy, cx = _walk(dirs, my, mx, q, t, qa, ta, pwm_mode=False)
    qa.reverse()
    ta.reverse()
    coords = ((cx + 1, mx + 1), (cy + 1, my + 1))
    return np.array(qa, dtype=np.int16), np.array(ta, dtype=np.int16), coords


def traceback_global(
    dirs: np.ndarray, q: np.ndarray, t: np.ndarray
) -> tuple[np.ndarray, np.ndarray, tuple]:
    qa = [int(q[-1])]
    ta = [int(t[-1])]
    _walk(dirs, len(t), len(q), q, t, qa, ta, pwm_mode=False)
    qa.reverse()
    ta.reverse()
    return (
        np.array(qa, dtype=np.int16),
        np.array(ta, dtype=np.int16),
        ((1, len(q)), (1, len(t))),
    )


def traceback_pwm(
    dirs: np.ndarray, my: int, mx: int, q: np.ndarray
) -> tuple[np.ndarray, np.ndarray, tuple]:
    """Returns (query_aligned, numbered, coords)."""
    qa: list[int] = []
    ta: list[int] = []
    cy, cx = _walk(dirs, my, mx, q, None, qa, ta, pwm_mode=True)
    qa.reverse()
    ta.reverse()
    coords = ((cx + 1, mx + 1), (cy + 1, my + 1))
    return np.array(qa, dtype=np.int16), np.array(ta, dtype=np.int32), coords
