"""The least time one global pair's work takes on the card, from its shapes
alone, whatever kernel does it: the peaks and :func:`~harness.roofline.bound_s`
of ``harness/roofline.py``, int32.

* an alignment: every one of the R x C cells filled once, with its two bits
  of direction written;
* an end score: every cell filled once, scores only;
* a walk: one step a step of the path.

A cell of the global fill is diag + s, the top and the left penalty and two
maxima; its direction adds two comparisons, a shift and an or.  The codes
(a byte each) and the (V, V) int32 table are read once, the score written
once.
"""

from __future__ import annotations

from harness.roofline import OPS_WALK_STEP, bound_s

OPS_CELL, OPS_CELL_DIRS = 5, 9


def _inputs(rows: int, cols: int, vol: int) -> int:
    return rows + cols + 4 * vol * vol + 4


def alignment(rows: int, cols: int, vol: int) -> float:
    """Bound (s) of the fill of an alignment: R x C cells with directions."""
    cells = rows * cols
    return bound_s(OPS_CELL_DIRS * cells, _inputs(rows, cols, vol) + cells / 4, "i32")


def end_score(rows: int, cols: int, vol: int) -> float:
    """Bound (s) of the fill of an end score: R x C cells, scores only."""
    return bound_s(OPS_CELL * rows * cols, _inputs(rows, cols, vol), "i32")


def walk(steps: int) -> float:
    """Bound (s) of a walk of ``steps`` steps: two bits of direction read
    and two bits of the step stream written a step."""
    return bound_s(OPS_WALK_STEP * steps, steps / 2, "i32")
