"""The yardstick's peaks and the work of each kernel, from problem shapes.

Frozen copy of ``chip_smoke.py:300-338`` (``PEAK_*``, ``OPS_*``,
``bound``).  Peaks of one NVIDIA H100 SXM, NVIDIA's data sheet:

* 3.35 TB/s of device memory;
* 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores.
  The data sheet counts a fused multiply-add as two operations; the fills
  do adds, subtractions and maxima, one operation each, so a fill's share
  against these peaks reads at most half of what one lane an operation a
  clock would allow;
* 16.7 T/s int32 for the walks: 64 INT32 lanes an SM (the Hopper
  architecture white paper) x 132 SMs x 1,980 MHz, the data sheet's boost
  clock.

Work is counted from the unpadded problems, whatever a kernel pads or
reads again: each input byte read once, each output byte written once.
A residue code is one byte, a score four (float32) or eight (float64),
a direction two bits.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12
PEAK_I32_S = 64 * 132 * 1.98e9
RATES = {"f32": PEAK_F32_S, "f64": PEAK_F64_S, "i32": PEAK_I32_S}
SCORE_BYTES = {"f32": 4, "f64": 8}

# a cell of the batched local fill: diag + s, two gap subtractions, the
# maxima of three, the Beginning test and the penalty's choice; with
# directions two comparisons, a shift and an or more
OPS_FILL, OPS_FILL_DIRS = 6, 10
# a step of a walk: a shift, a mask, two compares and decrements, the pack;
# a step of the count: the code's shift and mask, the two moves counted,
# then replayed: a compare and the cursor's two decrements
OPS_WALK_STEP = 10
OPS_COUNT_STEP = 8


def bound_s(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: the larger of the operations at
    the peak of their type and the bytes at the memory's peak."""
    return max(ops / RATES[kind], nbytes / PEAK_BYTES_S)


def fill(problems, kind: str, *, dirs: bool, vol: int, matrices: int = 1) -> float:
    """Bound (s) of one batched local fill of ``problems``, a list of
    (query length, target length): every cell computed once; the codes and
    ``matrices`` (V, V) score tables read once; per problem its score and
    argmax written, and with ``dirs`` two bits a cell."""
    cells = sum(c * r for c, r in problems)
    ops = (OPS_FILL_DIRS if dirs else OPS_FILL) * cells
    nbytes = (sum(c + r for c, r in problems) + matrices * vol * vol * SCORE_BYTES[kind]
              + len(problems) * (SCORE_BYTES[kind] + 8))
    if dirs:
        nbytes += cells / 4
    return bound_s(ops, nbytes, kind)


def shared_query_fill(qlen: int, target_lengths, kind: str, vol: int) -> float:
    """Bound (s) of a scores-only fill of one query against many targets:
    the query read once, each target once."""
    cells = qlen * sum(target_lengths)
    nbytes = (qlen + sum(target_lengths) + vol * vol * SCORE_BYTES[kind]
              + len(target_lengths) * (SCORE_BYTES[kind] + 8))
    return bound_s(OPS_FILL * cells, nbytes, kind)


def counting_walk(steps: int, pairs: int, members: int, vol: int) -> float:
    """Bound (s) of one counting walk: two bits of direction read a step,
    the two codes of each pair counted, each member's start and (V, V)
    counts written."""
    ops = (OPS_WALK_STEP + OPS_COUNT_STEP) * steps
    nbytes = steps / 4 + 2 * pairs + members * (8 + 1 + 4 * vol * vol)
    return bound_s(ops, nbytes, "i32")
