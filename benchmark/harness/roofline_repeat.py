"""The least time of the latent-repeat search's PWM fills, from the windows'
shapes alone, whatever kernel does them: the peaks and
:func:`~harness.roofline.bound_s` of ``harness/roofline.py``, float64.

* a scan: every cell of every window (its length × the PWM's W positions)
  filled once, scores only (``OPS_FILL`` operations a cell);
* the survivors' pass: every cell of every surviving window filled once
  with its two bits of direction (``OPS_FILL_DIRS``).

Bytes: each window's codes (a byte a base) and the (4, W) table of 8-byte
entries read once, each window's score and argmax (8 bytes each) written
once, and with directions two bits a cell.

The program's launches, by name: the fill kernel's template is
``dp_fill_kernel<T, GLOBAL, TRACK, DIRS, PWM, PLANE>``; a scan launches it
in float64, local, without directions, in PWM mode; the survivors' pass
the same with directions.
"""

from __future__ import annotations

import re

from harness.roofline import OPS_FILL, OPS_FILL_DIRS, SCORE_BYTES, bound_s

BASES = 4
_PWM_F64 = r"dp_fill_kernel<\s*double\s*,\s*false\s*,\s*\w+\s*,\s*{dirs}\s*,\s*true\b"
_SCAN = re.compile(_PWM_F64.format(dirs="false"))
_SURVIVORS = re.compile(_PWM_F64.format(dirs="true"))


def SCAN_KERNEL(name: str) -> bool:
    """A scan's launch: float64, local, no directions, PWM mode."""
    return bool(_SCAN.search(name))


def SURVIVOR_KERNEL(name: str) -> bool:
    """A launch of the survivors' pass: float64, local, directions, PWM mode."""
    return bool(_SURVIVORS.search(name))


def fill(windows: int, bases: int, width: int, *, dirs: bool) -> float:
    """Bound (s) of a PWM fill of ``windows`` windows of ``bases`` bases in
    all against a (4, ``width``) PWM, with or without directions."""
    cells = bases * width
    nbytes = bases + BASES * width * SCORE_BYTES["f64"] + windows * (SCORE_BYTES["f64"] + 8)
    if dirs:
        nbytes += cells / 4
    return bound_s((OPS_FILL_DIRS if dirs else OPS_FILL) * cells, nbytes, "f64")
