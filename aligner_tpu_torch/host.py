"""Host (CPU) alignment engine: native C++ scalar fill with Python-oracle
fallback.

The ``oracle`` backend routes here: the C++ fill (native.py) implements
the same IEEE-754 double operations in the same order as the pure-Python
oracle, so results are bit-identical (tests cross-validate); it is simply
~1000x faster, which makes single-pair alignment of chromosome-scale
sequences practical on the host.  The short data-dependent traceback walk
stays in Python (oracle._walk).
"""

from __future__ import annotations

import numpy as np

from . import native, oracle
from .errors import MatrixShapeError, ResultIsEmpty
from .oracle import OracleResult, argmax_first_rowmajor
from .traceback import traceback_global, traceback_local, traceback_pwm


def align_local(q, t, matrix, del_: float, ext: float) -> OracleResult:
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    if not native.available():
        return oracle.align_local(q, t, matrix, del_, ext)
    plane, dirs = native.fill(q, t, matrix, del_, ext, "local")
    my, mx = native.argmax_first_rowmajor(plane)
    # traceback.py holds the ONE walk-assembly definition (seeding,
    # coords, empty-result guard) shared with the device-plane paths
    qa, ta, coords = traceback_local(dirs, my, mx, q, t)
    return OracleResult(
        score=plane, directions=dirs,
        query_aligned=qa, target_aligned=ta, coords=coords,
        # (my, mx) IS the argmax of the plane — no second O(R*C) scan
        f=float(plane[my, mx]),
    )


def align_global(q, t, matrix, del_: float, ext: float) -> OracleResult:
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    if not native.available():
        return oracle.align_global(q, t, matrix, del_, ext)
    plane, dirs = native.fill(q, t, matrix, del_, ext, "global")
    qa, ta, coords = traceback_global(dirs, q, t)
    return OracleResult(
        score=plane, directions=dirs,
        query_aligned=qa, target_aligned=ta, coords=coords,
        f=0.0,
    )


def align_pwm(q, pwm, del_: float, ext: float) -> OracleResult:
    pwm = np.asarray(pwm)
    if pwm.shape[0] != 4:
        raise MatrixShapeError(f"PWM must have 4 rows, got {pwm.shape[0]}")
    if not native.available():
        return oracle.align_pwm(q, pwm, del_, ext)
    plane, dirs = native.fill(q, None, pwm, del_, ext, "pwm")
    my, mx = argmax_first_rowmajor(plane)
    qa, numbered, coords = traceback_pwm(dirs, my, mx, q)
    return OracleResult(
        score=plane, directions=dirs,
        query_aligned=qa, target_aligned=numbered, coords=coords,
        # (my, mx) IS the argmax of the plane — no second O(R*W) scan
        f=float(plane[my, mx]),
    )
