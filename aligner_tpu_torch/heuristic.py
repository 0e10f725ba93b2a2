"""Heuristic (matrix-free) PWM alignment.

Counterpart of the PWM half of ``aligner_tpu/heuristic.py`` (itself the
equivalent of aligner-core/src/heuristic/mod.rs:81-142): derive a PWM
iteratively — align the query with a transformed PWM, take the
alignment's frequency matrix, project it back onto the (kd, r²)
constraint surface, realign — until the local score stops strictly
improving.  The returned result is the first *non-improving* alignment
with the PWM that produced it attached.  The repeat search's testing
mode runs it.  The pairwise aligner and the batched population are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .align import align_pwm
from .alphabet import DNA, Alphabet
from .errors import MissingArgument, ValidationError
from .matrices import transform_matrix
from .result import AlignmentResult


@dataclasses.dataclass
class Heuristics:
    """Matrix-derivation parameters (lib.rs:21-25)."""

    kd: float
    r_squared: float
    frequencies: np.ndarray


def heuristic_align_pwm(
    query,
    pwm,
    del_: float,
    ext: float,
    heuristics: Heuristics | None,
    *,
    alphabet: type[Alphabet] = DNA,
    device=None,
    max_iters: int = 1000,
) -> AlignmentResult:
    """Query-vs-PWM heuristic alignment (heuristic/mod.rs:103-141).

    The PWM variant does *not* apply the r_squared == 0 default of the
    pairwise one.  ``max_iters`` is a safety bound absent in the
    reference (whose loop is unbounded).
    """
    if heuristics is None:
        raise MissingArgument("heuristic aligner requires Heuristics")
    pwm = np.asarray(pwm, dtype=np.float64)
    transformed = transform_matrix(
        pwm, heuristics.kd, heuristics.r_squared, heuristics.frequencies
    )
    if max_iters < 1:
        raise ValidationError("max_iters must be >= 1")
    max_f = 0.0
    for _ in range(max_iters):
        current = transformed
        result = align_pwm(query, current, del_, ext, alphabet=alphabet, device=device)
        if result.alignment.f > max_f:
            max_f = result.alignment.f
            transformed = transform_matrix(
                result.alignment.frequency_matrix(),
                heuristics.kd, heuristics.r_squared, heuristics.frequencies,
            )
        else:
            result.matrix = current
            return result
    result.matrix = current
    return result


class HeuristicPWMAligner:
    """Equivalent of aligner-core HeuristicPWMAligner (heuristic/mod.rs:81-142)."""

    def __init__(self, query, alphabet=DNA):
        self.query = query
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, alphabet=DNA):
        return cls(alphabet.encode(query), alphabet)

    @classmethod
    def from_seqs(cls, query, alphabet=DNA):
        return cls(np.asarray(query, np.int8), alphabet)

    def perform_alignment(self, del_, ext, pwm, heuristics=None, **kw):
        return heuristic_align_pwm(
            self.query, pwm, del_, ext, heuristics, alphabet=self.alphabet, **kw
        )
