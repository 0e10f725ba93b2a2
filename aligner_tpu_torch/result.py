"""Alignment result objects: frequency matrices and match-string rendering.

Equivalent of aligner-core/src/alignment.rs (Alignment / PWMAlignment) and
alignment_result.rs.  Sequences are int code arrays; rendering uses the
alphabet codecs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import BLANK, POS, Alphabet


@dataclasses.dataclass
class Alignment:
    """A gapped pairwise alignment (alignment.rs:4-10)."""

    query: np.ndarray  # int16 codes incl. BLANK
    target: np.ndarray  # int16 codes incl. BLANK
    coords: tuple[tuple[int, int], tuple[int, int]]
    f: float
    alphabet: type[Alphabet]

    def frequency_matrix(self) -> np.ndarray:
        """volume×volume count of (target_char, query_char) pairs, blanks
        excluded (alignment.rs:13-23)."""
        vol = self.alphabet.volume()
        m = np.zeros((vol, vol), dtype=np.float64)
        q = np.asarray(self.query, dtype=np.int64)
        t = np.asarray(self.target, dtype=np.int64)
        keep = (q != BLANK) & (t != BLANK)
        np.add.at(m, (t[keep], q[keep]), 1.0)
        return m

    def match_string(self, matrix: np.ndarray) -> np.ndarray:
        """Per-column match codes: the char if equal, ``+`` if the
        substitution scores >= 0, else ``_`` (alignment.rs:25-42)."""
        q = np.asarray(self.query, dtype=np.int64)
        t = np.asarray(self.target, dtype=np.int64)
        out = np.full(len(q), BLANK, dtype=np.int16)
        eq = q == t
        out[eq] = q[eq]
        both = (~eq) & (q != BLANK) & (t != BLANK)
        pos = both.copy()
        pos[both] = matrix[t[both], q[both]] >= 0.0
        out[pos] = POS
        return out

    def render(self) -> tuple[str, str]:
        return self.alphabet.decode(self.query), self.alphabet.decode(self.target)


@dataclasses.dataclass
class PWMAlignment:
    """Query-vs-PWM alignment (alignment.rs:45-92).

    ``numbered`` holds 1-based PWM positions, 0 for a gap.
    """

    numbered: np.ndarray  # int32, 0 = gap
    query: np.ndarray  # int16 codes incl. BLANK
    dim: int  # PWM width
    coords: tuple[tuple[int, int], tuple[int, int]]
    f: float
    alphabet: type[Alphabet]

    def frequency_matrix(self) -> np.ndarray:
        """(volume × dim) counts of (query_char, pwm_position) pairs
        (alignment.rs:55-65)."""
        vol = self.alphabet.volume()
        m = np.zeros((vol, self.dim), dtype=np.float64)
        n = np.asarray(self.numbered, dtype=np.int64)
        q = np.asarray(self.query, dtype=np.int64)
        keep = (n != 0) & (q != BLANK)
        np.add.at(m, (q[keep], n[keep] - 1), 1.0)
        return m

    def match_string(self) -> np.ndarray:
        """The query char where matched to a position, ``_`` on gaps
        (alignment.rs:67-79)."""
        n = np.asarray(self.numbered, dtype=np.int64)
        q = np.asarray(self.query, dtype=np.int16)
        return np.where(n != 0, q, np.int16(BLANK))

    @classmethod
    def empty(cls, alphabet: type[Alphabet]) -> "PWMAlignment":
        """The reference's sentinel empty value (alignment.rs:83-91),
        coords ((0,0),(0,0)) exactly as it constructs them.  NOTE this
        is a sentinel, not what aligning an empty query RETURNS — the
        real empty-query walk yields coords ((1,1),(1,1)) (align_pwm
        docstring) — so do not compare results against it."""
        return cls(
            numbered=np.zeros(0, dtype=np.int32),
            query=np.zeros(0, dtype=np.int16),
            dim=0,
            coords=((0, 0), (0, 0)),
            f=0.0,
            alphabet=alphabet,
        )


@dataclasses.dataclass
class AlignmentResult:
    """DP planes + alignment (+ the matrix that produced it, for heuristic
    results) — alignment_result.rs:7-13."""

    alignment: Alignment | PWMAlignment
    score: np.ndarray | None = None
    directions: np.ndarray | None = None
    matrix: np.ndarray | None = None
