"""Space-delimited matrix (de)serialization.

Equivalent of aligner-helpers/src/files/mod.rs:44-78
(convert_csv_to_matrix / convert_matrix_to_csv).
"""

from __future__ import annotations

import numpy as np

from ..errors import ValidationError


def matrix_from_csv(text: str | bytes, dim: tuple[int, int] | None = None) -> np.ndarray:
    if isinstance(text, bytes):
        text = text.decode()
    rows = [
        [float(v) for v in line.split()] for line in text.splitlines() if line.strip()
    ]
    if not rows:
        raise ValidationError("empty matrix file")
    widths = {len(r) for r in rows}
    if len(widths) != 1:
        raise ValidationError(
            f"ragged matrix file: row widths {sorted(widths)}"
        )
    m = np.array(rows, dtype=np.float64)
    if dim is not None and m.shape != dim:
        out = np.zeros(dim, dtype=np.float64)
        out[: m.shape[0], : m.shape[1]] = m[: dim[0], : dim[1]]
        m = out
    return m


def matrix_to_csv(matrix: np.ndarray) -> str:
    return "\n".join(
        " ".join(_fmt(v) for v in row) for row in np.asarray(matrix)
    ) + "\n"


def _fmt(v: float) -> str:
    # integers render without a trailing .0, like Rust's Display for f64
    return str(int(v)) if float(v).is_integer() else repr(float(v))
