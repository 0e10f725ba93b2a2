"""Service data models (aligner-web/src/server/models.rs).

JSON uses camelCase field names for API parity (models.rs
``rename_all = "camelCase"``); matrices serialize in serde-ndarray layout
``{"v":1,"dim":[r,c],"data":[...]}`` like the reference's Kafka payloads
and DB JSON columns.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from ..errors import ValidationError


def matrix_to_serde_dict(m: np.ndarray) -> dict:
    """serde's ndarray JSON layout (``{"v":1,"dim","data"}``) — the ONE
    matrix codec, shared by the service payloads/DB columns, the
    repeat-search matrices.json, and the engine checkpoints."""
    m = np.asarray(m, dtype=np.float64)
    # tolist() yields the identical Python floats at C speed — matrices
    # here can be checkpoint-sized, a per-element Python loop is not
    return {"v": 1, "dim": list(m.shape), "data": m.ravel().tolist()}


def matrix_to_json(m: np.ndarray) -> str:
    return json.dumps(matrix_to_serde_dict(m))


def matrix_from_json(s: str | dict) -> np.ndarray:
    d = json.loads(s) if isinstance(s, str) else s
    return np.asarray(d["data"], dtype=np.float64).reshape(d["dim"])


def array1_to_serde_dict(a: np.ndarray) -> dict:
    a = np.asarray(a, dtype=np.float64)
    return {"v": 1, "dim": [len(a)], "data": a.tolist()}


def array1_to_json(a: np.ndarray) -> str:
    return json.dumps(array1_to_serde_dict(a))


def task_hash(
    query_sequence: str,
    target_sequence: str,
    kd_value: float,
    r_squared_value: float,
    del_value: float,
    dim_value: int,
    matrices_volume_value: int,
) -> str:
    """Deterministic task hash over sequences + 5-decimal-formatted params
    (models.rs:44-59,101-118).

    The reference uses Rust's randomly-keyed DefaultHasher (its hashes are
    not stable across processes — arguably a bug for a de-dup key); this
    uses sha256 over the same fields, truncated to 16 hex chars.
    """
    payload = "\x1f".join(
        [
            query_sequence,
            target_sequence,
            f"{kd_value:.5f}",
            f"{r_squared_value:.5f}",
            f"{del_value:.5f}",
            str(dim_value),
            str(matrices_volume_value),
        ]
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass
class AlignJobRequest:
    """POST /validate body (models.rs:20-29)."""

    sequences: str  # FASTA text
    kd_value: float
    r_squared_value: float
    del_value: float
    dim_value: int
    matrices_volume_value: int

    @classmethod
    def from_json(cls, data: dict) -> "AlignJobRequest":
        try:
            req = cls(
                sequences=data["sequences"],
                kd_value=float(data["kdValue"]),
                r_squared_value=float(data["rSquaredValue"]),
                del_value=float(data["delValue"]),
                dim_value=int(data["dimValue"]),
                matrices_volume_value=int(data["matricesVolumeValue"]),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise ValidationError(f"bad AlignJobRequest: {e}") from e
        # non-positive dims/volumes must 400 here, not leak into the
        # pipeline: dim <= 0 crashes matrix generation mid-request (after
        # tasks were inserted), and volume <= 0 creates tasks that spawn
        # ZERO jobs — reported 200 but stuck at 0% forever
        if req.dim_value <= 0:
            raise ValidationError(f"dimValue must be >= 1, got {req.dim_value}")
        if req.matrices_volume_value <= 0:
            raise ValidationError(
                f"matricesVolumeValue must be >= 1, got {req.matrices_volume_value}"
            )
        return req

    def to_json(self) -> dict:
        return {
            "sequences": self.sequences,
            "kdValue": self.kd_value,
            "rSquaredValue": self.r_squared_value,
            "delValue": self.del_value,
            "dimValue": self.dim_value,
            "matricesVolumeValue": self.matrices_volume_value,
        }


@dataclasses.dataclass
class AlignJob:
    """One queued unit of work: a (pair, candidate matrix) combination
    (models.rs:31-42)."""

    sequence_1: str
    sequence_2: str
    matrix: np.ndarray | None
    frequences: np.ndarray
    kd_value: float
    r_squared_value: float
    del_value: float
    matrices_volume_value: int
    hash: str

    def to_json(self) -> str:
        return json.dumps(
            {
                "sequence_1": self.sequence_1,
                "sequence_2": self.sequence_2,
                "matrix": None if self.matrix is None
                else matrix_to_serde_dict(self.matrix),
                "frequences": array1_to_serde_dict(self.frequences),
                "kd_value": self.kd_value,
                "r_squared_value": self.r_squared_value,
                "del_value": self.del_value,
                "matrices_volume_value": self.matrices_volume_value,
                "hash": self.hash,
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "AlignJob":
        d = json.loads(s)
        return cls(
            sequence_1=d["sequence_1"],
            sequence_2=d["sequence_2"],
            matrix=None if d["matrix"] is None else matrix_from_json(d["matrix"]),
            frequences=np.asarray(d["frequences"]["data"], dtype=np.float64),
            kd_value=d["kd_value"],
            r_squared_value=d["r_squared_value"],
            del_value=d["del_value"],
            matrices_volume_value=d["matrices_volume_value"],
            hash=d["hash"],
        )
