"""CSV record IO for repeat-search results.

Equivalent of aligner-helpers/src/csv/mod.rs:7-56 — records with
(name, z_value, left_coord, right_coord), grouped by name on read.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from collections import defaultdict


@dataclasses.dataclass
class Record:
    name: str
    z_value: float
    left_coord: int
    right_coord: int


FIELDS = ["name", "z_value", "left_coord", "right_coord"]


def read_records(path: str | os.PathLike) -> dict[str, list[Record]]:
    out: dict[str, list[Record]] = defaultdict(list)
    with open(path, newline="") as fh:
        for row in csv.DictReader(fh):
            out[row["name"]].append(
                Record(
                    name=row["name"],
                    z_value=float(row["z_value"]),
                    left_coord=int(row["left_coord"]),
                    right_coord=int(row["right_coord"]),
                )
            )
    return dict(out)


def write_records(path: str | os.PathLike, records: list[Record]) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=FIELDS)
        w.writeheader()
        for r in records:
            w.writerow(dataclasses.asdict(r))
