"""FASTA reading/writing.

Replaces the reference's seq_io usage (engine/sequences.rs:9-31,
aligner-cli/main.rs:24-33).  One deliberate divergence: ASCII whitespace
*inside* sequence lines is stripped (seq_io keeps it, which makes the
reference panic on examples/human_gene_example.fasta, whose line 21 carries
a trailing space).
"""

from __future__ import annotations

import dataclasses
import os

from ..errors import ValidationError


@dataclasses.dataclass
class FastaRecord:
    head: str  # full header line without '>'
    seq: bytes

    @property
    def id(self) -> str:
        return self.head.split()[0] if self.head else ""


def read_fasta(text: str | bytes) -> list[FastaRecord]:
    if isinstance(text, bytes):
        text = text.decode()
    records: list[FastaRecord] = []
    head: str | None = None
    chunks: list[str] = []
    for line in text.splitlines():
        if line.startswith(">"):
            if head is not None:
                records.append(FastaRecord(head, "".join(chunks).encode()))
            head = line[1:].strip()
            chunks = []
        elif line.strip():
            if head is None:
                raise ValidationError("FASTA data before first '>' header")
            chunks.append("".join(line.split()))
    if head is not None:
        records.append(FastaRecord(head, "".join(chunks).encode()))
    if not records:
        raise ValidationError("empty FASTA input")
    return records


def read_fasta_file(path: str | os.PathLike) -> list[FastaRecord]:
    with open(path, "r") as fh:
        return read_fasta(fh.read())


def write_fasta(records: list[FastaRecord], width: int = 75) -> str:
    out: list[str] = []
    for rec in records:
        out.append(f">{rec.head}")
        s = rec.seq.decode()
        out.extend(s[i : i + width] for i in range(0, len(s), width))
    return "\n".join(out) + "\n"


def mask_intervals(seq: bytes, intervals: list[tuple[int, int]]) -> bytes:
    """Overwrite [left, right) intervals with ``N`` so DNA decoding drops
    them (engine/sequences.rs:33-43, const N engine/sequences.rs:7).

    Intervals are clipped to the sequence: coords from a known.csv of a
    different assembly may extend past the record end, and a bytearray
    slice-assign would silently GROW the sequence there."""
    buf = bytearray(seq)
    n = len(buf)
    for left, right in intervals:
        left = max(min(int(left), n), 0)
        right = max(min(int(right), n), left)
        buf[left:right] = b"N" * (right - left)
    return bytes(buf)
