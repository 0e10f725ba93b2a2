"""Alphabets and sequence codecs.

TPU-native data model: sequences are NumPy ``int8`` code arrays that can be
shipped to device memory directly.  The code assignment reproduces the
reference's enums (aligner-core/src/enums.rs:55-167):

* ``Protein``: 24 scoring symbols ``ARNDCQEGHILKMFPSTWYVBJZX`` = 0..23,
  plus ``Blank``=98 (``_``), ``Pos``=99 (``+``), ``Any``=100 (``*``).
* ``DNA``: ``A``=0, ``T``=1, ``C``=2, ``G``=3, plus the same specials.

Invalid-character policy mirrors the reference exactly:

* ``Protein.encode`` raises (enums.rs:292-303); the ``with_freqs`` variants
  skip invalid characters (enums.rs:305-363).
* ``DNA.encode`` silently skips (enums.rs:454-527) — *unless*
  ``strict=True`` is passed (str_to_vec semantics, enums.rs:428-439).

``encode_with_freqs_and_indices`` additionally returns the gap-compaction
bookkeeping records (``Index{coord, offset, local_offset}``,
enums.rs:325-363/489-527) used by the repeat-search engine to map compacted
coordinates back to raw-chromosome coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np

from .errors import CharIsNotMatchable

BLANK = 98
POS = 99
ANY = 100

_SENTINEL = -1  # lookup-table slot for "not a valid character"


@dataclasses.dataclass(frozen=True)
class Index:
    """Gap-compaction record (enums.rs:567-572).

    ``coord``: position in the *compacted* sequence right after a skipped run,
    ``offset``: cumulative number of skipped characters before that position,
    ``local_offset``: length of the skipped run immediately preceding it.
    """

    coord: int
    offset: int
    local_offset: int


class Alphabet:
    """A biological alphabet with the reference's integer code assignment."""

    letters: ClassVar[str]
    name: ClassVar[str]

    # --- built lazily per subclass ---
    _enc_lut: ClassVar[np.ndarray]
    _dec_lut: ClassVar[np.ndarray]

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        enc = np.full(256, _SENTINEL, dtype=np.int16)
        dec = np.full(128, ord("?"), dtype=np.uint8)
        for i, ch in enumerate(cls.letters):
            enc[ord(ch)] = i
            dec[i] = ord(ch)
        enc[ord("_")] = BLANK
        enc[ord("+")] = POS
        dec[BLANK] = ord("_")
        dec[POS] = ord("+")
        dec[ANY] = ord("*")
        cls._enc_lut = enc
        cls._dec_lut = dec

    # -- class-level API (all methods are classmethods; alphabets are static) --

    @classmethod
    def volume(cls) -> int:
        """Number of scoring symbols (enums.rs:398-400, 562-564)."""
        return len(cls.letters)

    @classmethod
    def encode(cls, seq: str | bytes, *, strict: bool | None = None) -> np.ndarray:
        """Encode a sequence to an int8 code array.

        ``strict=None`` uses the alphabet's reference default: Protein raises
        on invalid characters, DNA skips them silently.
        """
        if strict is None:
            strict = cls.strict_default
        raw = np.frombuffer(
            seq.encode() if isinstance(seq, str) else bytes(seq), dtype=np.uint8
        )
        codes = cls._enc_lut[raw]
        bad = codes == _SENTINEL
        if bad.any():
            if strict:
                ch = chr(raw[bad.argmax()])
                raise CharIsNotMatchable(
                    f"character {ch!r} is not in the {cls.name} alphabet"
                )
            codes = codes[~bad]
        return codes.astype(np.int8)

    @classmethod
    def decode(cls, codes: np.ndarray) -> str:
        """Decode an int8 code array back to a string (vec_to_str)."""
        return cls._dec_lut[np.asarray(codes, dtype=np.int64)].tobytes().decode()

    @classmethod
    def encode_with_freqs(cls, seq: str | bytes) -> tuple[np.ndarray, np.ndarray]:
        """Encode, skipping invalid chars, and return symbol frequencies.

        Frequencies are counts over the ``volume()`` scoring symbols divided
        by the *kept* sequence length (enums.rs:305-323, 469-487).
        """
        raw = np.frombuffer(
            seq.encode() if isinstance(seq, str) else bytes(seq), dtype=np.uint8
        )
        codes = cls._enc_lut[raw]
        codes = codes[codes != _SENTINEL]
        vol = cls.volume()
        counts = np.bincount(codes[codes < vol], minlength=vol).astype(np.float64)
        freqs = counts / max(len(codes), 1)
        return codes.astype(np.int8), freqs

    @classmethod
    def encode_with_freqs_and_indices(
        cls, seq: str | bytes
    ) -> tuple[np.ndarray, np.ndarray, list[Index]]:
        """Encode + frequencies + gap-compaction indices.

        Replicates enums.rs:325-363/489-527: for every maximal run of invalid
        characters, one ``Index`` is recorded at the position (in compacted
        coordinates) of the first valid character after the run, carrying the
        cumulative (``offset``) and local (``local_offset``) skip counts.
        The list is returned in *descending* ``coord`` order, as the engine's
        ``index_coord`` lookup expects (engine/mod.rs:121-129).
        """
        raw = np.frombuffer(
            seq.encode() if isinstance(seq, str) else bytes(seq), dtype=np.uint8
        )
        vol = cls.volume()
        if len(raw) >= 1 << 16:
            # chromosome-scale inputs: single-pass C++ encoder
            from . import native

            if native.available():
                codes, ncounts, nidx = native.encode(raw, cls._enc_lut, vol)
                freqs = ncounts.astype(np.float64) / max(len(codes), 1)
                indices = [
                    Index(coord=int(c), offset=int(o), local_offset=int(l))
                    for (c, o, l) in reversed(nidx)
                ]
                return codes, freqs, indices
        lut = cls._enc_lut[raw]
        valid = lut != _SENTINEL
        codes = lut[valid]
        counts = np.bincount(codes[codes < vol], minlength=vol).astype(np.float64)
        freqs = counts / max(len(codes), 1)

        indices: list[Index] = []
        if len(raw) and (~valid).any():
            v = valid.astype(np.int8)
            # valid-run starts that follow an invalid run
            starts = np.flatnonzero((v[1:] == 1) & (v[:-1] == 0)) + 1
            # matching invalid-run starts (one per element of `starts`)
            inv_starts = np.flatnonzero((v[1:] == 0) & (v[:-1] == 1)) + 1
            if not valid[0]:
                inv_starts = np.concatenate(([0], inv_starts))
            inv_starts = inv_starts[: len(starts)]
            cum_invalid = np.cumsum(~valid)
            counts = cum_invalid[starts - 1]
            locals_ = starts - inv_starts
            for i, count, local in zip(starts, counts, locals_):
                indices.append(
                    Index(
                        coord=int(i - count), offset=int(count), local_offset=int(local)
                    )
                )
        indices.reverse()
        return codes.astype(np.int8), freqs, indices

    @classmethod
    def random_seq(cls, length: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform random sequence over the scoring symbols (enums.rs:365-374)."""
        return rng.integers(0, cls.volume(), size=length, dtype=np.int64).astype(
            np.int8
        )

    @classmethod
    def random_seq_with_freqs(
        cls, length: int, rng: np.random.Generator
    ) -> tuple[np.ndarray, np.ndarray]:
        """Random sequence plus *unnormalized* frequency counts.

        Note: the reference returns raw counts here, not normalized
        frequencies (enums.rs:376-388, 540-552) — kept for parity.
        """
        seq = cls.random_seq(length, rng)
        counts = np.bincount(seq.astype(np.int64), minlength=cls.volume()).astype(
            np.float64
        )
        return seq, counts


class Protein(Alphabet):
    name = "protein"
    letters = "ARNDCQEGHILKMFPSTWYVBJZX"
    strict_default = True


class DNA(Alphabet):
    name = "dna"
    letters = "ATCG"
    strict_default = False


def index_coord(target: int, indices: list[Index]) -> int:
    """Map a compacted coordinate back to the raw coordinate.

    First index (descending-coord order) with ``target >= coord`` contributes
    its offset (engine/mod.rs:121-129).
    """
    for idx in indices:
        if target >= idx.coord:
            return target + idx.offset
    return target


def rotate_indices(indices: list[Index], seq_length: int) -> list[Index]:
    """Recompute compaction indices for the reversed sequence.

    Port of engine/mod.rs:131-152: offsets are re-accumulated in descending
    original-coord order and coordinates mirrored about the full (raw)
    length.
    """
    if not indices:
        return []
    ref = indices[0]
    full_length = seq_length + ref.offset
    out: list[Index] = []
    offset = 0
    for idx in indices:
        offset += idx.local_offset
        out.append(
            Index(
                coord=full_length - idx.coord - ref.offset,
                offset=offset,
                local_offset=idx.local_offset,
            )
        )
    out.reverse()
    return out
