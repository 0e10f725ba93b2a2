"""One-vs-many database search: query vs FASTA database, top-k scores.

The database shards into length buckets (padding waste is bounded by the
bucket growth factor), every bucket runs as one scores-only batched
launch, and only the top-k hits pay for a full (direction words + walk)
pass.  The buckets' launches are one :class:`~aligner_tpu_torch.align.ScorePass`:
enqueued tallest first, each on a stream of its own, all in flight at
once, and one wait for the card before their scores are read.
Counterpart of ``aligner_tpu.search``.

The database stays on the cards between calls.  The process keeps the
last database it searched (one), prepared once: its records' codes on the
host, and each bucket a :class:`~aligner_tpu_torch.align.TargetBucket`,
padded, checked and sent to the cards by its first pass.  A later call
with the same alphabet, bucket growth, device and shards, and as many
records, enqueues its pass over those buckets at once and compares its
records with the kept ones, code for code, on the host while the cards
fill; only when they are equal are the scores read.  Where they differ,
the pass is waited for, its scores dropped, and the database prepared
afresh from the call's records.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from .align import (ScorePass, TargetBucket, _auto_shard_devices, _card, _encode,
                    batch_align)
from .alphabet import Alphabet, Protein
from .backend import resolve_device
from .errors import ValidationError
from .observability import span


@dataclasses.dataclass
class SearchHit:
    index: int  # position in the database
    name: str
    score: float
    coords: tuple | None = None
    query_aligned: np.ndarray | None = None
    target_aligned: np.ndarray | None = None


def length_buckets(
    lengths: Sequence[int], growth: float = 1.3, min_size: int = 64
) -> list[np.ndarray]:
    """Group database indices into geometric length buckets.

    Buckets below ``min_size`` may absorb longer members to keep launch
    counts low, but the padded width never exceeds ``2·growth``x the
    bucket's shortest member — a small bucket must not swallow one huge
    sequence and pad everything to its length.
    """
    order = np.argsort(lengths)
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_min = None
    for i in order:
        ln = max(int(lengths[i]), 1)
        if cur_min is None:
            cur_min = ln
        hard = ln > cur_min * growth * 2  # absolute width-ratio cap
        soft = ln > cur_min * growth and len(cur) >= min_size
        if cur and (hard or soft):
            buckets.append(cur)
            cur, cur_min = [], ln
        cur.append(int(i))
    if cur:
        buckets.append(cur)
    return [np.array(b, dtype=np.int64) for b in buckets]


@dataclasses.dataclass(eq=False)
class _Database:
    """A database prepared for the search's score pass."""

    key: tuple  # what the preparation depended on (:func:`_key`)
    count: int
    texts: tuple | None  # the records themselves, where every one is a str or bytes
    codes: np.ndarray | None  # else their codes, end to end
    lengths: np.ndarray
    buckets: list  # (database indices, TargetBucket), tallest first

    @classmethod
    def prepare(cls, database: Sequence, alphabet: type[Alphabet], key: tuple) -> "_Database":
        with span("search.encode"):
            db = [_encode(s, alphabet) for s in database]
            texts = tuple(database) if key[2] else None
            codes = None if texts is not None else np.concatenate(db)
        with span("search.buckets") as bs:
            lengths = np.fromiter(map(len, db), np.int64, len(db))
            buckets = length_buckets(lengths, growth=key[1])
            bs.count(buckets=len(buckets))
        # a bucket is sorted by length: its last record is its longest.  The
        # tallest goes first: its launch runs longest, and on the first pass
        # the host prepares the other buckets while it does
        order = sorted(buckets, key=lambda b: lengths[b[-1]], reverse=True)
        return cls(key, len(db), texts, codes, lengths,
                   [(b, TargetBucket([db[i] for i in b])) for b in order])

    def holds(self, database: Sequence, alphabet: type[Alphabet]) -> bool:
        """Whether ``database`` is the records this was prepared from, in
        order, code for code (``str`` and ``bytes`` records, which cannot
        change, compared as they are)."""
        if self.texts is not None:
            return tuple(database) == self.texts
        try:
            # int8 only where every record is an int8 (or bool) array: its
            # codes as they are, with no record encoded one by one
            codes = np.concatenate(database)
        except (ValueError, TypeError):
            codes = None
        if codes is not None and codes.dtype == np.int8 and codes.ndim == 1:
            db = database
        else:
            db = [_encode(s, alphabet) for s in database]
            codes = np.concatenate(db)
        return (np.array_equal(np.fromiter(map(len, db), np.int64, len(db)), self.lengths)
                and np.array_equal(codes, self.codes))


class _Resident:
    """The database kept on the cards: one a process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._db: _Database | None = None

    def get(self, key: tuple, count: int) -> _Database | None:
        with self._lock:
            db = self._db
        return db if db is not None and db.key == key and db.count == count else None

    def keep(self, db: _Database) -> None:
        with self._lock:
            self._db = db

    def drop(self, db: _Database) -> None:
        with self._lock:
            if self._db is db:
                self._db = None


_resident = _Resident()


def _key(database: Sequence, alphabet: type[Alphabet], growth: float, device) -> tuple:
    """What a prepared database depends on besides its records: the
    alphabet, the bucket growth, whether the records are all text, the
    device, and the shards of its score pass."""
    return (alphabet, float(growth), all(isinstance(s, (str, bytes)) for s in database),
            _card(device), tuple(_card(d) for d in _auto_shard_devices(device)))


def _scores(q, matrix, del_, ext, mode, alphabet, device, db: _Database, verify=None):
    """Every bucket's scores of ``q`` against ``db``, one score pass:
    ``(scores in db.buckets' order, the pass)``.  With ``verify``, the host
    asks it whether the call's records are ``db``'s (``search.verify``)
    while the cards fill; where they are not, or where a bucket refuses
    ``db``'s codes before they are known to be the call's, the pass is
    waited for, its scores dropped, and the scores are None."""
    verified = False
    try:
        with ScorePass(q, matrix, del_, ext, mode=mode, alphabet=alphabet,
                       device=device) as fills:
            for rows, bucket in db.buckets:
                with span("search.bucket", rows=len(rows), width=int(db.lengths[rows[-1]])):
                    fills.enqueue(bucket)
            if verify is not None:
                with span("search.verify"):
                    verified = verify()
                if not verified:
                    return None, fills
            return fills.read(), fills
    except ValidationError:
        if verify is None or verified:
            raise
        with span("search.verify"):
            if verify():
                raise
        return None, None


def search_database(
    query,
    database: Sequence,
    matrix,
    del_: float,
    ext: float,
    *,
    k: int = 10,
    names: Sequence[str] | None = None,
    alphabet: type[Alphabet] = Protein,
    device=None,
    mode: str = "local",
    with_alignments: bool = True,
    bucket_growth: float = 1.3,
) -> list[SearchHit]:
    """Align ``query`` against every database sequence; return top-k hits.

    Scores for the whole database come from bucketed scores-only launches,
    one score pass over the database kept on the cards (prepared first
    where the call's records are not the kept ones); alignments (traceback)
    are computed only for the k winners.
    """
    if k <= 0:
        raise ValidationError("k must be positive")
    with span("search", records=len(database)) as sp:
        q = _encode(query, alphabet)
        sp.count(query_len=len(q))
        if not len(database):
            raise ValidationError("empty database")
        n = len(database)
        if names is not None and len(names) != n:
            # fail BEFORE the launches, not at name lookup after all the
            # alignment work is done
            raise ValidationError(
                f"names has {len(names)} entries for {n} db sequences"
            )
        device = resolve_device(device)
        key = _key(database, alphabet, bucket_growth, device)
        db = _resident.get(key, n)
        results = None
        if db is not None:
            results, fills = _scores(q, matrix, del_, ext, mode, alphabet, device, db,
                                     verify=lambda: db.holds(database, alphabet))
            if results is None:
                _resident.drop(db)
        sp.count(resident=int(results is not None))
        if results is None:
            with span("search.prepare"):
                db = _Database.prepare(database, alphabet, key)
            results, fills = _scores(q, matrix, del_, ext, mode, alphabet, device, db)
            _resident.keep(db)
        sp.count(in_flight=fills.in_flight, streams=len(fills.streams))
        scores = np.full(n, -np.inf)
        for (rows, _), res in zip(db.buckets, results):
            scores[rows] = res.fmax if mode == "local" else res.end
        with span("search.rank"):
            # a zero-length record has NO alignment (the single-pair API raises
            # ResultIsEmpty) — the batch fill reports its masked-out score as 0,
            # which in global mode would outrank real sequences' negative gap
            # scores; keep such records out of the ranking entirely
            scores[db.lengths == 0] = -np.inf

            top = np.argsort(-scores, kind="stable")[:k]
            hits = [
                SearchHit(index=int(i), name=str(i) if names is None else names[int(i)],
                          score=float(scores[i]))
                for i in top
            ]
        if with_alignments:
            # only hits that CAN align get a traceback: empty targets and
            # local hits with no positive-scoring cell have none (the batch
            # returns None for the latter) — such hits keep score-only form
            # instead of aborting the whole search
            alignable = [
                h for h in hits
                if db.lengths[h.index] > 0 and (mode != "local" or h.score > 0)
            ]
            if alignable and len(q) > 0:
                with span("search.alignments"):
                    results = batch_align(
                        [q] * len(alignable),
                        [_encode(database[h.index], alphabet) for h in alignable],
                        matrix, del_, ext,
                        mode=mode, alphabet=alphabet, device=device,
                        with_alignments=True,
                    )
                for h, r in zip(alignable, results):
                    if r is None:
                        continue
                    h.coords = r.alignment.coords
                    h.query_aligned = r.alignment.query
                    h.target_aligned = r.alignment.target
        return hits
