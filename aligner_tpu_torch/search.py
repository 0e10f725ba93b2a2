"""One-vs-many database search: query vs FASTA database, top-k scores.

The database shards into length buckets (padding waste is bounded by the
bucket growth factor), every bucket runs as one scores-only batched
launch, and only the top-k hits pay for a full (direction words + walk)
pass.  Counterpart of ``aligner_tpu.search``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .align import batch_align
from .alphabet import Alphabet, Protein
from .errors import ValidationError


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

    Scores for the whole database come from bucketed scores-only launches;
    alignments (traceback) are computed only for the k winners.
    """
    from .align import _encode

    if k <= 0:
        raise ValidationError("k must be positive")
    q = _encode(query, alphabet)
    db = [_encode(s, alphabet) for s in database]
    if not db:
        raise ValidationError("empty database")
    names = list(names) if names is not None else [str(i) for i in range(len(db))]
    if len(names) != len(db):
        # fail BEFORE the launches, not at name lookup after all the
        # alignment work is done
        raise ValidationError(
            f"names has {len(names)} entries for {len(db)} db sequences"
        )
    lengths = [len(s) for s in db]

    scores = np.full(len(db), -np.inf)
    for bucket in length_buckets(lengths, growth=bucket_growth):
        targets = [db[i] for i in bucket]
        res = batch_align(
            [q] * len(bucket), targets, matrix, del_, ext,
            mode=mode, alphabet=alphabet, device=device,
        )
        scores[bucket] = res.fmax if mode == "local" else res.end
    # a zero-length record has NO alignment (the single-pair API raises
    # ResultIsEmpty) — the batch fill reports its masked-out score as 0,
    # which in global mode would outrank real sequences' negative gap
    # scores; keep such records out of the ranking entirely
    scores[np.asarray(lengths) == 0] = -np.inf

    top = np.argsort(-scores, kind="stable")[:k]
    hits = [
        SearchHit(index=int(i), name=names[int(i)], score=float(scores[i]))
        for i in top
    ]
    if with_alignments:
        # only hits that CAN align get a traceback: empty targets and
        # local hits with no positive-scoring cell have none (the batch
        # returns None for the latter) — such hits keep score-only form
        # instead of aborting the whole search
        alignable = [
            h for h in hits
            if len(db[h.index]) > 0 and (mode != "local" or h.score > 0)
        ]
        if alignable and len(q) > 0:
            results = batch_align(
                [q] * len(alignable), [db[h.index] for h in alignable],
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
