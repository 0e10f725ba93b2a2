"""The reference's database search: the top-k hits of a query, in plain
PyTorch on the fill of :mod:`reference.fill`.

Every database sequence gets :func:`~reference.fill.local_bound`, an upper
bound of its local score.  Exact scores (:func:`~reference.fill.local_fill_columns`,
the scoring being integral) are filled for the sequences with
the highest bounds, and again for every sequence whose bound reaches the
k-th exact score, until none is left: a sequence whose bound lies below
the k-th exact score cannot enter the list.  The ranking is the program's
rule, which the reference's ``aligner-search`` defines: scores descending,
ties by database position.  The k hits are then traced back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fill import local_bound, local_fill_columns, pad, traceback


@dataclasses.dataclass
class Hit:
    index: int
    score: float
    coords: tuple | None
    query: np.ndarray | None
    target: np.ndarray | None


def _groups(lengths: np.ndarray, C: int, row_cells: int, spread: float = 1.5):
    """Database positions sorted by length, in groups whose rows hold at
    most ``row_cells`` cells (B x C) and whose longest member is at most
    ``spread`` times the shortest (one group holds at least one)."""
    order = np.argsort(lengths, kind="stable")
    start = 0
    while start < len(order):
        end = start + 1
        lo = max(int(lengths[order[start]]), 1)
        while (end < len(order) and (end + 1 - start) * C <= row_cells
               and lengths[order[end]] <= spread * lo):
            end += 1
        yield order[start:end]
        start = end


def bounds(query, database, matrix, ext, *, device, row_cells=1 << 26) -> np.ndarray:
    """:func:`local_bound` of every database sequence."""
    lengths = np.array([len(s) for s in database])
    out = np.zeros(len(database))
    qv = torch.as_tensor(np.asarray(query, np.int64), device=device)
    m = torch.as_tensor(np.asarray(matrix, np.float64), device=device)
    for g in _groups(lengths, len(query), row_cells):
        t, tl = pad([database[i] for i in g], device)
        q = qv[None, :].expand(len(g), -1)
        ql = torch.full((len(g),), len(query), device=device, dtype=torch.int64)
        out[g] = local_bound(q, ql, t, tl, m, ext).double().cpu().numpy()
    return out


def exact_scores(query, seqs, matrix, del_, ext, *, device, dtype=torch.float64,
                 chunk=256):
    """Exact local scores of ``query`` against each of ``seqs``."""
    out = []
    m = torch.as_tensor(np.asarray(matrix, np.float64), device=device)
    for i in range(0, len(seqs), chunk):
        part = seqs[i:i + chunk]
        q, ql = pad([query] * len(part), device)
        t, tl = pad(part, device)
        out.append(local_fill_columns(q, ql, t, tl, m, del_, ext, dtype=dtype)
                   .f.double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def top_hits(query, database, matrix, del_, ext, k, *, device, dtype=torch.float64,
             first=64) -> list[Hit]:
    """The top ``k`` hits of ``query`` with their alignments."""
    bnd = bounds(query, database, matrix, ext, device=device)
    order = np.argsort(-bnd, kind="stable")
    exact: dict[int, float] = {}
    todo = [int(i) for i in order[:first]]
    while todo:
        for i, s in zip(todo, exact_scores(query, [database[i] for i in todo], matrix,
                                           del_, ext, device=device, dtype=dtype)):
            exact[i] = float(s)
        ranked = sorted(exact, key=lambda i: (-exact[i], i))
        kth = exact[ranked[min(k, len(ranked)) - 1]]
        todo = [int(i) for i in np.flatnonzero(bnd >= kth) if int(i) not in exact]
    top = sorted(exact, key=lambda i: (-exact[i], i))[:k]
    seqs = [database[i] for i in top]
    q, ql = pad([query] * len(top), device)
    t, tl = pad(seqs, device)
    r = local_fill_columns(q, ql, t, tl,
                           torch.as_tensor(np.asarray(matrix, np.float64), device=device),
                           del_, ext, dtype=dtype, with_dirs=True)
    w = traceback(r.dirs.cpu().numpy(), r.fy.cpu().numpy(), r.fx.cpu().numpy(),
                  q.cpu().numpy(), t.cpu().numpy(), by_column=True)
    return [Hit(i, exact[i], w.coords[j], w.query[j], w.target[j]) for j, i in enumerate(top)]
