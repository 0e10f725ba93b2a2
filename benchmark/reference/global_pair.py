"""Plain reference of one global pair: its end score H[R, C] and its
alignment, in plain PyTorch int32 a row at a time, independent of the
program.

Written from the reference aligner's global mode, ``simple/mod.rs:42-144``
and ``enums.rs:18-28``, as SURVEY.md §2.3 states them:

* the borders (item 5): H[0, x] = -x·del and H[y, 0] = -y·del, with the two
  far cells H[0, C] and H[R, 0] overwritten by -(len + 1)·del;
* the gap penalty (item 3): ``del`` at cell (1, 1) only, ``ext`` at every
  other cell (in global mode no cell is a Beginning, so the penalty state
  turns to ``ext`` after the first cell and stays there);
* a cell is the largest of top (H[y-1, x] less the penalty), left
  (H[y, x-1] less the penalty) and diagonal (H[y-1, x-1] plus the score of
  target code t[y-1] against query code q[x-1]), its direction the first of
  top, left, diagonal that equals it (item 4);
* the traceback (item 6): the aligned strings start with the last codes of
  both sequences, and the walk starts at [R, C], so that a first diagonal
  step repeats that pair; a top step takes a blank in the query and the
  target's code, a left step the query's code and a blank, a diagonal step
  both codes; the walk goes on along the borders (left on row 0, top on
  column 0) to [0, 0]; the coordinates are always ((1, C), (1, R)).

How it is computed.  A row is held shifted, K[y, x] = H[y, x] + ext·(x + y),
so that the left and top terms lose their penalty: top is K[y-1, x], left
K[y, x-1], diagonal K[y-1, x-1] + s + 2·ext, and a row is the running
maximum (``cummax``) of max(diagonal, top), with K[y, 0] in front; cell
(1, 1), whose penalty is ``del``, is computed on its own.  The running
maximum runs as a blocked scan over a (rows, ``chunk``) view of the row:
within each chunk, then each chunk raised to the largest value of the
chunks before it.  The forward pass keeps one
row in ``block_rows`` (a checkpoint).  Going back from [R, C], each row
block the path enters is filled again from its checkpoint, for the columns
up to the cursor's; its directions are computed by the rule above for a
window of ``window`` columns left of the cursor at a time, brought to the
host and walked there.
"""

from __future__ import annotations

import numpy as np
import torch

TOP, LEFT, DIAG = 0, 1, 2  # enums.rs:9-15
BLANK = 98  # the gap's code (enums.rs:55-136)


class _Rows:
    """The row scan: scratch for rows of up to ``width`` values of
    ``dtype`` and the diagonal terms ``prof`` (V, width - 1); ``neg`` is
    inert under max, far from the type's limit."""

    def __init__(self, width: int, chunk: int, prof, device, dtype):
        self.chunk, self.dtype, self.prof = chunk, dtype, prof
        self.m = -(-width // chunk)
        self.neg = torch.iinfo(dtype).min // 2
        self.a = torch.empty(width, dtype=dtype, device=device)
        self.loc = torch.empty((self.m, chunk), dtype=dtype, device=device)
        self.idx = torch.empty((self.m, chunk), dtype=torch.int64, device=device)
        self.cidx = torch.empty(self.m, dtype=torch.int64, device=device)
        # what each chunk is raised to: the largest value of the chunks
        # before it (none before the first)
        self.ex = torch.full((self.m,), self.neg, dtype=dtype, device=device)
        self._views = {}

    def buffer(self, device):
        return torch.full((self.m * self.chunk,), self.neg, dtype=self.dtype, device=device)

    def views(self, w: int):
        """The scratch's views for rows of ``w`` columns, taken once."""
        if w not in self._views:
            m = -(-w // self.chunk)
            loc, ex = self.loc[:m], self.ex[:m]
            self._views[w] = (m, self.a[:w - 1], [p[:w - 1] for p in self.prof], loc,
                              self.idx[:m], loc[:-1, -1], ex[1:], self.cidx[:m - 1],
                              ex[:, None])
        return self._views[w]

    def step(self, prev, out, w: int):
        """The fill of one row's ``w`` columns (0 … w - 1) from ``prev``
        into ``out``, its views taken once: ``step(code, first)`` fills
        K[y, :w] from K[y-1, :w], the row's target code and ``first`` =
        K[y, 0].  Past ``w``, to the end of its last chunk, ``out`` holds
        what the scan leaves there."""
        _, a, prows, *_ = self.views(w)
        p0, p1, o1 = prev[:w - 1], prev[1:w], out[1:w]
        scan = self.scan(out, w)

        def run(code: int, first: int) -> None:
            # max(diagonal, top) of columns 1 … w - 1
            torch.add(p0, prows[code], out=a)
            torch.maximum(a, p1, out=o1)
            scan(first)
        return run

    def scan(self, out, w: int):
        """The running maximum over ``out[:w]``, its views taken once:
        ``scan(first)`` puts ``first`` in front, then scans within each
        chunk and raises each chunk to the largest value of the chunks
        before it."""
        m, _, _, loc, idx, lasts, ex1, cidx, exc = self.views(w)
        o0, v = out[:1], out[:m * self.chunk].view(m, self.chunk)

        def run(first: int) -> None:
            o0.fill_(first)
            torch.cummax(v, 1, out=(loc, idx))
            torch.cummax(lasts, 0, out=(ex1, cidx))
            torch.maximum(loc, exc, out=v)
        return run


def _border(n: int, i: int, del_: int) -> int:
    """H[0, i] of a row of ``n`` columns (or H[i, 0] of ``n`` rows)."""
    return -(n + 1) * del_ if i == n and i > 0 else -i * del_


def global_pair(q, t, matrix, del_: int, ext: int, *, device, block_rows: int = 2048,
                window: int = 8192, chunk: int = 1024, dtype=torch.int32):
    """``(end, qa, ta, coords)`` of the global alignment of query ``q``
    (the columns) against target ``t`` (the rows): H[R, C], the aligned
    codes (int16, ``BLANK`` for a gap) and ((1, C), (1, R)).  ``matrix`` is
    an integral (V, V) table, indexed [target code, query code]; ``del_``
    and ``ext`` integral penalties.  Runs on ``device`` in int32, or in
    ``dtype`` (a narrower integer type wraps, as the card would)."""
    q = np.asarray(q, np.int64)
    t = np.asarray(t, np.int64)
    C, R = len(q), len(t)
    if C == 0 or R == 0:
        raise ValueError("empty sequence")
    del_, ext = int(del_), int(ext)
    info = torch.iinfo(dtype)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))

    def wrap(v: int) -> int:
        return (v - info.min) % (1 << info.bits) + info.min

    mt = np.round(np.asarray(matrix)).astype(np.int64)
    # the diagonal term of each target code against every query code, + 2·ext
    prof = torch.as_tensor((mt[:, q] + 2 * ext).astype(np_dtype), device=device)
    codes_t = t.tolist()
    d11 = del_ - ext  # what the gap terms of cell (1, 1) lose besides
    rows = _Rows(C + 1, chunk, prof, device, dtype)
    x = np.arange(C + 1, dtype=np.int64)
    top0 = (ext - del_) * x  # K[0, x]
    top0[C] = _border(C, C, del_) + ext * C
    first = [wrap(_border(R, y, del_) + ext * y) for y in range(R + 1)]  # K[y, 0]

    def row(prev, out, y: int, w: int) -> None:
        """Row ``y`` of K, ``w`` columns, into ``out`` from row y - 1 in
        ``prev``.  Row 1 is the one whose cell (1, 1) loses del, not ext, in
        its top and its left term; the left term enters the scan in front
        of the cell, and every later cell's left chain passes through it."""
        if y > 1:
            rows.step(prev, out, w)(codes_t[y - 1], first[y])
            return
        p = prof[codes_t[0], :w - 1]
        top = prev[1:w].clone()
        top[:1] -= d11
        torch.maximum(prev[:w - 1] + p, top, out=out[1:w])
        rows.scan(out, w)(wrap(first[1] - d11))
        out[:1].fill_(first[1])

    n_ck = (R + block_rows - 1) // block_rows
    ckpts = torch.empty((n_ck, C + 1), dtype=dtype, device=device)
    bufs = (rows.buffer(device), rows.buffer(device))  # row y in bufs[y % 2]
    bufs[0][:C + 1] = torch.as_tensor(top0.astype(np_dtype), device=device)
    steps = (rows.step(bufs[1], bufs[0], C + 1), rows.step(bufs[0], bufs[1], C + 1))
    for y in range(1, R + 1):
        if (y - 1) % block_rows == 0:
            ckpts[(y - 1) // block_rows] = bufs[(y - 1) % 2][:C + 1]
        if y == 1:
            row(bufs[0], bufs[1], 1, C + 1)
        else:
            steps[y % 2](codes_t[y - 1], first[y])
    end = wrap(int(bufs[R % 2][C]) - ext * (C + R))
    del bufs, steps

    codes = []
    cy, cx = R, C
    block = torch.empty((block_rows + 1, rows.m * chunk), dtype=dtype, device=device)
    while cy > 0 and cx > 0:
        j = (cy - 1) // block_rows
        y0 = j * block_rows
        block[0, :cx + 1] = ckpts[j, :cx + 1]
        for y in range(y0 + 1, cy + 1):
            row(block[y - y0 - 1], block[y - y0], y, cx + 1)
        while cy > y0 and cx > 0:
            xl = max(1, cx - window + 1)
            d = _directions(block, y0, cy, xl, cx, wrap(d11), first[1], wrap).cpu().numpy()
            while cy > y0 and cx >= xl:
                c = int(d[cy - y0 - 1, cx - xl])
                codes.append(c)
                cy -= c != LEFT
                cx -= c != TOP
    codes += [LEFT] * cx + [TOP] * cy  # the border row, or the border column
    ds = np.array(codes, np.uint8)
    up = ds != LEFT
    lf = ds != TOP
    y_at = R - (np.cumsum(up) - up)  # the cell each step leaves
    x_at = C - (np.cumsum(lf) - lf)
    qa = np.where(ds == TOP, BLANK, q[np.maximum(x_at, 1) - 1])
    ta = np.where(ds == LEFT, BLANK, t[np.maximum(y_at, 1) - 1])
    qa = np.concatenate([[q[-1]], qa])[::-1].astype(np.int16)
    ta = np.concatenate([[t[-1]], ta])[::-1].astype(np.int16)
    return end, np.ascontiguousarray(qa), np.ascontiguousarray(ta), ((1, C), (1, R))


def _directions(block, y0: int, y1: int, xl: int, xh: int, d11: int, k10: int, wrap):
    """The directions (uint8) of rows y0 + 1 … y1 and columns xl … xh of a
    row block held from its row y0 in ``block``, by the tie rule: top if the
    cell equals its top term, else left if it equals its left term, else
    diagonal.  ``d11`` is del - ext and ``k10`` K[1, 0], for cell (1, 1);
    ``wrap`` takes a number into the block's type."""
    h = y1 - y0
    cur = block[1:h + 1, xl:xh + 1]
    up = block[0:h, xl:xh + 1]
    left = block[1:h + 1, xl - 1:xh]
    d = torch.where(cur == up, TOP, torch.where(cur == left, LEFT, DIAG)).to(torch.uint8)
    if y0 == 0 and xl == 1:
        k11 = int(cur[0, 0])
        d[0, 0] = (TOP if k11 == wrap(int(up[0, 0]) - d11)
                   else LEFT if k11 == wrap(k10 - d11) else DIAG)
    return d
