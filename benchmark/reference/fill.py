"""The reference aligner's local fill and traceback, in plain PyTorch.

Written from the semantics of aligner-core (``simple/mod.rs:168-264``,
``enums.rs:9-46``), independently of the program under test:

* the plane is (R + 1) x (C + 1), rows the target, columns the query, its
  borders 0;
* the cells are filled column by column, and one penalty is carried
  through the fill: ``del`` before the first cell and after any cell whose
  direction is Beginning, ``ext`` after every other cell;
* a cell is ``max(up - pen, left - pen, diag + s)``, not clamped; its
  direction is Beginning when that maximum is exactly 0, else top, left,
  diagonal in that order, each matched within the float64 epsilon;
* the score ``f`` is the plane's maximum (borders included), the traceback
  starts at its first position in row-major order.

The fill runs by anti-diagonals over a batch of problems.  The penalty of
a cell in row 1 comes from the last cell of the previous column, which the
anti-diagonals reach later: a pass takes those penalties from the previous
pass's bottom row, and passes repeat until the two agree.  Each pass
settles at least one more column, so they end, and the columns agree with
the column-by-column order once they do.

:func:`local_fill_columns` is the same fill a column at a time, for
integral scoring, where sums are exact in any order: a column's vertical
gaps by a running maximum, its penalties settled by repeating the column
until they agree.  :func:`local_bound` is a cheaper upper bound of ``f``
for integral scoring, used to skip exact fills that cannot reach a top-k
list.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TOP, LEFT, DIAG, BEG = 0, 1, 2, 3
BLANK = 98  # the alphabet's gap code (enums.rs:55-167)
EPS = float(np.finfo(np.float64).eps)


@dataclasses.dataclass
class Fill:
    f: torch.Tensor  # (B,) the plane's maximum
    fy: torch.Tensor  # (B,) int64, its first row in row-major order (0: border)
    fx: torch.Tensor  # (B,) int64, its column
    dirs: torch.Tensor | None  # uint8: dirs[b, y + x, y] (by anti-diagonal), or
    passes: int  # dirs[b, x, y] (by column, ``by_column``)
    by_column: bool = False


def _pass(q, ql, t, tl, mats, topdel, del_, ext, dtype, with_dirs):
    """One anti-diagonal pass with the penalties of row 1 from ``topdel``
    (B, C + 2): True where the cell (1, x) takes ``del``."""
    dev = q.device
    B, C = q.shape
    R = t.shape[1]
    V = mats.shape[-1]
    mflat = mats.reshape(-1).to(dtype)
    tbase = t * V
    if mats.dim() == 3:
        tbase = tbase + torch.arange(B, device=dev)[:, None] * (V * V)
    d_del = torch.tensor(del_, dtype=dtype, device=dev)
    d_ext = torch.tensor(ext, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    h1 = torch.zeros(B, R + 1, dtype=dtype, device=dev)  # diagonal d - 1, by row
    h2 = torch.zeros(B, R + 1, dtype=dtype, device=dev)  # diagonal d - 2
    b1 = torch.zeros(B, R + 1, dtype=torch.bool, device=dev)  # Beginning on d - 1
    rowmax = torch.full((B, R), float("-inf"), dtype=dtype, device=dev)
    rowarg = torch.zeros(B, R, dtype=torch.int64, device=dev)
    bottom = torch.zeros(B, C + 2, dtype=torch.bool, device=dev)  # column C + 1: discard
    dirs = (torch.full((B, R + C + 1, R + 1), BEG, dtype=torch.uint8, device=dev)
            if with_dirs else None)
    ys_all = torch.arange(1, R + 1, device=dev)
    tl_c, ql_c = tl[:, None], ql[:, None]
    for d in range(2, R + C + 1):
        lo, hi = max(1, d - C), min(R, d - 1)
        ys = ys_all[lo - 1:hi]
        xs = d - ys
        begprev = b1[:, lo - 1:hi]
        if lo == 1:
            begprev = begprev.clone()
            begprev[:, 0] = topdel[:, d - 1]
        pen = torch.where(begprev, d_del, d_ext)
        s = mflat[tbase[:, lo - 1:hi] + q[:, xs - 1]]
        top = h1[:, lo - 1:hi] - pen
        left = h1[:, lo:hi + 1] - pen
        dg = h2[:, lo - 1:hi] + s
        m = torch.maximum(torch.maximum(top, left), dg)
        valid = (ys <= tl_c) & (xs <= ql_c)
        beg = valid & (m == 0)
        m = torch.where(valid, m, zero)
        h = torch.zeros_like(h1)
        h[:, lo:hi + 1] = m
        b = torch.zeros_like(b1)
        b[:, lo:hi + 1] = beg
        seg_max, seg_arg = rowmax[:, lo - 1:hi], rowarg[:, lo - 1:hi]
        upd = valid & (m > seg_max)
        rowmax[:, lo - 1:hi] = torch.where(upd, m, seg_max)
        rowarg[:, lo - 1:hi] = torch.where(upd, xs, seg_arg)
        # the bottom row's Beginning flags, the penalties of the next pass
        xb = d - tl
        at = (tl >= lo) & (tl <= hi) & (xb >= 1) & (xb <= ql)
        flag = beg.gather(1, (tl - lo).clamp(0, hi - lo)[:, None])[:, 0] & at
        bottom.scatter_(1, torch.where(at, xb, C + 1)[:, None], flag[:, None])
        if with_dirs:
            dr = torch.where((top - m).abs() < EPS, TOP,
                             torch.where((left - m).abs() < EPS, LEFT, DIAG))
            dr = torch.where(beg | ~valid, BEG, dr)
            dirs[:, d, lo:hi + 1] = dr.to(torch.uint8)
        h2, h1, b1 = h1, h, b
    best = rowmax.max(dim=1).values
    f = torch.maximum(best, zero)
    hit = rowmax == f[:, None]
    fy0 = hit.to(torch.int32).argmax(dim=1)
    pos = f > 0
    fy = torch.where(pos, fy0 + 1, 0)
    fx = torch.where(pos, rowarg.gather(1, fy0[:, None])[:, 0], 0)
    return f, fy, fx, dirs, bottom


def local_fill(q, ql, t, tl, mats, del_, ext, *, dtype=torch.float64,
               with_dirs=False, max_passes=10_000) -> Fill:
    """The reference's local fill of a batch: query codes ``q`` (B, C) and
    target codes ``t`` (B, R), int64 and padded, their lengths ``ql``,
    ``tl`` (B,), and one (V, V) matrix or one a problem (B, V, V), all on
    one device.  ``dtype`` is the arithmetic's (float64 is the reference's
    own; a lower one makes a control)."""
    dev = q.device
    B, C = q.shape
    R = t.shape[1]
    f = torch.zeros(B, dtype=dtype, device=dev)
    fy = torch.zeros(B, dtype=torch.int64, device=dev)
    fx = torch.zeros(B, dtype=torch.int64, device=dev)
    dirs = (torch.full((B, R + C + 1, R + 1), BEG, dtype=torch.uint8, device=dev)
            if with_dirs else None)
    topdel = torch.zeros(B, C + 2, dtype=torch.bool, device=dev)
    topdel[:, 1] = True
    todo = torch.arange(B, device=dev)
    passes = 0
    while todo.numel():
        if passes == max_passes:
            raise RuntimeError("the reference fill's row-1 penalties did not settle")
        passes += 1
        sub = mats[todo] if mats.dim() == 3 else mats
        used = topdel[todo]
        pf, pfy, pfx, pdirs, bottom = _pass(q[todo], ql[todo], t[todo], tl[todo], sub,
                                            used, del_, ext, dtype, with_dirs)
        nxt = torch.zeros_like(used)
        nxt[:, 1] = True
        nxt[:, 2:C + 2] = bottom[:, 1:C + 1]
        # only the columns of each problem's own query carry a penalty
        cols = torch.arange(C + 2, device=dev)[None, :]
        nxt &= cols <= ql[todo][:, None]
        changed = (nxt != (used & (cols <= ql[todo][:, None]))).any(dim=1)
        done = todo[~changed]
        keep = ~changed
        f[done], fy[done], fx[done] = pf[keep], pfy[keep], pfx[keep]
        if with_dirs:
            dirs[done] = pdirs[keep]
        topdel[todo] = nxt
        todo = todo[changed]
    return Fill(f, fy, fx, dirs, passes)


def local_fill_columns(q, ql, t, tl, matrix, del_, ext, *, dtype=torch.float64,
                       with_dirs=False) -> Fill:
    """:func:`local_fill` a column at a time, for integral scoring and one
    (V, V) matrix.  In column x, with the penalties ``p`` of its rows, a
    cell is ``max(c_y, H[y-1] - p_y)`` with ``c_y = max(left - p_y, diag
    + s)``, so ``H = cummax(c + P) - P`` with ``P`` the running sum of
    ``p`` (row 0, the border, 0): exact while the integers fit the dtype.
    The penalties follow from the column's own Beginning cells, so the
    column repeats until they agree; row 1's comes from the previous
    column's last cell, known by then."""
    dev = q.device
    B, C = q.shape
    R = t.shape[1]
    m = matrix.to(dtype).reshape(-1)
    V = matrix.shape[-1]
    tV = t * V
    d_del = torch.tensor(del_, dtype=dtype, device=dev)
    d_ext = torch.tensor(ext, dtype=dtype, device=dev)
    rows_ok = torch.arange(1, R + 1, device=dev)[None, :] <= tl[:, None]
    hp = torch.zeros(B, R + 1, dtype=dtype, device=dev)
    carry = torch.ones(B, dtype=torch.bool, device=dev)  # x = 1 starts with del
    rowmax = torch.full((B, R), float("-inf"), dtype=dtype, device=dev)
    rowarg = torch.zeros(B, R, dtype=torch.int64, device=dev)
    dirs = (torch.full((B, C + 1, R + 1), BEG, dtype=torch.uint8, device=dev)
            if with_dirs else None)
    zcol = torch.zeros(B, 1, dtype=dtype, device=dev)
    bidx = torch.arange(B, device=dev)
    bottom = (tl - 1).clamp(min=0)
    rounds = 0
    for x in range(1, C + 1):
        s = m[tV + q[:, x - 1:x]]
        diag = hp[:, :-1] + s
        flags = torch.zeros(B, R, dtype=torch.bool, device=dev)
        flags[:, 0] = carry
        while True:
            rounds += 1
            pen = torch.where(flags, d_del, d_ext)
            c = torch.maximum(hp[:, 1:] - pen, diag)
            big_p = torch.cat([zcol, torch.cumsum(pen, dim=1)], dim=1)
            h = torch.cummax(torch.cat([zcol, c], dim=1) + big_p, dim=1).values - big_p
            col = h[:, 1:]
            beg = rows_ok & (col == 0)
            nxt = torch.cat([carry[:, None], beg[:, :-1]], dim=1)
            if torch.equal(nxt, flags):
                break
            flags = nxt
        valid = rows_ok & (x <= ql)[:, None]
        upd = valid & (col > rowmax)
        rowmax = torch.where(upd, col, rowmax)
        rowarg = torch.where(upd, x, rowarg)
        if with_dirs:
            top = h[:, :-1] - pen
            left = hp[:, 1:] - pen
            dr = torch.where((top - col).abs() < EPS, TOP,
                             torch.where((left - col).abs() < EPS, LEFT, DIAG))
            dirs[:, x, 1:] = torch.where(beg | ~valid, BEG, dr).to(torch.uint8)
        carry = beg[bidx, bottom]
        hp = h
    best = rowmax.max(dim=1).values
    f = torch.maximum(best, torch.zeros((), dtype=dtype, device=dev))
    fy0 = (rowmax == f[:, None]).to(torch.int32).argmax(dim=1)
    pos = f > 0
    fy = torch.where(pos, fy0 + 1, 0)
    fx = torch.where(pos, rowarg.gather(1, fy0[:, None])[:, 0], 0)
    return Fill(f, fy, fx, dirs, rounds, by_column=True)


def local_bound(q, ql, t, tl, matrix, ext, *, dtype=torch.float32) -> torch.Tensor:
    """An upper bound of :func:`local_fill`'s ``f`` for each problem: the
    fill with the smaller penalty ``ext`` on every gap and a clamp at 0,
    which no cell of the reference's fill exceeds (by induction over the
    cells, since its penalties are ``del >= ext`` or ``ext``).  Rows of the
    target one at a time, the gaps along a row by a running maximum;
    exact for integral scoring while the scores stay below 2^24 in
    float32."""
    dev = q.device
    B, C = q.shape
    R = t.shape[1]
    m = matrix.to(dtype)
    xext = torch.arange(C + 1, device=dev, dtype=dtype) * ext
    g = torch.zeros(B, C + 1, dtype=dtype, device=dev)
    colmask = torch.arange(1, C + 1, device=dev)[None, :] <= ql[:, None]
    best = torch.zeros(B, dtype=dtype, device=dev)
    zero = torch.zeros(B, 1, dtype=dtype, device=dev)
    for y in range(R):
        s = m[t[:, y:y + 1], q]
        inner = torch.maximum(g[:, 1:] - ext, g[:, :-1] + s).clamp_min(0)
        g = torch.cummax(torch.cat([zero, inner], dim=1) + xext, dim=1).values - xext
        row = torch.where(colmask, g[:, 1:], 0).max(dim=1).values
        best = torch.where(y < tl, torch.maximum(best, row), best)
    return best


@dataclasses.dataclass
class Walk:
    query: list  # per problem: int16 codes with BLANK, in alignment order
    target: list
    coords: list  # ((x_start, x_end), (y_start, y_end)), 1-based as the reference


def traceback(dirs: np.ndarray, fy, fx, q: np.ndarray, t: np.ndarray, *,
              by_column: bool = False) -> Walk:
    """The reference's local traceback (simple/mod.rs:212-242) of each
    problem from its argmax, all problems a step at a time: the argmax
    cell's characters first, then a character pair for every step until a
    Beginning cell.  ``dirs`` (B, R + C + 1, R + 1) by anti-diagonal (or
    (B, C + 1, R + 1) by column, ``by_column``), ``q``
    (B, C) and ``t`` (B, R) the codes; a problem whose argmax lies on a
    border has no alignment (None)."""
    B = dirs.shape[0]
    fy = np.asarray(fy, np.int64).copy()
    fx = np.asarray(fx, np.int64).copy()
    alive = (fy > 0) & (fx > 0)
    L = q.shape[1] + t.shape[1] + 2
    qa = np.full((B, L), BLANK, np.int16)
    ta = np.full((B, L), BLANK, np.int16)
    n = np.zeros(B, np.int64)
    bi = np.arange(B)
    cy, cx = fy.copy(), fx.copy()
    a = np.flatnonzero(alive)
    qa[a, 0] = q[a, fx[a] - 1]
    ta[a, 0] = t[a, fy[a] - 1]
    n[a] = 1
    act = alive.copy()
    while act.any():
        i = bi[act]
        y, x = cy[i], cx[i]
        dr = dirs[i, x, y] if by_column else dirs[i, y + x, y]
        go = dr != BEG
        i, y, x, dr = i[go], y[go], x[go], dr[go]
        act[bi[act][~go]] = False
        if i.size == 0:
            break
        up = dr != LEFT  # TOP and DIAG move up
        lf = dr != TOP  # LEFT and DIAG move left
        qa[i, n[i]] = np.where(lf, q[i, np.maximum(x - 1, 0)], BLANK)
        ta[i, n[i]] = np.where(up, t[i, np.maximum(y - 1, 0)], BLANK)
        n[i] += 1
        cy[i] = y - up
        cx[i] = x - lf
    out_q, out_t, coords = [], [], []
    for b in range(B):
        if not alive[b]:
            out_q.append(None)
            out_t.append(None)
            coords.append(None)
            continue
        out_q.append(qa[b, :n[b]][::-1].copy())
        out_t.append(ta[b, :n[b]][::-1].copy())
        coords.append(((int(cx[b]) + 1, int(fx[b]) + 1), (int(cy[b]) + 1, int(fy[b]) + 1)))
    return Walk(out_q, out_t, coords)


def pad(seqs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes of ragged sequences as one (B, max) int64 tensor, padded with
    0, and their lengths."""
    n = max((len(s) for s in seqs), default=0)
    out = np.zeros((len(seqs), max(n, 1)), np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    lens = np.array([len(s) for s in seqs], np.int64)
    return (torch.as_tensor(out, device=device), torch.as_tensor(lens, device=device))
