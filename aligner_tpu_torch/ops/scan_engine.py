"""Batched exact DP fill in plain PyTorch — the plain version of the fill
kernel (``csrc/dp_fill.cu``) and the port's CPU engine.

Counterpart of ``aligner_tpu/ops/scan_engine.py``: pair mode
(:func:`fill_batch`) and PWM mode (:func:`fill_pwm_batch`), one penalty
chain (:func:`_fill_core`) under two score lookups.  The
reference's single mutable gap-penalty state couples every cell to its
fill-order predecessor, and the first cell of each column to the last
cell of the previous column, so each problem is serial cell by cell and
the parallel axis is the batch: every tensor op below works on all B
problems at once while the loops walk the cells in column-major order.

Only the penalty chain is serial.  Per column, the score lookup, the
diagonal term, the direction codes, the packing and the argmax are
vectorised over the rows once the chain has produced the column.

Variable lengths: problems are right-padded to (R, C); a cell is active
when ``x <= qlen`` and ``y <= tlen``.  An inactive cell stores 0 and keeps
the penalty, so padded execution equals per-problem execution.  Rows are
padded to a multiple of 8 (one packed direction word per 8 rows); the
padded rows are inactive.

Semantics (bit-identical to the oracle and to the JAX engines):

* ties top > left > diagonal by ``m - v < eps`` (dtype epsilon);
  ``m == 0`` → Beginning in local mode;
* penalty := ext after a non-Beginning cell, del after Beginning;
* global border ``-(i)*del`` with far corners ``-(len+1)*del``;
* local argmax = first maximum in row-major order, from (0, 0, 0).
"""

from __future__ import annotations

import dataclasses

import torch

from ..oracle import BEG, DIAG, LEFT, TOP  # noqa: F401  (one definition)


@dataclasses.dataclass
class FillResult:
    """Outputs of a batched fill, all (B,) tensors on the fill's device.

    ``fmax``/``fy``/``fx``: the running maximum and its first row-major
    cell (zeros for ``fy``/``fx``/``end`` when argmax tracking is off);
    ``end``: ``a[tlen, qlen]`` (the global end score).  ``words``: packed
    directions (B, R8/8, C) int32 — 8 two-bit codes per word, row
    ``r`` at bit ``2·(r % 8)`` — or None in scores-only mode.  ``plane``:
    the interior of the score plane, (B, C, R8) in the fill's dtype with
    ``plane[b, x - 1, y - 1] = a[y, x]`` (each column's rows contiguous; 0
    at inactive cells), or None; it comes only with ``words``
    (:func:`aligner_tpu_torch.ops.dp_fill.planes_from_interior` adds the
    borders).
    """

    fmax: torch.Tensor
    fy: torch.Tensor
    fx: torch.Tensor
    end: torch.Tensor
    words: torch.Tensor | None = None
    plane: torch.Tensor | None = None


def round8(n: int) -> int:
    return -(-n // 8) * 8


def fill_batch(q, qlen, t, tlen, matrix, del_: float, ext: float, *,
               mode: str = "local", track_argmax: bool = True,
               with_dirs: bool = False, with_scores_plane: bool = False) -> FillResult:
    """Plain batched fill.

    ``q``: (B, C) int32 query codes (columns); ``t``: (B, R) int32 target
    codes (rows); ``qlen``/``tlen``: (B,) int32; ``matrix``: (V, V) shared
    or (B, V, V) per-problem, in the working float dtype.  Global mode
    always tracks the argmax (the end cell is captured there), and so does
    a fill with the score plane, which comes only with the directions
    (``pallas_dp.fill_batch_pallas``'s ``scores_plane and with_planes``).
    """
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be local|global, got {mode!r}")
    V = matrix.shape[-1]
    qc = q.to(torch.int64)
    if matrix.dim() == 3:
        flat = matrix.reshape(-1, V * V)

        def score(x1, tT):  # s[y, b] = matrix[b, t[y], q[x]]
            return flat.gather(1, (tT * V + qc[:, x1 - 1][None, :]).T).T
    else:
        flat = matrix.reshape(V * V)

        def score(x1, tT):
            return flat[tT * V + qc[:, x1 - 1][None, :]]

    return _fill_core(qlen, t, tlen, q.shape[1], score, matrix.dtype, del_, ext,
                      is_global=mode == "global", track_argmax=track_argmax,
                      with_dirs=with_dirs, with_plane=with_dirs and with_scores_plane)


def fill_pwm_batch(q, qlen, pwm, del_: float, ext: float, *,
                   track_argmax: bool = True, with_dirs: bool = False,
                   with_scores_plane: bool = False) -> FillResult:
    """Plain batched query-vs-PWM fill (local).

    The plane is (qlen+1, W+1): rows are query positions, columns PWM
    positions, and every column is active.  ``q``: (B, R) int32 codes in
    [0, 4); ``qlen``: (B,) int32; ``pwm``: (4, W) shared or (B, 4, W)
    per-problem, in the working float dtype.  The score of cell (y, x) is
    ``pwm[q[y-1], x-1]``.  ``with_scores_plane`` as in :func:`fill_batch`.
    """
    W = pwm.shape[-1]
    if pwm.dim() == 3:
        flat = pwm.reshape(-1, pwm.shape[-2] * W)

        def score(x1, tT):  # s[y, b] = pwm[b, q[y], x-1]
            return flat.gather(1, (tT * W + (x1 - 1)).T).T
    else:

        def score(x1, tT):
            return pwm[:, x1 - 1][tT]

    B = q.shape[0]
    full = torch.full((B,), W, dtype=torch.int64, device=q.device)
    return _fill_core(full, q, qlen, W, score, pwm.dtype, del_, ext,
                      is_global=False, track_argmax=track_argmax,
                      with_dirs=with_dirs, with_plane=with_dirs and with_scores_plane)


def _fill_core(qlen, t, tlen, C: int, score, dtype, del_: float, ext: float, *,
               is_global: bool, track_argmax: bool, with_dirs: bool,
               with_plane: bool = False) -> FillResult:
    """The penalty chain of both modes.  ``t`` (B, R) holds the row codes
    and ``qlen`` the active columns; ``score(x1, tT)`` gives column
    ``x1``'s (R8, B) scores from the row codes ``tT`` (R8, B) int64."""
    track_argmax = track_argmax or is_global or with_plane
    dev = t.device
    B, R = t.shape
    R8 = round8(R)
    if R8 != R:
        t = torch.nn.functional.pad(t, (0, R8 - R))
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    tT = t.T.to(torch.int64)  # (R8, B)
    ys = torch.arange(1, R8 + 1, device=dev)[:, None]  # (R8, 1)
    DEL = torch.tensor(del_, dtype=dtype, device=dev)
    EXT = torch.tensor(ext, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, device=dev)
    qlf = qlen.to(dtype)

    if is_global:
        yy = torch.arange(R8 + 1, device=dev)[:, None]
        col = torch.where(yy == tlen[None, :], -(tlen.to(dtype)[None, :] + 1) * DEL,
                          -yy.to(dtype) * DEL)
    else:
        col = torch.zeros((R8 + 1, B), dtype=dtype, device=dev)

    pen = DEL.expand(B).clone()
    bv = torch.zeros(B, dtype=dtype, device=dev)
    by = torch.zeros(B, dtype=torch.int64, device=dev)
    bx = torch.zeros(B, dtype=torch.int64, device=dev)
    ev = torch.zeros(B, dtype=dtype, device=dev)
    words = (torch.zeros((B, R8 // 8, C), dtype=torch.int32, device=dev)
             if with_dirs else None)
    plane = torch.zeros((B, C, R8), dtype=dtype, device=dev) if with_plane else None
    shifts = (2 * torch.arange(8, device=dev, dtype=torch.int64))[None, :, None]
    row_active = ys <= tlen[None, :]  # (R8, B)

    for x1 in range(1, C + 1):
        s = score(x1, tT)  # (R8, B)
        active = row_active & (x1 <= qlen)[None, :]
        if is_global:
            border0 = torch.where(qlen == x1, -(qlf + 1) * DEL, -x1 * DEL)
        else:
            border0 = torch.zeros(B, dtype=dtype, device=dev)
        diag = col[:-1] + s
        left_raw = col[1:]
        # the serial penalty chain: pens[y] is the penalty cell y reads
        ms = torch.empty((R8, B), dtype=dtype, device=dev)
        vals = torch.empty((R8, B), dtype=dtype, device=dev)
        pens = torch.empty((R8 + 1, B), dtype=dtype, device=dev)
        pens[0] = pen
        a_up = border0
        for y in range(R8):
            # max(a-p, b-p) == max(a, b) - p exactly (rounding is monotone)
            m = torch.maximum(torch.maximum(a_up, left_raw[y]) - pens[y], diag[y],
                              out=ms[y])
            nxt = EXT if is_global else torch.where(m == 0, DEL, EXT)
            torch.where(active[y], nxt, pens[y], out=pens[y + 1])
            torch.where(active[y], m, zero, out=vals[y])
            a_up = vals[y]
        pen = pens[R8]

        if with_dirs:
            top = torch.cat([border0[None], vals[:-1]]) - pens[:-1]
            left = left_raw - pens[:-1]
            d = torch.where(ms - top < eps, TOP, torch.where(ms - left < eps, LEFT, DIAG))
            if not is_global:
                d = torch.where(ms == 0, BEG, d)
            d = torch.where(active, d, BEG).to(torch.int64)
            packed = (d.reshape(R8 // 8, 8, B) << shifts).sum(1)  # (R8/8, B)
            words[:, :, x1 - 1] = _wrap_i32(packed).T
        if with_plane:
            plane[:, x1 - 1] = vals.T

        if track_argmax:
            masked = torch.where(active, ms, neg_inf)
            cm = masked.max(0).values
            cy = torch.where(masked == cm[None, :], ys, R8 + 1).min(0).values
            better = (cm > bv) | ((cm == bv) & (cy < by))
            bv = torch.where(better, cm, bv)
            by = torch.where(better, cy, by)
            bx = torch.where(better, torch.full_like(bx, x1), bx)
            at_end = (qlen == x1) & (tlen >= 1)
            m_end = ms.gather(0, (tlen - 1).clamp(0, R8 - 1)[None, :])[0]
            ev = torch.where(at_end, m_end, ev)
        else:
            bv = torch.maximum(bv, vals.max(0).values)
        col = torch.cat([border0[None], vals])

    i32 = torch.int32
    if not track_argmax:
        by, bx, ev = torch.zeros_like(by), torch.zeros_like(bx), torch.zeros_like(ev)
    return FillResult(fmax=bv, fy=by.to(i32), fx=bx.to(i32), end=ev, words=words,
                      plane=plane)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding 32 packed bits → the int32 with the same bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
