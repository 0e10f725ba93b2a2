"""Batched alignment: the port's main path.

:func:`batch_align` → :func:`_fill` → one fill kernel over B independent
(query, target) problems (``ops/dp_fill.py``) → with alignments, one
batched walk over the packed direction words (``ops/device_walk.py``) →
host decode.  The PWM path is the same in PWM mode:
:func:`batch_align_pwm` → :func:`_fill_pwm` → the kernel's PWM
specialisation → the walk in local mode → :func:`decode_pwm_batch`.
One huge global pair has no batch axis: :func:`align_global` runs it on
the row-scan fill and the replay walk, and :func:`global_end_score` gives
its end score alone on the band fill (``ops/wavefront.py``); a pair wider
than one plane, or ``backend="wavefront_sp"``, takes the column-blocked
pipeline (``parallel/wavefront_sp.py``), whose engine is picked there, and
so does a pair above ``DIRECT_PLANE_CELLS`` when the auto-shard sees
several cards: its column blocks are then spread over them.
Counterparts of ``aligner_tpu.align.batch_align``/``batch_align_pwm``/
``align_pwm``/``align_global``/``align_local``/``global_end_score``/
``local_max_score`` and bit-identical to them.

``device=None`` means the card (the kernels) and raises
:class:`~aligner_tpu_torch.errors.DeviceUnavailable` without one;
``device="cpu"`` asks for the plain PyTorch versions.  The dtype follows
the data (:func:`aligner_tpu_torch.backend.dtype_for`): float32 on CUDA
only for integer-valued scoring, float64 otherwise and on the CPU.

The port does not read ``ALIGNER_DEVICE_WALK``.  The JAX package reads it
to send a traceback to a per-cell walk on the host; here that walk is asked
for by name, ``walk="host"`` (on :func:`batch_align`, :func:`batch_align_pwm`,
:func:`align_global`, :func:`align_local`, :func:`align_pwm`, and on the
huge-pair and column-blocked pipelines), and setting the variable changes
nothing.  By default (``walk="device"``) every walk runs on the device where
the directions lie; under ``walk="host"`` the direction words come to the
host and no walk kernel is launched.

``keep_planes`` on :func:`align_global` and :func:`align_local` returns the
pair's dense score and direction planes (``AlignmentResult.score``,
``.directions``), as the reference's simple aligners do
(:class:`SimpleGlobalAligner`, :class:`SimpleLocalAligner`, which default
it to true): the pair is filled as a batch of one with the score plane, and
walked on the host over the returned directions.

Every batched fill shards its problems over this process's cards
(:func:`_auto_shard_devices`, as ``aligner_tpu.align`` shards over its
devices): the batch is padded with zero-length problems to a multiple of the
card count, each card fills a contiguous share with its own copy of the
scoring state, and the scores come back in batch order on the caller's
device; with alignments each share's words are walked on their card.  Each
problem's fill is independent of the others', so the results are
bit-identical to one card's.  ``ALIGNER_AUTO_SHARD=0`` keeps every fill on
the one device; so does a device with an index (``"cuda:1"``), a batch of
one and a fill with its score plane.

:func:`batch_align` launches its fill and waits for it.  The search's
length buckets take :class:`ScorePass` instead: each bucket a
:class:`TargetBucket`, padded, checked and sent once and then kept on the
cards, its launch on a stream of its own, and one wait for all of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from .alphabet import DNA, Alphabet, Protein
from .backend import dtype_for, integral_params, resolve_device
from .errors import MatrixShapeError, ResultIsEmpty, UnnecessaryArgument, ValidationError
from .observability import PAIR_ENGINES, count, counters, measure, span, synchronize
from .ops.scan_engine import FillResult
from .result import Alignment, AlignmentResult, PWMAlignment
from .traceback import traceback_global, traceback_local, traceback_pwm


def _check_walk(walk) -> None:
    if walk not in ("device", "host"):
        raise ValidationError(f"walk must be device or host, got {walk!r}")


def _on_host(device) -> bool:
    """``device="host"``: the host engine (native C++), not a torch device."""
    return isinstance(device, str) and device == "host"


def _encode(seq, alphabet: type[Alphabet]) -> np.ndarray:
    if isinstance(seq, (str, bytes)):
        return alphabet.encode(seq)
    return np.asarray(seq, dtype=np.int8)


def pad_batch(
    seqs: Sequence[np.ndarray], multiple: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad code arrays to a shared length (rounded up to ``multiple``
    to bound the number of distinct shapes)."""
    if not seqs:
        raise ValidationError("empty batch")
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    width = max(int(lens.max()), 1)
    width = -(-width // multiple) * multiple
    out = np.zeros((len(seqs), width), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lens


@dataclasses.dataclass
class BatchScores:
    """Scores-only batched result (no planes, no traceback).

    ``fmax``: local max score per problem; ``fy``/``fx``: its plane coords
    (first maximum in row-major order); ``end``: a[tlen, qlen].
    """

    fmax: np.ndarray
    fy: np.ndarray
    fx: np.ndarray
    end: np.ndarray


def _shard_devices(device: torch.device) -> list[torch.device]:
    """Every device a batched fill on ``device`` may shard over: this
    process's visible cards for ``"cuda"`` with no index, else ``device``
    alone (a named card, the CPU)."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _auto_shard_devices(device: torch.device) -> list[torch.device]:
    """The shards of a batched fill on ``device``: :func:`_shard_devices`,
    or ``device`` alone under ``ALIGNER_AUTO_SHARD=0``."""
    if os.environ.get("ALIGNER_AUTO_SHARD", "1") == "0":
        return [device]
    return _shard_devices(device)


def _engine_name(device: torch.device, shards, mode: str) -> str:
    """The counter of a fill: ``"cuda/local"``, or ``"cudax2/local"`` over
    two shards (the reference's ``f"{backend}x{ndev}/{mode}"``)."""
    n = len(shards)
    return f"{device.type}x{n}/{mode}" if n > 1 else f"{device.type}/{mode}"


def _dev_i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)


def _shared_row(a) -> bool:
    """``a`` (B, C) is one row that every problem reads: a batch axis of
    stride 0 (``np.broadcast_to``), as :func:`batch_align` builds for a
    batch of one query."""
    return a.ndim == 2 and len(a) > 0 and a.strides[0] == 0


def _pad_batch_rows(arrs, B: int, Bp: int):
    """Right-pad the batch axis of each array with zeros to Bp rows (a
    :func:`_shared_row` is broadcast to Bp rows instead)."""
    return [a if len(a) == Bp
            else np.broadcast_to(a[0], (Bp, a.shape[1])) if _shared_row(a)
            else np.pad(a, [(0, Bp - B)] + [(0, 0)] * (a.ndim - 1))
            for a in arrs]


def _assemble_sharded_fill(parts, B: int, per: int, device) -> FillResult:
    """The shards' FillResults (``per`` rows each, in batch order) as one
    FillResult of the B real rows: the scores on ``device``, and with
    directions ``words`` as the tuple of the shards' words of real rows,
    each left on its card (:func:`~aligner_tpu_torch.ops.device_walk.walk_batch`
    walks them there).  Shards of padding alone drop out.  One shard's
    result is returned as it is (no padding, ``words`` one tensor, the
    score plane kept)."""
    if len(parts) == 1:
        return parts[0]
    real = [(r, min(per, B - k * per)) for k, r in enumerate(parts) if k * per < B]

    def cat(field):
        return torch.cat([getattr(r, field)[:n].to(device) for r, n in real])

    words = (tuple(r.words[:n] for r, n in real)
             if parts[0].words is not None else None)
    return FillResult(cat("fmax"), cat("fy"), cat("fx"), cat("end"), words)


class _Sent:
    """What a run of fills sends to each device once, by (device, key): a
    shared scoring state, a shared query row.  On a card each upload is
    followed by an event on the stream it went on, and a fill that reads it
    later waits for that event first (on another stream, as the batches of
    :class:`ScorePass` are, it would otherwise not)."""

    def __init__(self):
        self._sent = {}

    def get(self, dev: torch.device, key, make):
        """``(obj, new)``: what went to ``dev`` under ``key``, made by
        ``make()`` on the device's current stream the first time (``new``
        true then)."""
        hit = self._sent.get((dev, key))
        if hit is not None:
            obj, event = hit
            if event is not None:
                torch.cuda.current_stream(dev).wait_event(event)
            return obj, False
        obj, event = make(), None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self._sent[dev, key] = obj, event
        return obj, True


def _launch_shards(fill_cls, scoring, rows, del_, ext, dtype, devices, sent: _Sent,
                   **call) -> list[FillResult]:
    """Upload and launch a batched fill split over ``devices`` (one shard
    each, a device may repeat; one device is one launch of the whole
    batch), and return the shards' FillResults unread, ``-(-B // n)`` rows
    each.

    ``fill_cls``: :class:`~aligner_tpu_torch.ops.dp_fill.DPFill` with
    ``rows`` (q, ql, t, tl), or :class:`~aligner_tpu_torch.ops.dp_fill.PWMFill`
    with ``rows`` (q, ql); ``scoring``: a shared (V, V) matrix or (4, W)
    PWM, which goes to each device once in ``sent``, or per-problem
    (B, ...) ones, which split with the batch; a :func:`_shared_row` of
    ``rows`` also goes to each device once in ``sent``, as one (C,) row
    that every shard expands over its problems; ``call``: the fill's
    keyword arguments.
    B is padded with zero-length problems to a multiple of the shard count
    and split into contiguous shards."""
    B = len(rows[1])
    n = len(devices)
    per = -(-B // n)
    scoring = np.asarray(scoring)
    batched = scoring.ndim == 3
    rows = _pad_batch_rows(rows, B, per * n)
    if batched:
        (scoring,) = _pad_batch_rows([scoring], B, per * n)
    parts = []
    for k, dev in enumerate(devices):
        part = slice(k * per, (k + 1) * per)
        with span("fill.upload") as sp:
            if batched:
                dp, new = fill_cls.from_numpy(scoring[part], del_, ext, device=dev,
                                              dtype=dtype), True
            else:
                dp, new = sent.get(dev, ("scoring", dtype), lambda: fill_cls.from_numpy(
                    scoring, del_, ext, device=dev, dtype=dtype))
            scoring_bytes = sum(b.nbytes for b in dp.buffers()) if new else 0
            args, row_bytes = [], []  # each row's tensor, and the bytes it sent here
            for i, a in enumerate(rows):
                if not _shared_row(a):
                    args.append(_dev_i32(a[part], dev))
                    row_bytes.append(args[-1].nbytes)
                    continue
                # a[0] is a read-only view: its copy is one row
                row, new = sent.get(dev, ("row", i), lambda: _dev_i32(a[0].copy(), dev))
                args.append(row.expand(per, -1))
                row_bytes.append(row.nbytes if new else 0)
            sp.count(h2d_bytes=scoring_bytes + sum(row_bytes), query_bytes=row_bytes[0])
        with span("fill.launch"):
            parts.append(dp(*args, **call))
    return parts


def _fill_sharded(fill_cls, scoring, rows, del_, ext, dtype, devices, device,
                  **call) -> FillResult:
    """A batched fill split over ``devices`` by :func:`_launch_shards`:
    every shard is launched before any is read; the result is
    :func:`_assemble_sharded_fill`'s, on ``device``."""
    parts = _launch_shards(fill_cls, scoring, rows, del_, ext, dtype, devices, _Sent(),
                           **call)
    return _assemble_sharded_fill(parts, len(rows[1]), len(parts[0].fmax), device)


def _host_words(words, n: int) -> torch.Tensor:
    """The first ``n`` problems' direction words on the host, from one
    tensor or from the shards' tuple (:func:`_assemble_sharded_fill`), read
    shard by shard in batch order."""
    out = []
    for w in words if isinstance(words, tuple) else (words,):
        if n <= 0:
            break
        out.append(w[:n].cpu())
        n -= len(w)
    return out[0] if len(out) == 1 else torch.cat(out)


def _cells(ql, tl) -> int:
    return int((np.asarray(ql, np.int64) * np.asarray(tl, np.int64)).sum())


def _refuse_codes(name: str, lo: int, hi: int, matrix) -> None:
    """Refuse codes from ``lo`` to ``hi`` outside the scoring matrix's
    alphabet."""
    vol = np.asarray(matrix).shape[-1]
    if lo < 0 or hi >= vol:
        raise ValidationError(f"{name} codes must lie in the {vol}-symbol scoring alphabet")


def _check_pair_codes(q, t, matrix) -> None:
    """Refuse query or target codes outside the scoring matrix's alphabet
    (a :func:`_shared_row` query is checked once)."""
    for name, a in (("query", q[:1] if _shared_row(q) else q), ("target", t)):
        if a.size:
            _refuse_codes(name, int(a.min()), int(a.max()), matrix)


@contextlib.contextmanager
def _fill_span(cells: int, shards: int):
    """The ``fill`` span of a batched fill, whose count ``lone`` is the
    launches of the fill kernel's lone design made inside it."""
    from .ops import dp_fill

    with span("fill", cells=cells, shards=shards) as sp:
        lone = dp_fill.launches.lone
        yield sp
        sp.count(lone=dp_fill.launches.lone - lone)


def _fill(q, ql, t, tl, matrix, del_, ext, mode, with_dirs, device, dtype,
          track_argmax=True, with_plane=False):
    """One batched fill on ``device``, sharded over
    :func:`_auto_shard_devices` (one shard for a batch of one and with the
    score plane) by :func:`_fill_sharded`; returns the
    FillResult with its tensors (and packed words when ``with_dirs``, the
    score plane's interior with ``with_plane``) left on the device."""
    from .ops.dp_fill import DPFill

    cells = _cells(ql, tl)
    shards = [device] if with_plane or len(ql) < 2 else _auto_shard_devices(device)
    with _fill_span(cells, len(shards)):
        with span("fill.check"):
            _check_pair_codes(q, t, matrix)
        with measure(_engine_name(device, shards, mode), cells, len(ql), device=shards,
                     sync_span="fill.sync"):
            return _fill_sharded(DPFill, matrix, [q, ql, t, tl], del_, ext, dtype, shards,
                                 device, mode=mode, track_argmax=track_argmax,
                                 with_dirs=with_dirs, with_scores_plane=with_plane)


def _pair_result(mode, walk_q, walk_t, q_b, t_b, ql_b, tl_b,
                 sy_b, sx_b, end_y_b, end_x_b, fmax_b, alphabet):
    # the seeded character pair lands *after* the reversed walk
    # (simple/mod.rs:99-106/213-218)
    if mode == "global":
        qa = np.append(walk_q, np.int16(q_b[-1]))
        ta = np.append(walk_t, np.int16(t_b[-1]))
        coords = ((1, ql_b), (1, tl_b))
        f = 0.0
    else:
        qa = np.append(walk_q, np.int16(q_b[sx_b - 1]))
        ta = np.append(walk_t, np.int16(t_b[sy_b - 1]))
        coords = ((end_x_b + 1, sx_b + 1), (end_y_b + 1, sy_b + 1))
        f = fmax_b
    return AlignmentResult(Alignment(qa, ta, coords, f, alphabet))


def _walk_pairs_on_host(words, mode, qs, ts, q, t, ql, tl, sy, sx, fmax, skip_mask,
                        alphabet):
    """The host walks of :func:`batch_align` (``walk="host"``;
    ``aligner_tpu.align.batch_align``'s ``ALIGNER_DEVICE_WALK=0`` branch):
    the dense direction planes of the real problems on the host, then one
    native call for the whole batch when the native runtime is there and no
    problem is skipped, else the Python walkers problem by problem."""
    from . import native
    from .ops.dp_fill import dirs_from_packed

    n = len(qs)
    dirs = dirs_from_packed(words, ql[:n], tl[:n], mode)
    if native.available() and not skip_mask.any():
        walks_q, walks_t, end_y, end_x = native.traceback_batch(
            dirs, sy[:n].astype(np.int64), sx[:n].astype(np.int64),
            q[:n].astype(np.int8), t[:n].astype(np.int8), pwm_mode=False)
        return [_pair_result(mode, walks_q[b], walks_t[b], qs[b], ts[b], int(ql[b]),
                             int(tl[b]), int(sy[b]), int(sx[b]), int(end_y[b]),
                             int(end_x[b]), float(fmax[b]), alphabet)
                for b in range(n)]
    out = []
    for b in range(n):
        if skip_mask[b]:
            out.append(None)
            continue
        d = dirs[b, : tl[b] + 1, : ql[b] + 1]
        if mode == "global":
            qa, ta, coords = traceback_global(d, qs[b], ts[b])
            f = 0.0
        else:
            qa, ta, coords = traceback_local(d, int(sy[b]), int(sx[b]), qs[b], ts[b])
            f = float(fmax[b])
        out.append(AlignmentResult(Alignment(qa, ta, coords, f, alphabet)))
    return out


def _pad_pairs(queries, targets, alphabet, one_query: bool):
    """The codes of a batch, ``qs`` and ``ts``, and their padded (B, C) and
    (B, R) int32 arrays with lengths, ``q, ql, t, tl``.  With ``one_query``
    (every query the same object) the query is encoded and padded once and
    ``q`` is its row broadcast over the batch (stride 0)."""
    qs = ([_encode(queries[0], alphabet)] * len(queries) if one_query
          else [_encode(s, alphabet) for s in queries])
    ts = [_encode(s, alphabet) for s in targets]
    if len(qs) != len(ts):
        raise ValidationError("queries and targets must have the same length")
    if one_query:
        row, ql = pad_batch(qs[:1])
        q, ql = np.broadcast_to(row[0], (len(qs), row.shape[1])), np.repeat(ql, len(qs))
    else:
        q, ql = pad_batch(qs)
    t, tl = pad_batch(ts)
    return qs, ts, q, ql, t, tl


def batch_align(
    queries: Sequence,
    targets: Sequence,
    matrix,
    del_: float,
    ext: float,
    *,
    mode: str = "local",
    alphabet: type[Alphabet] = Protein,
    device=None,
    dtype: torch.dtype | None = None,
    with_alignments: bool = False,
    track_argmax: bool = True,
    pad_to: int | None = None,
    skip: np.ndarray | None = None,
    walk: str = "device",
):
    """Batched alignment of N independent (query, target) pairs.

    ``matrix`` may be one (V, V) matrix shared by the batch or (B, V, V)
    per-problem matrices.  Without ``with_alignments`` this is scores-only
    (no direction words are written) and returns :class:`BatchScores`;
    with it, a list of :class:`AlignmentResult`.

    ``pad_to`` pads the batch with inactive problems to a fixed size;
    ``skip`` marks problems inactive (zero-length) so iterative callers
    can retire problems without changing the shape.  Skipped / padded
    entries return score 0 and (with alignments) ``None``, as does a local
    problem with no positive-scoring cell.

    ``walk``: ``"device"`` walks the packed words where they lie (the walk
    kernel on the card); ``"host"`` brings the direction planes to the host
    and walks them there (:func:`_walk_pairs_on_host`), with the same
    results.

    When every entry of ``queries`` is the same object (``[q] * n``, as the
    search and the p-value build their batches), the query is encoded,
    padded and checked once and goes to each device once, as one row that
    every problem of the launch reads; the results are the same bits as
    for a batch of equal but distinct queries.
    """
    if mode not in ("local", "global"):
        raise ValidationError(f"mode must be local|global, got {mode!r}")
    _check_walk(walk)
    one_query = len(queries) > 0 and all(s is queries[0] for s in queries)
    with span("batch", rows=len(queries), with_alignments=int(with_alignments),
              shared_query_rows=len(queries) if one_query else 0):
        with span("batch.pad"):
            qs, ts, q, ql, t, tl = _pad_pairs(queries, targets, alphabet, one_query)
            n_real = len(qs)
            if skip is not None:
                ql = np.where(np.asarray(skip, bool), 0, ql).astype(np.int32)
                tl = np.where(np.asarray(skip, bool), 0, tl).astype(np.int32)
            if pad_to is not None:
                if len(qs) > pad_to:
                    raise ValidationError(
                        f"pad_to={pad_to} is smaller than the batch ({len(qs)})"
                    )
                extra = pad_to - len(qs)
                (q,) = _pad_batch_rows([q], n_real, pad_to)
                t = np.pad(t, ((0, extra), (0, 0)))
                ql = np.pad(ql, (0, extra))
                tl = np.pad(tl, (0, extra))
                if matrix is not None and np.asarray(matrix).ndim == 3:
                    matrix = np.pad(
                        np.asarray(matrix), ((0, extra), (0, 0), (0, 0))
                    )
        device = resolve_device(device)
        dtype = dtype or dtype_for(device, matrix, del_, ext,
                                   lengths=(t.shape[1], q.shape[1]))
        skip_mask = (
            np.zeros(n_real, bool) if skip is None else np.asarray(skip, bool)[:n_real]
        )
        if with_alignments:
            # empty sequences cannot seed a traceback (the q[-1] seed char);
            # reject before the batched fill, like the single-pair APIs do
            if (((ql[:n_real] == 0) | (tl[:n_real] == 0)) & ~skip_mask).any():
                raise ResultIsEmpty("empty sequence")
        # global mode captures the end score H[tlen, qlen] inside the argmax
        # bookkeeping, so tracking is forced there
        res = _fill(q, ql, t, tl, matrix, del_, ext, mode, with_alignments,
                    device, dtype,
                    track_argmax=(track_argmax or with_alignments
                                  or mode == "global"))
        with span("batch.read"):
            if not with_alignments:
                return BatchScores(
                    fmax=res.fmax.cpu().numpy()[:n_real], fy=res.fy.cpu().numpy()[:n_real],
                    fx=res.fx.cpu().numpy()[:n_real], end=res.end.cpu().numpy()[:n_real],
                )
            fmax_np = res.fmax.cpu().numpy()  # one transfer, not B scalars
            if mode == "global":
                sy_full = tl.astype(np.int32)
                sx_full = ql.astype(np.int32)
            else:
                sy_full = res.fy.cpu().numpy().astype(np.int32)
                sx_full = res.fx.cpu().numpy().astype(np.int32)
                # a problem with no positive-scoring cell has no alignment (the
                # reference would panic on its 0-index seed, simple/mod.rs:213-218):
                # None for just that problem instead of failing the whole batch
                skip_mask = skip_mask | (sy_full[:n_real] == 0) | (sx_full[:n_real] == 0)
        with span("batch.walk"):
            if walk == "host":
                return _walk_pairs_on_host(_host_words(res.words, n_real).numpy(), mode,
                                           qs, ts, q, t, ql, tl, sy_full, sx_full, fmax_np,
                                           skip_mask, alphabet)
            from .ops.device_walk import decode_pair_batch, walk_batch

            steps, lens, ey, ex = walk_batch(
                res.words, mode, sy_full, sx_full, t.shape[1], q.shape[1]
            )
            qa_ws, ta_ws = decode_pair_batch(steps, lens, sy_full, sx_full, q, t)
        out = []
        for b in range(n_real):
            if skip_mask[b]:
                out.append(None)
                continue
            out.append(_pair_result(
                mode, qa_ws[b], ta_ws[b], qs[b], ts[b], int(ql[b]), int(tl[b]),
                int(sy_full[b]), int(sx_full[b]), int(ey[b]), int(ex[b]),
                float(fmax_np[b]), alphabet,
            ))
        return out


# the streams a card lends a ScorePass: PyTorch's pool holds 32 a card (and
# priority), taken once and used again by every later pass
STREAMS_PER_CARD = 32
_STREAMS: dict[int, list] = {}


def _card(d: torch.device) -> torch.device:
    """``d``, with the current card's index where it is ``"cuda"`` without
    one."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _pass_stream(card: torch.device, i: int):
    """The stream of a :class:`ScorePass`'s ``i``-th batch on ``card``: its
    pool's stream ``i`` (past the pool's last, batch ``i`` shares a stream
    with, and so waits for, batch ``i - len(pool)``)."""
    pool = _STREAMS.get(card.index)
    if pool is None:
        made = (torch.cuda.Stream(card) for _ in range(STREAMS_PER_CARD))
        pool = _STREAMS[card.index] = list({s.cuda_stream: s for s in made}.values())
    return pool[i % len(pool)]


class TargetBucket:
    """A batch of targets kept on the cards for the scores-only fills of
    many queries: a length bucket of the search's resident database.

    The first :class:`ScorePass` that enqueues it pads its codes (in
    ``batch.pad``), takes their range (in ``fill.check``) and sends each of
    the pass's shards its rows (in ``fill.upload``): the codes in the layout
    the fill reads, (R, B) int32, which ``ops/dp_fill._launch`` reads in
    place, the lengths, and a mask of the real rows (a shard's padding rows
    have none); the host's copies then go.  Every later pass, on the same
    shards, reads them where they lie and checks its matrix against the
    range without reading a code.  On a card the sends follow
    :class:`_Sent`'s rule: a pass on another stream waits for their event."""

    def __init__(self, targets: Sequence[np.ndarray]):
        if not len(targets):
            raise ValidationError("empty batch")
        self.rows = len(targets)
        self.width = self.residues = 0  # the padded rows' length; the real codes' count
        self.codes: tuple[int, int] | None = None  # the padded rows' lowest, highest code
        self.shards: tuple | None = None  # the devices it was sent to
        self._targets = targets
        self._host: list | None = None  # the padded rows, lengths and mask, until sent
        self._sent = _Sent()

    def _pad(self, shards) -> None:
        if self.shards is None:
            t, tl = pad_batch(self._targets)
            n = len(shards)
            self._host = _pad_batch_rows([t, tl, np.ones(self.rows, np.int32)], self.rows,
                                         -(-self.rows // n) * n)
            self.width, self.residues = t.shape[1], int(tl.sum())
            self.codes = int(t.min()), int(t.max())
            self._targets, self.shards = None, tuple(shards)
        elif self.shards != tuple(shards):
            raise ValueError(f"a bucket sent to {list(self.shards)} enqueued on {shards}")

    def _on(self, k: int, dev: torch.device):
        """Shard ``k``'s rows (R, B), lengths and mask on ``dev``, and the
        bytes sent for them (0 once sent)."""
        def send():
            per = len(self._host[1]) // len(self.shards)
            t, tl, live = (_dev_i32(a[k * per:(k + 1) * per], dev) for a in self._host)
            return t.T.contiguous(), tl, live

        on, new = self._sent.get(dev, k, send)
        return on, sum(a.nbytes for a in on) if new else 0


class ScorePass:
    """The scores-only fills of one query against many batches of targets
    (the search's length buckets) as one pass over the cards.

    :meth:`enqueue` launches the fills of a :class:`TargetBucket` as
    :func:`batch_align` of ``[query] * n`` against its targets does without
    alignments, but from the targets the bucket keeps on the cards, on a
    CUDA stream of its own (the ``i``-th batch on stream ``i`` of a pool
    taken once a card) and without waiting for the card: no batch waits for
    another's launch.  The query's padded row and the scoring state go to
    each card once a pass; a batch on another stream waits for their
    upload's event.  :meth:`read` then waits for the cards once and reads
    every batch's scores, bit for bit what :func:`batch_align` returns.  On
    the CPU the batches run in turn on the plain fill as they are enqueued.

    Each batch is a ``batch`` span with ``batch.pad`` and ``fill``
    (``fill.check``, ``fill.upload``, ``fill.launch``), as in
    :func:`batch_align`; the wait and the reads are one ``batch`` span
    [batches] of ``fill.sync`` and ``batch.read``; the pass is one launch
    of the counters, from its first upload to the wait.  Use it as a
    context manager: leaving it without :meth:`read` waits for the cards,
    so that nothing still running reads a tensor that has gone."""

    def __init__(self, query, matrix, del_: float, ext: float, *, mode: str = "local",
                 alphabet: type[Alphabet] = Protein, device=None):
        if mode not in ("local", "global"):
            raise ValidationError(f"mode must be local|global, got {mode!r}")
        self.query = _encode(query, alphabet)
        (self._row,), _ = pad_batch([self.query])
        self._codes = int(self._row.min()), int(self._row.max())
        self.matrix, self.del_, self.ext = matrix, del_, ext
        self.mode, self.alphabet = mode, alphabet
        self.device = resolve_device(device)
        self.shards = [_card(d) for d in _auto_shard_devices(self.device)]
        self.in_flight = 0  # the batches enqueued
        self.streams: set = set()  # the streams they were enqueued on
        self._sent = _Sent()
        self._batches: list = []  # (rows, the shards' FillResults, the shards) unread
        self._cells = 0
        self._t0 = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._batches:
            synchronize(self._cards())
        return False

    def _cards(self) -> list:
        return list(dict.fromkeys(d for _, _, shards in self._batches for d in shards))

    def enqueue(self, bucket: TargetBucket) -> None:
        """Launch the fills of the query against ``bucket``'s targets."""
        from .ops.dp_fill import DPFill

        n = bucket.rows
        shards = self.shards if n > 1 else [_card(self.device)]
        per = -(-n // len(shards))
        qlen = len(self.query)
        with span("batch", rows=n, with_alignments=0, shared_query_rows=n):
            with span("batch.pad"):
                bucket._pad(shards)
            dtype = dtype_for(self.device, self.matrix, self.del_, self.ext,
                              lengths=(bucket.width, len(self._row)))
            cells = qlen * bucket.residues
            with _fill_span(cells, len(shards)):
                with span("fill.check"):
                    _refuse_codes("query", *self._codes, self.matrix)
                    _refuse_codes("target", *bucket.codes, self.matrix)
                    codes = (min(self._codes[0], bucket.codes[0]),
                             max(self._codes[1], bucket.codes[1]))
                if self._t0 is None:
                    self._t0 = time.perf_counter()
                parts = []
                for k, dev in enumerate(shards):
                    stream = None
                    if dev.type == "cuda":
                        stream = _pass_stream(dev, self.in_flight)
                        self.streams.add(stream)
                    with torch.cuda.stream(stream) if stream else contextlib.nullcontext():
                        with span("fill.upload") as sp:
                            dp, new = self._sent.get(dev, ("scoring", dtype), lambda: (
                                DPFill.from_numpy(self.matrix, self.del_, self.ext,
                                                  device=dev, dtype=dtype)))
                            scoring_bytes = sum(b.nbytes for b in dp.buffers()) if new else 0
                            row, new = self._sent.get(dev, "query",
                                                      lambda: _dev_i32(self._row, dev))
                            query_bytes = row.nbytes if new else 0
                            (t, tl, live), target_bytes = bucket._on(k, dev)
                            sp.count(h2d_bytes=scoring_bytes + query_bytes + target_bytes,
                                     query_bytes=query_bytes)
                        with span("fill.launch"):
                            parts.append(dp(row.expand(per, -1), live * qlen, t.T, tl,
                                            mode=self.mode, track_argmax=True,
                                            code_range=codes))
                bucket._host = None
        self._batches.append((n, parts, shards))
        self.in_flight += 1
        self._cells += cells

    def read(self) -> list[BatchScores]:
        """Wait for the cards, once, and return every batch's scores in the
        order the batches were enqueued."""
        out = []
        with span("batch", batches=len(self._batches)):
            synchronize(self._cards(), "fill.sync")
            if self._batches:
                counters.record(_engine_name(self.device, self.shards, self.mode),
                                self._cells, sum(n for n, _, _ in self._batches),
                                time.perf_counter() - self._t0)
            with span("batch.read"):
                for n, parts, _ in self._batches:
                    res = _assemble_sharded_fill(parts, n, len(parts[0].fmax), self.device)
                    out.append(BatchScores(
                        fmax=res.fmax.cpu().numpy()[:n], fy=res.fy.cpu().numpy()[:n],
                        fx=res.fx.cpu().numpy()[:n], end=res.end.cpu().numpy()[:n],
                    ))
        self._batches = []
        return out


def _fill_pwm(q, ql, pwm, del_, ext, with_dirs, device, dtype, track_argmax=True):
    """One batched PWM fill on ``device``, sharded as :func:`_fill` shards
    (one shard for a batch of one); returns the FillResult with its tensors (and
    packed words when ``with_dirs``) left on the device."""
    from .ops.dp_fill import PWMFill

    width = np.asarray(pwm).shape[-1]
    cells = int(np.asarray(ql, np.int64).sum()) * int(width)
    shards = [device] if len(ql) < 2 else _auto_shard_devices(device)
    with _fill_span(cells, len(shards)):
        with span("fill.check"):
            if q.size and (int(q.min()) < 0 or int(q.max()) >= 4):
                raise ValidationError("query codes must lie in the 4-symbol DNA alphabet")
        with measure(_engine_name(device, shards, "pwm"), cells, len(ql), device=shards,
                     sync_span="fill.sync"):
            return _fill_sharded(PWMFill, pwm, [q, ql], del_, ext, dtype, shards, device,
                                 track_argmax=track_argmax, with_dirs=with_dirs)


def batch_align_pwm(
    queries: Sequence,
    pwm: np.ndarray,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = DNA,
    device=None,
    dtype: torch.dtype | None = None,
    with_alignments: bool = False,
    track_argmax: bool = True,
    pad_to: int | None = None,
    skip: np.ndarray | None = None,
    walk: str = "device",
):
    """Batched query-vs-PWM alignment (one PWM shared or (B, 4, W) batched).

    The window-scan primitive of the latent-repeat search: all windows
    become one launch.  ``track_argmax=False`` (scores-only mode only)
    skips the per-cell argmax bookkeeping when the caller consumes just
    ``fmax``; fy/fx/end then come back zero.

    ``pad_to``/``skip`` as in :func:`batch_align`: padding problems are
    zero-length and not returned; skipped real problems return ``None``
    (score 0 in scores-only mode).  ``walk`` as in :func:`batch_align`: under
    ``"host"`` each problem's direction plane is walked by ``traceback_pwm``.
    """
    pwm = np.asarray(pwm)
    if pwm.ndim not in (2, 3) or pwm.shape[-2] != 4:
        raise MatrixShapeError(f"PWM must have 4 rows, got shape {pwm.shape}")
    _check_walk(walk)
    qs = [_encode(s, alphabet) for s in queries]
    n_real = len(qs)
    q, ql = pad_batch(qs)
    if skip is not None:
        ql = np.where(np.asarray(skip, bool), 0, ql).astype(np.int32)
    if pad_to is not None:
        if n_real > pad_to:
            raise ValidationError(
                f"pad_to={pad_to} is smaller than the batch ({n_real})"
            )
        extra = pad_to - n_real
        q = np.pad(q, ((0, extra), (0, 0)))
        ql = np.pad(ql, (0, extra))
        if pwm.ndim == 3:
            pwm = np.pad(pwm, ((0, extra), (0, 0), (0, 0)))
    skip_mask = (
        np.zeros(n_real, bool) if skip is None else np.asarray(skip, bool)[:n_real]
    )
    device = resolve_device(device)
    dtype = dtype or dtype_for(device, pwm, del_, ext,
                               lengths=(q.shape[1], pwm.shape[-1]))
    res = _fill_pwm(q, ql, pwm, del_, ext, with_alignments, device, dtype,
                    track_argmax=track_argmax or with_alignments)
    if not with_alignments:
        return BatchScores(
            fmax=res.fmax.cpu().numpy()[:n_real], fy=res.fy.cpu().numpy()[:n_real],
            fx=res.fx.cpu().numpy()[:n_real], end=res.end.cpu().numpy()[:n_real],
        )
    from .ops.device_walk import decode_pwm_batch, walk_batch

    width = pwm.shape[-1]
    sy = res.fy.cpu().numpy()
    sx = res.fx.cpu().numpy()
    fmax_np = res.fmax.cpu().numpy()  # one transfer, not B scalars
    if walk == "host":
        from .ops.dp_fill import dirs_from_packed

        # the real problems' planes only: pad_to padding never transfers
        dirs = dirs_from_packed(_host_words(res.words, n_real).numpy(),
                                np.full(n_real, width), ql[:n_real], "local")
        out = []
        for b in range(n_real):
            if skip_mask[b]:
                out.append(None)
                continue
            d = dirs[b, : ql[b] + 1, : width + 1]
            qa, numbered, coords = traceback_pwm(d, int(sy[b]), int(sx[b]), qs[b])
            out.append(AlignmentResult(
                PWMAlignment(numbered, qa, width, coords, float(fmax_np[b]), alphabet)))
        return out
    # PWM planes are (qlen+1, W+1): rows = query positions
    steps, lens, ey, ex = walk_batch(res.words, "local", sy, sx, q.shape[1], width)
    qa_ws, num_ws = decode_pwm_batch(steps, lens, sy, sx, q)
    out = []
    for b in range(n_real):
        if skip_mask[b]:
            out.append(None)
            continue
        coords = ((int(ex[b]) + 1, int(sx[b]) + 1), (int(ey[b]) + 1, int(sy[b]) + 1))
        out.append(AlignmentResult(
            PWMAlignment(num_ws[b], qa_ws[b], width, coords, float(fmax_np[b]),
                         alphabet)
        ))
    return out


def _route_sharded_pair(qlen, tlen, matrix_np, del_, ext, *, backend, auto,
                        huge: bool = False, several: bool = False) -> bool:
    """Shared huge-pair dispatch: does this single-pair request run on the
    column-blocked pipeline?  Raises ValidationError for an explicit
    ``backend="wavefront_sp"`` the pipeline cannot honour (the auto path
    simply declines).  One definition, so that :func:`align_global` and
    :func:`global_end_score` route identically
    (``aligner_tpu.align._route_sharded_pair``): by itself the pipeline
    takes a pair wider than one plane, and a ``huge`` pair (above
    ``DIRECT_PLANE_CELLS``) when ``several`` devices are in the auto-shard's
    list (:func:`_pipeline_place`).  The range guard takes the matrix's
    largest entry: the pipeline aligns an integral matrix beyond int8 on its
    ``"lax"`` engine, and refuses the pairs whose scores the reference's
    guard, which assumes int8 entries, lets wrap."""
    from .ops import wavefront as wf

    ok = integral_params(matrix_np, del_, ext) and wf.range_ok(
        qlen, tlen, del_, ext, wf.max_entry(matrix_np))
    if backend == "wavefront_sp":
        if not ok:
            raise ValidationError(
                "wavefront_sp requires an integral matrix/penalties "
                "with scores in the int32-exact range"
            )
        return True
    return auto and ok and (qlen > wf.MAX_WIDTH or (huge and several))


def _pipeline_place(device: torch.device):
    """Where the column-blocked pipeline runs a pair asked for on
    ``device``: ``(mesh, None)``, an (n, 1) mesh of the auto-shard's devices
    (:func:`_auto_shard_devices`, this process's alone) when there are
    several, as the reference runs it on its ``_data_mesh``
    (``aligner_tpu/align.py:60-70``; ``make_mesh``'s square factoring would
    leave half of them idle); else ``(None, device)``, every block on
    ``device``."""
    devices = _auto_shard_devices(device)
    if len(devices) == 1:
        return None, device
    from .parallel.mesh import Mesh

    return Mesh(("data", "matrix"), np.arange(len(devices)).reshape(-1, 1),
                tuple(devices)), None


def _huge_global_refusal(qlen: int, tlen: int) -> ValidationError:
    return ValidationError(
        f"global pair of {tlen}x{qlen} = {qlen * tlen} cells needs a "
        "materialized plane under the requested options; huge pairs "
        "require an integral matrix/penalties in int32 range (the "
        "wavefront engines) and keep_planes=False"
    )


def _pair_with_planes(q, t, matrix, del_, ext, mode, alphabet, device):
    """One pair with its planes (``keep_planes``): a batch of one on the
    batched fill with the score plane, then the host walk over the returned
    directions, as the reference's ``_fill(..., scores_plane=keep_planes)``
    and ``traceback_global``/``traceback_local`` do.  The planes are
    (tlen+1, qlen+1) with the reference's borders, the score plane in the
    fill's dtype."""
    from .ops.dp_fill import dirs_from_packed, planes_from_interior

    qp, ql = pad_batch([q])
    tp, tl = pad_batch([t])
    dtype = dtype_for(device, matrix, del_, ext, lengths=(tp.shape[1], qp.shape[1]))
    res = _fill(qp, ql, tp, tl, matrix, del_, ext, mode, True, device, dtype,
                with_plane=True)
    rows, cols = len(t) + 1, len(q) + 1
    dirs = dirs_from_packed(res.words.cpu().numpy(), ql, tl, mode)[0, :rows, :cols]
    score = planes_from_interior(res.plane.cpu().numpy(), ql, tl, mode, del_,
                                 rows=len(t))[0, :, :cols]
    if mode == "global":
        qa, ta, coords = traceback_global(dirs, q, t)
        f = 0.0
    else:
        qa, ta, coords = traceback_local(dirs, int(res.fy[0]), int(res.fx[0]), q, t)
        f = float(res.fmax[0])
    return AlignmentResult(Alignment(qa, ta, coords, f, alphabet), score=score,
                           directions=dirs)


def _host_result(r, keep_planes: bool, alphabet) -> AlignmentResult:
    return AlignmentResult(
        Alignment(r.query_aligned, r.target_aligned, r.coords, r.f, alphabet),
        score=r.score if keep_planes else None,
        directions=r.directions if keep_planes else None,
    )


def align_global(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    device=None,
    keep_planes: bool = False,
    walk: str = "device",
) -> AlignmentResult:
    """Global (NW-style) alignment of one pair (simple/mod.rs:42-144).

    A pair the row-scan engine supports (an integral matrix within int8,
    integral penalties, scores in the int32-exact range, a query of at
    most ``ops.wavefront.MAX_WIDTH``) runs on it: one direction plane up
    to ``ops.wavefront.DIRECT_PLANE_CELLS`` cells, checkpoint-and-replay
    above.  That is exact in global mode because the penalty is constant
    ``ext`` after cell (1,1) (SURVEY.md §2.3.3).  A wider pair with integral
    scoring (a matrix beyond int8 too, on the pipeline's ``"lax"`` engine,
    within the range guard for its largest entry), and any such pair under
    ``backend="wavefront_sp"``, runs on the column-blocked pipeline
    (:func:`aligner_tpu_torch.parallel.wavefront_sp.sharded_global_align`),
    whose fills and replay tiles are one column block wide; so does such a
    pair above ``DIRECT_PLANE_CELLS`` when the auto-shard's list
    (:func:`_auto_shard_devices`) holds several devices, and then, as with
    any pipeline pair, its column blocks are spread over an (n, 1) mesh of
    them (:func:`_pipeline_place`).  A named card, ``ALIGNER_AUTO_SHARD=0``
    and one visible card keep every block on ``device``.  Any other pair
    (a transformed, non-integral matrix) runs as a batch of one on the
    batched fill up to the direct-plane budget and is refused above it: no
    route materialises an O(R·C) plane at that scale.  ``backend`` keeps
    the JAX package's names: ``None``/``"auto"``, ``"wavefront"`` (the row
    scan forced on; raises where the pair is not supported) or
    ``"wavefront_sp"``.

    ``keep_planes`` returns the (tlen+1, qlen+1) ``score`` and
    ``directions`` planes: the pair skips the row scan and runs as a batch
    of one on the batched fill with the score plane (up to the direct-plane
    budget; refused above it and with ``"wavefront_sp"``), except under
    ``backend="wavefront"``, which returns the row scan's directions and no
    score plane, as the reference does.  ``device="host"`` is the host
    engine (native C++, the reference's ``backend="oracle"``), its planes
    float64.  ``walk`` (``"device"`` or ``"host"``) picks where the
    traceback walks; a pair with planes is always walked on the host.
    """
    from . import host
    from .ops import wavefront as wf

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    if backend not in (None, "auto", "wavefront", "wavefront_sp"):
        raise ValidationError(
            f"unknown backend {backend!r} for align_global "
            "(choose auto, wavefront or wavefront_sp)"
        )
    _check_walk(walk)
    matrix_np = np.asarray(matrix)
    cells = len(q) * len(t)
    huge = cells > wf.DIRECT_PLANE_CELLS
    auto = backend in (None, "auto")
    if keep_planes and backend == "wavefront_sp":
        raise ValidationError("wavefront_sp cannot materialize planes (keep_planes)")
    if keep_planes and huge:
        raise _huge_global_refusal(len(q), len(t))
    if _on_host(device):
        if not auto:
            raise ValidationError(f"device=\"host\" is the host engine; it takes no "
                                  f"backend, got {backend!r}")
        return _host_result(host.align_global(q, t, matrix_np, del_, ext), keep_planes,
                            alphabet)
    device = resolve_device(device)
    mesh, on = _pipeline_place(device)
    if _route_sharded_pair(len(q), len(t), matrix_np, del_, ext, backend=backend,
                           auto=auto and not keep_planes, huge=huge,
                           several=mesh is not None):
        from .parallel.wavefront_sp import sharded_global_align

        with span("pair", cells=cells, aligned=1):
            _, qa, ta, coords = sharded_global_align(mesh, q, t, matrix_np, del_, ext,
                                                     device=on, walk=walk)
        return AlignmentResult(Alignment(qa, ta, coords, 0.0, alphabet))
    if wf.supported(len(q), matrix_np, del_, ext, tlen=len(t)) and (
            backend == "wavefront" or not keep_planes):
        with span("pair", cells=cells, aligned=1):
            if huge:
                _, qa, ta, coords = wf.align_single_global_chunked(
                    q, t, matrix_np, del_, ext, device=device, walk=walk)
            elif keep_planes or walk == "host":
                count(row_blocks=1, col_blocks=1, engine=PAIR_ENGINES.index("row_scan"))
                with span("pair.forward", launches=1):
                    _, dirs = wf.fill_single_global(q, t, matrix_np, del_, ext, device=device)
                with span("pair.walk") as sp:
                    qa, ta, coords = traceback_global(dirs, q, t)
                    sp.count(steps=len(qa) - 1)
                return AlignmentResult(Alignment(qa, ta, coords, 0.0, alphabet),
                                       directions=dirs if keep_planes else None)
            else:
                _, qa, ta, coords = wf.align_single_global_direct(q, t, matrix_np, del_,
                                                                  ext, device=device)
        return AlignmentResult(Alignment(qa, ta, coords, 0.0, alphabet))
    if backend == "wavefront":
        raise ValidationError(
            "wavefront backend requires an integral matrix/penalties, "
            "qlen within its width cap, and int32-range scores"
        )
    if huge:
        # the batched engine materializes O(R*C) planes: at this scale a
        # silent fallthrough is an OOM, not an alignment
        raise _huge_global_refusal(len(q), len(t))
    if keep_planes:
        return _pair_with_planes(q, t, matrix_np, del_, ext, "global", alphabet, device)
    (res,) = batch_align([q], [t], matrix_np, del_, ext, mode="global",
                         alphabet=alphabet, device=device, with_alignments=True,
                         walk=walk)
    return res


def global_end_score(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    device=None,
) -> float:
    """Exact global end score ``H[tlen, qlen]`` of ONE pair: no plane, no
    traceback (the reference always builds the full alignment,
    simple/mod.rs:42-98; the end score is the cheap half of that DP).

    ``backend`` keeps the JAX package's names.  ``None``/``"auto"``: a pair
    the band engine supports (an integral matrix within int8, integral
    penalties, int32-exact scores, a query of at most
    ``ops.wavefront.MAX_WIDTH``) runs on it
    (:func:`aligner_tpu_torch.ops.wavefront.end_score_single_global_diag`) on
    ``device``, at any size; any other pair runs as a batch of one on the
    batched global fill, scores only, up to
    ``ops.wavefront.DIRECT_PLANE_CELLS`` cells and is refused above.
    ``"diag"`` forces the band engine and raises when the pair is not
    supported; ``"host"`` is the host engine (native C++ fill);
    ``"wavefront_sp"`` is the column-blocked pipeline
    (:func:`aligner_tpu_torch.parallel.wavefront_sp.sharded_global_end_score`),
    which a pair with integral scoring and a query wider than
    ``ops.wavefront.MAX_WIDTH`` takes by itself, and a pair above
    ``DIRECT_PLANE_CELLS`` with several devices in the auto-shard's list,
    over an (n, 1) mesh of them, as in :func:`align_global`.
    The JAX package sends a small pair to the host below a cell count that
    was tuned for its accelerator's dispatch cost; that threshold is not
    carried over: no size picks the host silently.
    """
    from . import host
    from .ops import wavefront as wf

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    if backend not in (None, "auto", "diag", "wavefront_sp", "host"):
        raise ValidationError(
            f"unknown backend {backend!r} for global_end_score "
            "(choose auto, diag, wavefront_sp, or host)"
        )
    matrix_np = np.asarray(matrix)
    if backend == "host":
        r = host.align_global(q, t, matrix_np, del_, ext)
        return float(r.score[len(t), len(q)])
    device = resolve_device(device)
    auto = backend in (None, "auto")
    cells = len(q) * len(t)
    mesh, on = _pipeline_place(device)
    if _route_sharded_pair(len(q), len(t), matrix_np, del_, ext, backend=backend,
                           auto=auto, huge=cells > wf.DIRECT_PLANE_CELLS,
                           several=mesh is not None):
        from .parallel.wavefront_sp import sharded_global_end_score

        with span("pair", cells=cells, aligned=0):
            return sharded_global_end_score(mesh, q, t, matrix_np, del_, ext, device=on)
    if wf.supported(len(q), matrix_np, del_, ext, tlen=len(t)):
        with span("pair", cells=cells, aligned=0):
            return wf.end_score_single_global_diag(q, t, matrix_np, del_, ext, device=device)
    if backend == "diag":
        raise ValidationError(
            "diag backend requires an integral matrix/penalties, "
            "qlen within the width cap, and int32-range scores"
        )
    if cells > wf.DIRECT_PLANE_CELLS:
        raise ValidationError(
            f"global pair of {len(t)}x{len(q)} = {cells} cells needs an "
            "integral matrix/penalties in int32 range (the wavefront "
            "engines): every remaining engine materializes O(R*C)"
        )
    res = batch_align([q], [t], matrix_np, del_, ext, mode="global", alphabet=alphabet,
                      device=device)
    return float(res.end[0])


def local_max_score(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    device=None,
) -> tuple[float, tuple[int, int]]:
    """Maximum local score and its cell, without a traceback: the local
    sibling of :func:`global_end_score` (the reference's ``f`` field,
    simple/mod.rs:247).  Returns ``(f, (my, mx))`` with the plane argmax in
    first-row-major order (simple/mod.rs:212).

    Up to ``ops.wavefront.DIRECT_PLANE_CELLS`` cells it is a batch of one on
    the batched fill, scores only, on ``device``.  A larger pair runs on the
    native streaming fill on the host whatever ``device`` says, for the
    reason :func:`align_local` gives: a single local pair is serial and has
    no device path.  ``device="host"`` asks for the native fill at any
    size.  Without the native runtime a huge pair takes the batched fill,
    which keeps O(C) state and no plane, as in the JAX package.
    """
    from . import native
    from .ops import wavefront as wf

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    on_host = _on_host(device)
    if on_host and not native.available():
        raise ValidationError("device=\"host\" needs the native runtime, which did "
                              "not build")
    if not on_host:
        device = resolve_device(device)
    if on_host or (len(q) * len(t) > wf.DIRECT_PLANE_CELLS and native.available()):
        f, my, mx = native.local_max_score_stream(q, t, np.asarray(matrix), del_, ext)
        return f, (my, mx)
    res = batch_align([q], [t], np.asarray(matrix), del_, ext, mode="local",
                      alphabet=alphabet, device=device)
    return float(res.fmax[0]), (int(res.fy[0]), int(res.fx[0]))


def align_local(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    device=None,
    keep_planes: bool = False,
    walk: str = "device",
) -> AlignmentResult:
    """Local (SW-style) alignment of one pair (simple/mod.rs:147-264).

    Up to ``ops.wavefront.DIRECT_PLANE_CELLS`` cells it is a batch of one
    on the batched fill and walk.  A larger pair runs on the native
    streaming engine on the host (exact, memory-bounded
    checkpoint-and-replay) whatever ``device`` says: the local fill is
    inherently serial (the gap-penalty state chains through every cell,
    SURVEY §2.3.3), so unlike global mode a single local pair has no
    device path.  That is the reference's design for a huge local pair
    (``aligner_tpu.align.align_local``), not a way round a missing card.
    ``backend="stream"`` forces the streaming engine at any size.

    ``keep_planes`` returns the (tlen+1, qlen+1) ``score`` and
    ``directions`` planes, from a batch of one on the batched fill with the
    score plane (refused above the direct-plane budget and with
    ``"stream"``).  ``device="host"`` is the host engine (native C++, the
    reference's ``backend="oracle"``), its planes float64.  ``walk`` as in
    :func:`align_global`.
    """
    from . import host, native
    from .ops import wavefront as wf

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    if backend not in (None, "auto", "stream"):
        raise ValidationError(
            f"unknown backend {backend!r} for align_local (choose auto or stream)")
    _check_walk(walk)
    cells = len(q) * len(t)
    huge = cells > wf.DIRECT_PLANE_CELLS
    if backend == "stream" and keep_planes:
        raise ValidationError("stream cannot materialize planes (keep_planes)")
    if huge and (keep_planes or not native.available()):
        raise ValidationError(
            f"local pair of {cells} cells needs a materialized "
            "O(R*C) plane under the requested options; huge pairs "
            "require the native streaming engine (default route) "
            "without keep_planes"
        )
    on_host = _on_host(device)
    if not on_host:
        device = resolve_device(device)
    if backend == "stream" or huge:
        if not native.available():
            raise ValidationError(
                "backend='stream' requires the native runtime "
                "(ALIGNER_NO_NATIVE unset and a working g++)"
            )
        f, qa, ta, coords = native.align_local_stream(q, t, np.asarray(matrix), del_, ext)
        return AlignmentResult(Alignment(qa, ta, coords, f, alphabet))
    if on_host:
        return _host_result(host.align_local(q, t, np.asarray(matrix), del_, ext),
                            keep_planes, alphabet)
    if keep_planes:
        return _pair_with_planes(q, t, np.asarray(matrix), del_, ext, "local", alphabet,
                                 device)
    (res,) = batch_align([q], [t], matrix, del_, ext, mode="local", alphabet=alphabet,
                         device=device, with_alignments=True, walk=walk)
    if res is None:
        # the reference panics on index underflow here (simple/mod.rs:213-215)
        raise ResultIsEmpty("local alignment has no positive-scoring cell")
    return res


def align_pwm(
    query,
    pwm: np.ndarray,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = DNA,
    device=None,
    dtype: torch.dtype | None = None,
    walk: str = "device",
) -> AlignmentResult:
    """Query-vs-PWM local alignment (pwm/mod.rs:29-126).

    Three routes, each spelled out by ``device``: ``None`` or ``"cuda"``
    the kernels on the card, ``"cpu"`` their plain PyTorch versions, and
    ``"host"`` the host engine (native C++), at any size.  No size picks a
    route silently.  An empty query is not an error:
    the reference's PWM traceback walks from the all-zero plane's (0, 0)
    argmax and returns an empty ``PWMAlignment`` with coords
    ((1, 1), (1, 1)) and f = 0, on every route.  ``walk`` as in
    :func:`batch_align_pwm`.
    """
    pwm = np.asarray(pwm)
    if pwm.ndim != 2 or pwm.shape[0] != 4:
        raise MatrixShapeError(f"PWM must have 4 rows, got shape {pwm.shape}")
    q = _encode(query, alphabet)
    _check_walk(walk)
    if _on_host(device):
        from . import host

        r = host.align_pwm(q, pwm, del_, ext)
        return AlignmentResult(PWMAlignment(
            r.target_aligned.astype(np.int32), r.query_aligned, pwm.shape[1],
            r.coords, r.f, alphabet,
        ))
    (res,) = batch_align_pwm([q], pwm, del_, ext, alphabet=alphabet, device=device,
                             dtype=dtype, with_alignments=True, walk=walk)
    return res


# ---------------------------------------------------------------------------
# Class wrappers mirroring the reference's AlignerTrait (lib.rs:27-40).
# ---------------------------------------------------------------------------


class _SimpleAligner:
    _mode: str

    def __init__(self, query: np.ndarray, target: np.ndarray, alphabet):
        self.query = query
        self.target = target
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, target: str, alphabet=Protein):
        return cls(alphabet.encode(query, strict=True), alphabet.encode(target, strict=True),
                   alphabet)

    @classmethod
    def from_seqs(cls, query, target, alphabet=Protein):
        return cls(_encode(query, alphabet), _encode(target, alphabet), alphabet)

    def perform_alignment(
        self, del_: float, ext: float, matrix, heuristics=None, **kw
    ) -> AlignmentResult:
        """The pair's alignment with its planes (``keep_planes`` defaults to
        true, as the reference's simple aligners keep theirs); ``kw`` goes to
        :func:`align_global` or :func:`align_local` (``device``, ``walk``,
        ``backend``, ...)."""
        if heuristics is not None:
            raise UnnecessaryArgument(
                "simple aligners take no heuristics (lib.rs Error::UnnecessaryArgument)"
            )
        fn = align_global if self._mode == "global" else align_local
        kw.setdefault("keep_planes", True)
        return fn(self.query, self.target, matrix, del_, ext, alphabet=self.alphabet, **kw)


class SimpleGlobalAligner(_SimpleAligner):
    """Equivalent of aligner-core SimpleGlobalAligner (simple/mod.rs:9-145)."""

    _mode = "global"


class SimpleLocalAligner(_SimpleAligner):
    """Equivalent of aligner-core SimpleLocalAligner (simple/mod.rs:147-265)."""

    _mode = "local"


class PWMAligner:
    """Equivalent of aligner-core PWMAligner (pwm/mod.rs)."""

    def __init__(self, query: np.ndarray, alphabet=DNA):
        self.query = query
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, alphabet=DNA):
        return cls(alphabet.encode(query), alphabet)

    @classmethod
    def from_seqs(cls, query, alphabet=DNA):
        return cls(_encode(query, alphabet), alphabet)

    def perform_alignment(
        self, del_: float, ext: float, pwm, heuristics=None, **kw
    ) -> AlignmentResult:
        if heuristics is not None:
            raise UnnecessaryArgument("PWM aligner takes no heuristics")
        return align_pwm(self.query, pwm, del_, ext, alphabet=self.alphabet, **kw)
