"""One huge global pair on the card: the row-scan fill, the replay walk
(``csrc/wavefront.cu``), the band fill (``csrc/wavefront_band.cu``, the
band walk, one launch a call planned by :func:`plan_band`), the
column-block fill (``csrc/wavefront_block.cu``; it and the row-scan fill
share one kernel body, the strip walk of ``csrc/wavefront_tile.cuh``, one
launch a call planned by :func:`plan_strips`), their plain versions, the
checkpoint-and-replay alignment built on the first two and the end score
built on the third.  The fourth fills one column block of a pair from a
streamed left boundary (:func:`run_block_cs`); the column-blocked pipeline
for a pair wider than one plane (``parallel/wavefront_sp.py``) is built on it.

Counterpart of the single-pair parts of ``aligner_tpu/ops/wavefront.py``.  The
batched kernels parallelise over problems; a single chromosome-scale pair
has no batch axis.  In **global** mode ``get_direction`` never returns
Beginning (enums.rs:18-28), so the gap penalty is ``del`` for cell (1,1)
only and ``ext`` everywhere else (simple/mod.rs:72,88-92) and the fill is
a plain linear-gap recurrence

    H[y,x] = max(H[y-1,x-1] + s, H[y-1,x] - ext, H[y,x-1] - ext)

whose anti-diagonals are independent.  Arithmetic is **int32** (an
integral matrix, within int8 on one plane and any width on the column
blocks, and integral penalties; :func:`range_ok` keeps |H| below 2^30 for
the matrix's largest entry), so the fill is bit-exact against the float64
oracle in any evaluation order.  Directions are re-derived from the finished values
with the exact tie policy (top > left > diagonal) and packed 16 rows per
int32 word, row r of a call at word ``r >> 4``, bits ``2 * (r & 15)``.

An alignment needs the directions of every cell the walk visits, not of
the whole plane.  :func:`align_single_global_chunked` fills forward with
scores only and keeps one H row every ``tb_rows`` rows; the walk then
replays one block of ``tb_rows`` rows at a time *with* directions from its
checkpoint row and walks it on the card, so only the 2-bit step stream
comes back to the host.  Up to :data:`DIRECT_PLANE_CELLS` cells the whole
plane is one block (:func:`align_single_global_direct`).

The end score alone needs neither directions nor checkpoints.
:func:`end_score_single_global_diag` walks the plane in bands of rows and
each band by anti-diagonal steps (:func:`run_block_band`): row j of a band
is on column d - j at step d, so the cells of one step are independent and
a band hands the next one only its last row.

Not carried over from the TPU kernel: its packed score words, the nibble
table and the scoped-VMEM pre-flight.  They serve that chip's vector
memory and its missing per-lane gather; the H100 reads the (V, V) matrix
from shared memory.

Cites: simple/mod.rs:42-144 (global fill, borders, traceback),
enums.rs:18-28 (tie policy).
"""

from __future__ import annotations

import ctypes
import functools
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..alphabet import BLANK
from ..backend import resolve_device
from . import _build
from .scan_engine import BEG, DIAG, LEFT, TOP

ROWS_PER_WORD = 16  # 2-bit direction codes packed along the row axis
# the width of one pair on one card: the 2-bit words of a replay block
# (tb_rows x width / 4 bytes) and its checkpoint rows stay small beside
# the card's memory up to here; a wider pair takes the column-blocked
# pipeline (parallel/wavefront_sp.py), whose planes are one column block wide
MAX_WIDTH = 256 * 1024
# above this many cells align_global switches from one direction plane to
# checkpoint-and-replay
DIRECT_PLANE_CELLS = 1 << 26
# columns are padded to a multiple of this: 32 lanes x the most columns a
# lane of the fill kernel owns
COL_PAD = 256
# The strip walk's shape: strips of TILE_ROWS rows (FORWARD_TILE_ROWS for a
# call without directions), walked in chunks of 32 * COLS_PER_THREAD
# columns, a warp a strip; and the rows of one replay block.  Chosen by the
# strip-shape sweeps of ops/tile_probe.py at the four shapes of the paths
# and at 65,536 x 65,536 on an H100, recorded in PERF.md §6 (Findings): 8
# columns a lane beat 4 and 2 everywhere; 256-row strips fill forward
# fastest, 128-row strips replay with directions within 8 % of the best at
# both replay shapes; a larger block means fewer calls for the same cells,
# each doubling buying less, and 32,768 rows keep a block's words at 2 GiB
# for the widest pair.
TILE_ROWS = 128
FORWARD_TILE_ROWS = 256
COLS_PER_THREAD = 8
TB_ROWS = 32768
# the replay walk's ring (csrc/walk_core.cuh): its REPLAY_DEPTH word rows of
# REPLAY_SPAN columns staged ahead of the cursor (timed by ops/walk_probe.py
# on an H100: PERF.md, Findings)
REPLAY_SPAN = 256
# warps a block of the strip walk (they share the matrix in shared memory);
# the kernel's launch bounds allow STRIP_MAX_WARPS
STRIP_WARPS = 4
STRIP_MAX_WARPS = 8
# RS of csrc/wavefront_tile.cuh: a lane runs two rows of its columns a step
STRIP_ROWS_PER_STEP = 2
# the grid holds at most this many times the strips that can be under way
# at once (a strip's steps over the lag between strips): more would spin
STRIP_SPARE = 1.25


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Launches:
    """Launch counts of this module's kernels (plain integers, bumped only
    where a kernel is launched): ``row_scan`` and ``row_scan_dirs`` count
    calls of the fill without and with directions, ``tile_launches`` the
    kernel launches those calls made (one a call), and ``replay_walk`` the
    walk kernel; ``band`` counts calls of the band fill on one plane (the
    end score), ``band_sp`` its calls as the column-blocked pipeline's
    ``"band"`` engine, and ``band_tile_launches`` the kernel launches both
    made (one a call);
    ``block_cs`` and ``block_cs_dirs`` count calls of the column-block fill
    without and with directions and ``block_cs_tile_launches`` the kernel
    launches those calls made (one a call)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.row_scan = self.row_scan_dirs = self.tile_launches = 0
        self.replay_walk = 0
        self.band = self.band_sp = self.band_tile_launches = 0
        self.block_cs = self.block_cs_dirs = self.block_cs_tile_launches = 0


launches = _Launches()


def _integral_int8(matrix, del_, ext) -> bool:
    m = np.asarray(matrix)
    return bool(
        np.all(m == np.round(m))
        and np.abs(m).max() <= 127
        and float(del_) == int(del_)
        and float(ext) == int(ext)
    )


def max_entry(matrix) -> float:
    """The largest |entry| of an integral matrix as the int32 fills read it
    (rounded); inf for an infinite entry, which :func:`range_ok` refuses."""
    return float(np.abs(np.round(np.asarray(matrix, np.float64))).max(initial=0))


def range_ok(qlen: int, tlen: int, del_, ext, max_entry: float = 127) -> bool:
    """int32-exactness guard: the kernel's arithmetic must stay well
    inside int32.  |H| is bounded by the deeper of the gap ramp
    (-(R+C+2)·max(del,ext) along the borders) and the match ramp
    (min(R,C)·max(127, ``max_entry``) down the diagonal); the slack term
    keeps room for the padded rows and columns and for the offsets a
    prefix-scan or band formulation of the same fill adds.  Beyond this
    (about 97M rows at del=11) scores would silently wrap: refuse instead.

    ``max_entry`` is the matrix's largest |entry| (:func:`max_entry`).  The
    single-plane routes take int8 matrices only and leave it at 127, which
    is the reference's bound for every matrix; the column-blocked routes,
    whose block fill takes any int32 table, pass the matrix's own.  The
    reference bounds a wider matrix with 127 too, and so wraps silently
    (``aligner_tpu/ops/wavefront.py:361-374``); the port refuses instead."""
    pen = max(int(del_), int(ext), 1)
    h_abs = max((qlen + tlen + 2) * pen, min(qlen, tlen) * max(127, max_entry))
    slack = (qlen + tlen + 2 * 128 + 2) * max(int(ext), 1) + int(del_)
    return h_abs + slack < 2**30


def supported(qlen: int, matrix, del_, ext, tlen: int | None = None) -> bool:
    return (
        qlen <= MAX_WIDTH
        and _integral_int8(matrix, del_, ext)
        and (tlen is None or range_ok(qlen, tlen, del_, ext))
    )


# ---------------------------------------------------------------------------
# the strip walk's launch plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StripPlan:
    """One launch of the strip walk (``csrc/wavefront_tile.cuh``) over
    ``n_tr`` strips of ``TR`` rows by ``n_tc`` chunks of 32·K columns:
    ``blocks`` blocks of ``warps`` warps, each warp taking strips by ticket;
    ``smem_bytes`` of dynamic shared memory a block (the (V, V) matrix, then
    each warp's TR codes and its ring of ``ring_slots`` ints, which carries
    lane 31's column to lane 0 of the next chunk); zeroed device memory:
    ``sync_ints`` ints (the ticket) and ``hand_words`` 64-bit words (the row
    handed from strip to strip, tagged); ``under_way``, the strips that can
    run at once (a strip's steps over the lag); ``steps_per_chunk`` (P =
    max(TR / 2, 32): a lane runs two rows a step, and a chunk of fewer than
    64 rows waits for lane 31), ``steps_per_strip``, the least lag in steps from a
    strip's start of a chunk to the next strip's (``lag_steps``) and the
    launch's critical path in steps (``critical_steps``): the last strip's
    start behind the lags, or behind the rounds of strips when fewer warps
    are resident than there are strips, and then its own steps."""

    TR: int
    K: int
    n_tr: int
    n_tc: int
    warps: int
    blocks: int
    smem_bytes: int
    ring_slots: int
    sync_ints: int
    hand_words: int
    under_way: int
    steps_per_chunk: int
    steps_per_strip: int
    lag_steps: int
    critical_steps: int


def strip_warps(n_tr: int, warps: int | None = None) -> int:
    """Warps a block: ``warps`` (by default :data:`STRIP_WARPS`), and never
    more than there are strips."""
    warps = STRIP_WARPS if warps is None else warps
    if not 1 <= warps <= STRIP_MAX_WARPS:
        raise ValueError(f"warps must lie in [1, {STRIP_MAX_WARPS}]")
    return min(warps, n_tr)


def strip_smem_bytes(V: int, TR: int, warps: int) -> int:
    """A block's dynamic shared memory (``strip_smem_bytes`` of the kernel):
    the int32 matrix, then each warp's TR codes and TR ring slots."""
    return 4 * (V * V + 2 * TR * warps)


def _strips(R_pad: int, width: int, TR: int, K: int) -> tuple[int, int]:
    """(strips, chunks) of a call, or ValueError for a shape the strip walk
    does not take."""
    if K not in (2, 4, 8):
        raise ValueError("cols_per_thread must be 2, 4 or 8")
    if TR < ROWS_PER_WORD or TR % ROWS_PER_WORD or R_pad <= 0 or R_pad % TR:
        raise ValueError(f"rows {R_pad} must be a positive multiple of tile_rows {TR}, "
                         f"itself a positive multiple of {ROWS_PER_WORD}")
    if width <= 0 or width % (32 * K):
        raise ValueError(f"width {width} must be a positive multiple of {32 * K}")
    return R_pad // TR, width // (32 * K)


def _strip_rows(rows: int, ckpt_every: int, tile_rows: int | None, with_dirs: bool) -> int:
    """``tile_rows``, or by default the largest strip height up to
    :data:`TILE_ROWS` (:data:`FORWARD_TILE_ROWS` without directions) that
    divides the call's rows and its checkpoint cadence (16 at the least, for
    rows that are multiples of 16)."""
    if tile_rows is not None:
        return int(tile_rows)
    tallest = TILE_ROWS if with_dirs else FORWARD_TILE_ROWS
    return math.gcd(int(rows), int(ckpt_every), tallest)


def plan_strips(R_pad: int, width: int, TR: int, K: int, V: int, *, sms: int,
                blocks_per_sm: int, warps: int | None = None) -> StripPlan:
    """The launch plan of one call of the strip walk: ``R_pad`` rows by
    ``width`` columns in strips of ``TR`` rows and chunks of 32·``K``
    columns, on a card of ``sms`` SMs that holds ``blocks_per_sm`` blocks of
    ``strip_warps(n_tr, warps)`` warps resident (what
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` says).  The grid is
    what the card holds resident, but never more warps than strips, nor
    more than :data:`STRIP_SPARE` times the strips that can be under way at
    once: a warp past those would only spin on the strip above.  ``TR`` is
    a positive multiple of 16; a lane runs :data:`STRIP_ROWS_PER_STEP` rows
    a step, and below 64 rows a chunk still takes 32 steps, since lane 0
    starts a chunk's rows only after lane 31 has finished them in the chunk
    before."""
    n_tr, n_tc = _strips(R_pad, width, TR, K)
    w = strip_warps(n_tr, warps)
    if blocks_per_sm < 1:
        raise ValueError(f"a block of {w} warps and {strip_smem_bytes(V, TR, w)} B of "
                         "shared memory does not fit on an SM")
    Q = TR // STRIP_ROWS_PER_STEP
    P = max(Q, 32)
    per_strip = (n_tc - 1) * P + Q + 31
    lag = Q + 31
    under_way = _cdiv(per_strip, lag)
    blocks = min(_cdiv(n_tr, w), blocks_per_sm * sms,
                 _cdiv(math.ceil(STRIP_SPARE * under_way), w))
    rounds = _cdiv(n_tr, blocks * w)
    return StripPlan(
        TR=TR, K=K, n_tr=n_tr, n_tc=n_tc, warps=w, blocks=blocks,
        smem_bytes=strip_smem_bytes(V, TR, w), ring_slots=TR, sync_ints=1,
        hand_words=width, under_way=under_way, steps_per_chunk=P,
        steps_per_strip=per_strip, lag_steps=lag,
        critical_steps=max((n_tr - 1) * lag, (rounds - 1) * per_strip) + per_strip)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, block: bool, K: int, dirs: bool, warps: int, V: int,
                   TR: int) -> int:
    lib = _build.load()
    fn = lib.wavefront_block_cs_occupancy if block else lib.wavefront_row_scan_occupancy
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(lib, fn(K, int(dirs), warps, V, TR, ctypes.byref(n)),
                     "wavefront strip occupancy")
    return n.value


def strip_plan(dev, block: bool, R_pad: int, width: int, TR: int, K: int, V: int,
               dirs: bool) -> StripPlan:
    """:func:`plan_strips` on CUDA device ``dev`` for the row-scan
    (``block`` false) or the column-block instance."""
    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    w = strip_warps(_strips(R_pad, width, TR, K)[0])
    return plan_strips(R_pad, width, TR, K, V, sms=_sms(index),
                       blocks_per_sm=_blocks_per_sm(index, block, K, dirs, w, V, TR))


# ---------------------------------------------------------------------------
# the fill
# ---------------------------------------------------------------------------


def _check_scan(q, t, matrix, h0, y_offset, C_real, R_real, ckpt_every, check_codes):
    dev = q.device
    for name, a in (("q", q), ("t", t), ("matrix", matrix), ("h0", h0)):
        if a is None:
            continue
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, q on {dev}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 1 or t.dim() != 1:
        raise ValueError("q (C_pad,) and t (R_pad,) expected")
    if matrix.dim() != 2 or matrix.shape[0] != matrix.shape[1]:
        raise ValueError(f"matrix must be (V, V), got {tuple(matrix.shape)}")
    C_pad, R_pad = q.numel(), t.numel()
    if not (1 <= C_real <= C_pad and R_real >= 1 and y_offset >= 0):
        raise ValueError("need 1 <= C_real <= C_pad, R_real >= 1, y_offset >= 0")
    if R_pad == 0 or R_pad % ROWS_PER_WORD:
        raise ValueError(f"R_pad must be a positive multiple of {ROWS_PER_WORD}")
    if y_offset > 0 and (h0 is None or tuple(h0.shape) != (C_pad,)):
        raise ValueError("a fill from y_offset > 0 needs h0 (C_pad,)")
    if ckpt_every and (ckpt_every < 0 or R_pad % ckpt_every):
        raise ValueError("ckpt_every must divide R_pad")
    if check_codes:
        # the kernel indexes the matrix with the codes unchecked
        V = matrix.shape[0]
        for name, a in (("q", q), ("t", t)):
            lo, hi = torch.aminmax(a)
            if int(lo) < 0 or int(hi) >= V:
                raise ValueError(f"{name} codes must lie in [0, {V})")


def row_scan(q, t, matrix, del_: int, ext: int, h0, y_offset: int, C_real: int,
             R_real: int, *, with_dirs: bool, ckpt_every: int = 0,
             tile_rows: int | None = None, cols_per_thread: int = COLS_PER_THREAD,
             check_codes: bool = True):
    """Fill ``R_pad`` rows of one global pair, from absolute row
    ``y_offset`` + 1 on.

    ``q`` (C_pad,) and ``t`` (R_pad,) int32 codes, padded with any valid
    code; ``matrix`` (V, V) int32, row = target symbol; ``del_``/``ext``
    integers; ``h0`` (C_pad,) int32, the row H[y_offset, 1..] (ignored,
    may be None, when ``y_offset`` is 0: the top row is then the border);
    ``C_real``/``R_real`` the pair's lengths, which place the end cell and
    the far-corner border values.  Returns ``(end, words, ckpts)``: ``end``
    (1,) int32 holds H[R_real, C_real] when that row lies in this call;
    ``words`` (R_pad/16, C_pad) int32 with ``with_dirs``; ``ckpts``
    (R_pad/ckpt_every, C_pad) int32 with ``ckpt_every``, ``ckpts[k]`` the
    row H[y_offset + (k+1)·ckpt_every].  Cells of padded rows and columns
    are unspecified.

    CUDA tensors launch the kernel, once (``R_pad`` and ``ckpt_every``
    must then be multiples of ``tile_rows``, by default the largest strip
    height up to :data:`TILE_ROWS` (:data:`FORWARD_TILE_ROWS` without
    directions) that divides both, ``C_pad`` of
    32·``cols_per_thread``; :func:`plan_strips` sizes the launch); CPU
    tensors take :func:`row_scan_plain`.
    """
    _check_scan(q, t, matrix, h0, y_offset, C_real, R_real, ckpt_every, check_codes)
    dev = q.device
    if dev.type == "cpu":
        return row_scan_plain(q, t, matrix, del_, ext, h0, y_offset, C_real, R_real,
                              with_dirs, ckpt_every)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C_pad, R_pad = q.numel(), t.numel()
    K, TR = int(cols_per_thread), _strip_rows(R_pad, ckpt_every, tile_rows, with_dirs)
    if ckpt_every % TR:
        raise ValueError("ckpt_every must be a multiple of tile_rows")
    with torch.cuda.device(dev):
        plan = strip_plan(dev, False, R_pad, C_pad, TR, K, matrix.shape[0], with_dirs)
        lib = _build.load()
        i32 = dict(dtype=torch.int32, device=dev)
        end = torch.zeros(1, **i32)
        # the call's own handoff row and ticket, zeroed on its stream
        hand = torch.zeros(plan.hand_words, dtype=torch.int64, device=dev)
        sync = torch.zeros(plan.sync_ints, **i32)
        words = torch.empty((R_pad // ROWS_PER_WORD, C_pad), **i32) if with_dirs else None
        ckpts = torch.empty((R_pad // ckpt_every, C_pad), **i32) if ckpt_every else None
        err = lib.wavefront_row_scan_launch(
            q.data_ptr(), t.data_ptr(), matrix.data_ptr(), matrix.shape[0],
            h0.data_ptr() if y_offset > 0 else None, hand.data_ptr(), sync.data_ptr(),
            int(y_offset), int(C_real), int(R_real), int(del_), int(ext), K, TR,
            plan.n_tr, plan.n_tc, end.data_ptr(), words.data_ptr() if with_dirs else None,
            ckpts.data_ptr() if ckpt_every else None, int(ckpt_every), plan.warps,
            plan.blocks, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "wavefront_row_scan")
        if with_dirs:
            launches.row_scan_dirs += 1
        else:
            launches.row_scan += 1
        launches.tile_launches += 1
    return end, words, ckpts


def row_scan_plain(q, t, matrix, del_: int, ext: int, h0, y_offset: int,
                   C_real: int, R_real: int, with_dirs: bool, ckpt_every: int = 0):
    """Plain PyTorch version of the fill kernel: one row per step, the row
    vectorised.  With ``M[x] = max(H[y-1,x-1] + s[x], H[y-1,x] - ext)`` and
    cell (1,1) and the left border folded into ``M[1]``, the horizontal
    chain is a max-prefix-scan,
    ``H[y,x] = cummax(M + x·ext)[x] - x·ext``; directions by the integer
    tie rule from the finished row.  Same arguments and results as
    :func:`row_scan`."""
    dev = q.device
    C_pad, R_pad = q.numel(), t.numel()
    del_, ext = int(del_), int(ext)
    i32 = dict(dtype=torch.int32, device=dev)
    x1 = torch.arange(1, C_pad + 1, **i32)
    xp = x1 * ext
    if y_offset == 0:
        prev = torch.where(x1 == C_real, -(C_real + 1) * del_, -x1 * del_).to(torch.int32)
    else:
        prev = h0.clone()
    srows = matrix[:, q.long()].contiguous()  # (V, C_pad): a score row per symbol
    t_codes = t.tolist()
    end = torch.zeros(1, **i32)
    words = (torch.empty((R_pad // ROWS_PER_WORD, C_pad), **i32) if with_dirs else None)
    ckpts = torch.empty((R_pad // ckpt_every, C_pad), **i32) if ckpt_every else None
    word = torch.zeros(C_pad, dtype=torch.int64, device=dev)

    def border(y: int) -> int:
        # H[y, 0] = -y*del, far corner H[tlen, 0] = -(tlen+1)*del
        return -(R_real + 1) * del_ if y == R_real else -y * del_

    for r in range(R_pad):
        y = y_offset + r + 1  # 1-based absolute row
        bprev, bcur = border(y - 1), border(y)
        diag = torch.empty_like(prev)
        diag[1:] = prev[:-1]
        diag[0] = bprev
        dv = diag + srows[t_codes[r]]
        m = torch.maximum(dv, prev - ext)
        # fold the left border into x = 1; cell (1,1) is the only cell
        # whose penalty is del (the very first cell in fill order)
        pen1 = del_ if y == 1 else ext
        m[0] = torch.maximum(dv[0], prev[0] - pen1).clamp_min(bcur - pen1)
        h = torch.cummax(m + xp, 0).values - xp
        if y == R_real:
            end[0] = h[C_real - 1]
        if with_dirs:
            pen_d = torch.full_like(h, ext)
            pen_d[0] = pen1
            top = prev - pen_d
            leftv = torch.empty_like(h)
            leftv[1:] = h[:-1]
            leftv[0] = bcur
            leftv -= pen_d
            # exact tie policy on integers: m - v < eps  <=>  m <= v
            d = torch.where(h <= top, TOP, torch.where(h <= leftv, LEFT, DIAG))
            word |= d.to(torch.int64) << (2 * (r % ROWS_PER_WORD))
            if r % ROWS_PER_WORD == ROWS_PER_WORD - 1:
                words[r // ROWS_PER_WORD] = _wrap_i32(word)
                word.zero_()
        if ckpt_every and (r + 1) % ckpt_every == 0:
            ckpts[(r + 1) // ckpt_every - 1] = h
        prev = h
    return end, words, ckpts


def _wrap_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the int32 with the same low 32 bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _unpack_dir_words(words: np.ndarray) -> np.ndarray:
    """(n, C_pad) packed words → (n*16, C_pad) uint8 interior dirs."""
    n, C_pad = words.shape
    d = np.zeros((n * ROWS_PER_WORD, C_pad), np.uint8)
    for k in range(ROWS_PER_WORD):
        d[k::ROWS_PER_WORD] = ((words >> (2 * k)) & 3).astype(np.uint8)
    return d


def _prep(q, t, matrix, del_, ext, device, wide: bool = False):
    """Shared host prep: validate, pad the query to :data:`COL_PAD`
    columns and put the query and the int32 matrix on ``device`` (``None``
    is the card, as everywhere in the package).  ``wide``: the caller cuts
    the columns into blocks, so the width cap of one plane does not apply."""
    q = np.asarray(q, np.int32)
    t = np.asarray(t, np.int32)
    matrix = np.asarray(matrix)
    V = matrix.shape[0]
    if not (_integral_int8(matrix, del_, ext) and range_ok(len(q), len(t), del_, ext)
            and (wide or len(q) <= MAX_WIDTH)):
        raise ValueError("wavefront engine: integral matrix/penalties, "
                         f"qlen <= {MAX_WIDTH}, and int32-range scores "
                         "(see range_ok) required")
    C_real, R_real = len(q), len(t)
    if C_real == 0 or R_real == 0:
        raise ValueError("empty sequence")
    for name, a in (("query", q), ("target", t)):
        if int(a.min()) < 0 or int(a.max()) >= V:
            raise ValueError(f"{name} codes must lie in the {V}-symbol scoring alphabet")
    C_pad = _cdiv(C_real, COL_PAD) * COL_PAD
    qp = np.zeros(C_pad, np.int32)  # padded columns score as symbol 0; never read
    qp[:C_real] = q
    device = resolve_device(device)
    return {
        "q": q, "t": t, "V": V, "C_real": C_real, "R_real": R_real, "C_pad": C_pad,
        "del": int(del_), "ext": int(ext), "device": device,
        "q_dev": torch.as_tensor(qp, device=device),
        "m_dev": torch.as_tensor(np.round(matrix).astype(np.int32), device=device),
    }


def _pad_rows(t: np.ndarray, multiple: int) -> np.ndarray:
    tp = np.zeros(_cdiv(len(t), multiple) * multiple, np.int32)
    tp[: len(t)] = t
    return tp


def _scan(pp, t_dev, h0, y_offset, *, with_dirs, ckpt_every=0, tr=TILE_ROWS,
          check_codes=False):
    return row_scan(pp["q_dev"], t_dev, pp["m_dev"], pp["del"], pp["ext"], h0, y_offset,
                    pp["C_real"], pp["R_real"], with_dirs=with_dirs,
                    ckpt_every=ckpt_every, tile_rows=tr, check_codes=check_codes)


def _check_tr(tr: int) -> None:
    if tr < ROWS_PER_WORD or tr % ROWS_PER_WORD:
        raise ValueError(f"tr must be a positive multiple of {ROWS_PER_WORD}")


def fill_single_global(q, t, matrix, del_: float, ext: float, *,
                       with_dirs: bool = True, tr: int = TILE_ROWS, device=None):
    """Exact global fill of ONE (query, target) pair.

    Returns ``(end_score, dirs)`` where ``dirs`` is the full
    (tlen+1, qlen+1) uint8 direction plane with reference borders (None in
    scores-only mode).  Requires :func:`supported`.
    """
    from ..observability import measure

    _check_tr(tr)
    pp = _prep(q, t, matrix, del_, ext, device)
    C_real, R_real, dev = pp["C_real"], pp["R_real"], pp["device"]
    t_dev = torch.as_tensor(_pad_rows(pp["t"], tr), device=dev)
    with measure(f"{dev.type}/wavefront", R_real * C_real, 1, device=dev):
        end, words, _ = _scan(pp, t_dev, None, 0, with_dirs=with_dirs, tr=tr)
    dirs = None
    if with_dirs:
        d = _unpack_dir_words(words.cpu().numpy())
        dirs = np.full((R_real + 1, C_real + 1), np.uint8(BEG))
        dirs[0, 1:] = np.uint8(LEFT)
        dirs[1:, 0] = np.uint8(TOP)
        dirs[1:, 1:] = d[:R_real, :C_real]
    return float(end.item()), dirs


# ---------------------------------------------------------------------------
# the replay walk
# ---------------------------------------------------------------------------


def new_walk(R_real: int, C_real: int, n_steps: int, device):
    """The cursor of one traceback and its step stream, on ``device``:
    ``state`` int32 (cy, cx, n) starting at the end cell (R_real, C_real)
    with no step taken, and ``steps`` int32 words for ``n_steps`` 2-bit
    codes, 16 per word, filled with Beginning."""
    state = torch.tensor([R_real, C_real, 0], dtype=torch.int32, device=device)
    steps = torch.full((_cdiv(n_steps, 16),), -1, dtype=torch.int32, device=device)
    return state, steps


def replay_walk(words, state, steps, *, row_base: int, col_base: int = 0,
                stats=None) -> None:
    """Walk one replayed block, **in place**: ``state`` and ``steps`` (from
    :func:`new_walk`) are updated where they lie.

    ``words`` (rows/16, C_pad) int32 are the packed directions of the
    absolute rows ``row_base`` + 1 … ``row_base`` + rows and the absolute
    columns ``col_base`` + 1 … ``col_base`` + C_pad.  From the cursor
    (cy, cx) the walk appends one 2-bit code per step at the running count
    n until it leaves the block's top (cy == ``row_base``) or its left edge
    (cx == ``col_base``: the left border of the plane for a block that
    starts at column 0); a cursor outside the block's rows or columns, or
    already on one of those edges, is left as it is.  CUDA tensors launch
    the kernel, one warp that keeps word rows of REPLAY_SPAN columns staged
    ahead of the cursor; CPU tensors take
    :func:`replay_walk_plain`.
    ``stats``: None, or an int32 (3,) tensor on the card to which the kernel
    adds the word rows it asked for, the rows it refilled and the rounds it
    walked (the plain version leaves it as it is).
    """
    dev = words.device
    for name, a in (("words", words), ("state", state), ("steps", steps)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, words on {dev}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.dim() != 2 or tuple(state.shape) != (3,) or steps.dim() != 1:
        raise ValueError("words (rows/16, C_pad), state (3,), steps (W,) expected")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int32
                              or tuple(stats.shape) != (3,)):
        raise ValueError("stats must be an int32 (3,) tensor on the words' device")
    if dev.type == "cpu":
        return replay_walk_plain(words, state, steps, row_base=row_base,
                                 col_base=col_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.wavefront_replay_walk_launch(
            words.data_ptr(), words.shape[1], int(row_base), int(col_base),
            words.shape[0] * ROWS_PER_WORD, state.data_ptr(), steps.data_ptr(),
            steps.numel() * 16, REPLAY_SPAN,
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "wavefront_replay_walk")
        launches.replay_walk += 1


def replay_walk_plain(words, state, steps, *, row_base: int, col_base: int = 0) -> None:
    """Plain version of the walk kernel: the words and the cursor are
    brought to the host, one cursor steps through them, and ``state`` and
    ``steps`` are written back in place."""
    w = words.cpu().numpy()
    cy, cx, n = (int(v) for v in state.cpu())
    rows = w.shape[0] * ROWS_PER_WORD
    y, x = cy - row_base, cx - col_base
    if y < 1 or y > rows or x < 1 or x > w.shape[1]:
        return
    budget = steps.numel() * 16
    codes, y, x = walk_block_host(w, y, x, budget - n)
    out = _unpack_step_words(steps.cpu().numpy(), budget)
    out[n : n + len(codes)] = codes
    steps.copy_(torch.from_numpy(_pack_step_codes(out)))
    state.copy_(torch.tensor([row_base + y, col_base + x, n + len(codes)],
                             dtype=torch.int32))


def walk_block_host(w: np.ndarray, y: int, x: int, budget: int | None = None):
    """One cursor through a block's packed words on the host: ``w``
    (rows/16, cols) int32 as the fills write them, the cursor at the
    block's cell (``y``, ``x``), 1-based.  Each step reads its code straight
    from its word and moves; the walk stops on the block's top or left edge
    (``y`` or ``x`` 0) or after ``budget`` steps.  Returns the codes taken and
    where the cursor stopped.  The walk of :func:`replay_walk_plain` and of
    the host walks (``walk="host"``)."""
    codes: list[int] = []
    while y > 0 and x > 0 and (budget is None or len(codes) < budget):
        r = y - 1
        d = (int(w[r >> 4, x - 1]) >> ((r & 15) * 2)) & 3
        codes.append(d)
        y -= d in (TOP, DIAG)
        x -= d in (LEFT, DIAG)
    return codes, y, x


def _unpack_step_words(packed: np.ndarray, n: int) -> np.ndarray:
    """(W,) int32 packed 2-bit step codes → (n,) uint8."""
    k = np.arange(16, dtype=np.int32) * 2
    d = (packed[:, None] >> k[None, :]) & 3
    return d.reshape(-1)[:n].astype(np.uint8)


def _pack_step_codes(codes: np.ndarray) -> np.ndarray:
    """(16·W,) step codes → (W,) int32, 16 codes per word."""
    k = np.arange(16, dtype=np.int64) * 2
    w = (codes.reshape(-1, 16).astype(np.int64) << k[None, :]).sum(axis=1)
    return (w & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def steps_to_chunks(packed, n: int, cy: int, cx: int, q, t):
    """Host-side decode of one walk's step stream.

    ``(cy, cx)`` is the absolute 1-based entry cell; returns the (qa, ta)
    int16 chunk pair in walk (reverse-alignment) order by cursor replay:
    the position BEFORE each step from running sums, no plane access (the
    scheme of ``ops/device_walk.decode_pair_batch``, for one long stream).
    """
    ds = _unpack_step_words(np.asarray(packed), n)
    up = (ds == TOP) | (ds == DIAG)
    lf = (ds == LEFT) | (ds == DIAG)
    y_at = cy - (np.cumsum(up) - up)
    x_at = cx - (np.cumsum(lf) - lf)
    qa = np.where(ds == TOP, BLANK, q[x_at - 1]).astype(np.int16)
    ta = np.where(ds == LEFT, BLANK, t[y_at - 1]).astype(np.int16)
    return qa, ta


def _assemble(pp, state, steps):
    """Download the finished walk and build the aligned pair with the
    reference's traceback semantics (seeded last characters, border runs;
    simple/mod.rs:99-127)."""
    cy, cx, n = (int(v) for v in state.cpu())
    return _assemble_steps(pp, cy, cx, n, steps[: _cdiv(n, 16)].cpu().numpy())


def _assemble_codes(pp, cy: int, cx: int, codes: list[int]):
    """:func:`_assemble` of a walk taken on the host: its codes in order and
    the cell where it stopped."""
    out = np.full(_cdiv(len(codes), 16) * 16, BEG, np.uint8)
    out[: len(codes)] = codes
    return _assemble_steps(pp, cy, cx, len(codes), _pack_step_codes(out))


def _assemble_steps(pp, cy: int, cx: int, n: int, packed: np.ndarray):
    q, t = pp["q"], pp["t"]
    C_real, R_real = pp["C_real"], pp["R_real"]
    if cy > 0 and cx > 0:
        raise RuntimeError(f"the walk stopped inside the plane at ({cy}, {cx})")
    qa_c, ta_c = steps_to_chunks(packed, n, R_real, C_real, q, t)
    qa_chunks = [np.array([q[-1]], np.int16), qa_c]
    ta_chunks = [np.array([t[-1]], np.int16), ta_c]
    if cx > 0:
        # border row: LEFT until (0, 0) (simple/mod.rs:61)
        qa_chunks.append(q[:cx][::-1].astype(np.int16))
        ta_chunks.append(np.full(cx, BLANK, np.int16))
    if cy > 0:
        # border column: TOP until (0, 0) (simple/mod.rs:66)
        qa_chunks.append(np.full(cy, BLANK, np.int16))
        ta_chunks.append(t[:cy][::-1].astype(np.int16))
    qa = np.concatenate(qa_chunks)[::-1]
    ta = np.concatenate(ta_chunks)[::-1]
    return (np.ascontiguousarray(qa), np.ascontiguousarray(ta),
            ((1, C_real), (1, R_real)))


def rescore_steps(packed, n: int, q, t, matrix, del_, ext) -> int:
    """The score of the path a walk took, under the global fill's own
    rules, in O(R + C) on the host.

    ``packed`` and ``n`` are a walk's step stream from the end cell
    (len(t), len(q)) to a border, as :func:`steps_to_chunks` reads it.  A
    DIAG step taken at cell (y, x) adds ``matrix[t[y], q[x]]``; a TOP or
    LEFT step subtracts ``ext``, or ``del_`` when it is taken at cell (1,1),
    the only cell whose penalty is ``del_`` (simple/mod.rs:72); the cell
    where the walk meets a border adds that border's value with its
    far-corner overwrite (H[0,x] = -x·del, H[0,C] = -(C+1)·del,
    H[y,0] = -y·del, H[R,0] = -(R+1)·del).

    The sum is the score of a real path through the plane, so it never
    exceeds H[R,C], and it equals H[R,C] only for an optimal path.  Holding
    it against the end score of an independent fill therefore holds the walk
    to an optimal path without a second alignment to compare with.  It does
    **not** prove the tie rule: among several optimal paths it cannot tell
    which one the reference's top > left > diagonal policy takes.
    """
    q, t = np.asarray(q), np.asarray(t)
    C, R = len(q), len(t)
    m = np.round(np.asarray(matrix)).astype(np.int64)
    del_, ext = int(del_), int(ext)
    ds = _unpack_step_words(np.asarray(packed), n)
    if np.any(ds == BEG):
        raise ValueError("a global walk holds no Beginning step")
    up = (ds == TOP) | (ds == DIAG)
    lf = (ds == LEFT) | (ds == DIAG)
    y_at = R - (np.cumsum(up) - up)  # the cell each step is taken at
    x_at = C - (np.cumsum(lf) - lf)
    cy, cx = R - int(up.sum()), C - int(lf.sum())
    if n and (y_at.min() < 1 or x_at.min() < 1):
        raise ValueError("the walk goes on past a border")
    if cy > 0 and cx > 0:
        raise ValueError(f"the walk stops inside the plane at ({cy}, {cx})")
    dg = ds == DIAG
    total = int(m[t[y_at[dg] - 1], q[x_at[dg] - 1]].sum())
    total -= ext * int((~dg).sum())
    total -= (del_ - ext) * int((~dg & (y_at == 1) & (x_at == 1)).sum())
    if cy == 0:
        total += -(C + 1) * del_ if cx == C else -cx * del_
    else:
        total += -(R + 1) * del_ if cy == R else -cy * del_
    return total


def alignment_steps(qa, ta):
    """The step stream behind an aligned pair, the inverse of
    :func:`_assemble`: ``(packed, n)`` as :func:`rescore_steps` takes them.
    The aligned strings end with the seeded last pair; before it, read
    backwards, every column is one step of the walk (a blank in the query
    is TOP, in the target LEFT, none DIAG) down to the first cell on a
    border, and the rest is the border run."""
    qa, ta = np.asarray(qa)[-2::-1], np.asarray(ta)[-2::-1]
    ds = np.where(qa == BLANK, TOP, np.where(ta == BLANK, LEFT, DIAG)).astype(np.uint8)
    up = (ds == TOP) | (ds == DIAG)
    lf = (ds == LEFT) | (ds == DIAG)
    # rows and columns still above and left of the cursor after each step
    y_left = int(up.sum()) - np.cumsum(up)
    x_left = int(lf.sum()) - np.cumsum(lf)
    on_border = np.flatnonzero((y_left == 0) | (x_left == 0))
    n = int(on_border[0]) + 1 if len(on_border) else len(ds)
    codes = np.full(_cdiv(n, 16) * 16, BEG, np.uint8)
    codes[:n] = ds[:n]
    return _pack_step_codes(codes), n


def align_single_global_direct(q, t, matrix, del_: float, ext: float, *,
                               tr: int = TILE_ROWS, device=None):
    """Exact alignment of ONE global pair from one direction plane: one
    fill with directions, one walk over its words on the device, and the
    host decode of the step stream.  For pairs of up to
    :data:`DIRECT_PLANE_CELLS` cells.  Returns
    ``(end_score, qa, ta, coords)``."""
    from ..observability import measure, span

    _check_tr(tr)
    pp = _prep(q, t, matrix, del_, ext, device)
    _count_plane(1)
    C_real, R_real, dev = pp["C_real"], pp["R_real"], pp["device"]
    t_dev = torch.as_tensor(_pad_rows(pp["t"], tr), device=dev)
    state, steps = new_walk(R_real, C_real, t_dev.numel() + pp["C_pad"] + 1, dev)
    with span("pair.forward", launches=2), measure(f"{dev.type}/wavefront", R_real * C_real,
                                                    1, device=dev):
        end, words, _ = _scan(pp, t_dev, None, 0, with_dirs=True, tr=tr)
        replay_walk(words, state, steps, row_base=0)
    with span("pair.decode"):
        qa, ta, coords = _assemble(pp, state, steps)
    return float(end.item()), qa, ta, coords


def _count_plane(row_blocks: int, engine: str = "row_scan") -> None:
    """A single plane's forward blocks and engine, on the caller's ``pair``
    span."""
    from ..observability import PAIR_ENGINES, count

    count(row_blocks=row_blocks, col_blocks=1, engine=PAIR_ENGINES.index(engine))


def _chunked_walk(pp, tb_rows: int, tr: int, sync_each_block: bool):
    """The device part of :func:`align_single_global_chunked`: the forward
    fill with checkpoints, then the block loop.  Returns the end score
    tensor, the checkpoint rows, the finished cursor and step stream (all
    on the device) and a record of what the call did."""
    from ..observability import counters, measure, span

    C_real, R_real, dev = pp["C_real"], pp["R_real"], pp["device"]
    # clamp the block to the (tr-aligned) target length so wide-short
    # pairs do not fill and replay mostly padding
    TB = min(tb_rows, _cdiv(R_real, tr) * tr)
    t_dev = torch.as_tensor(_pad_rows(pp["t"], TB), device=dev)  # block-aligned

    # --- forward: scores only, one checkpoint row every TB rows ---
    t0 = time.perf_counter()
    with span("pair.forward", launches=1), measure(f"{dev.type}/wavefront",
                                                    R_real * C_real, 1, device=dev):
        # the forward fill in the forward strip height, unless a tile was asked for
        end, _, ckpts = _scan(pp, t_dev, None, 0, with_dirs=False, ckpt_every=TB,
                              tr=None if tr == TILE_ROWS else tr)
    t1 = time.perf_counter()
    syncs = 1

    # --- backward: replay a block with directions, walk it, go up ---
    state, steps = new_walk(R_real, C_real, t_dev.numel() + pp["C_pad"] + 1, dev)
    blocks, n = 0, 0
    words = None
    with span("pair.replay") as replay:
        for j in range((R_real - 1) // TB, -1, -1):
            del words  # one block's words at a time
            # ckpts[k] = H[(k+1)*TB]: block j starts from checkpoint j - 1
            _, words, _ = _scan(pp, t_dev[j * TB : (j + 1) * TB],
                                ckpts[j - 1] if j else None, j * TB, with_dirs=True, tr=tr)
            with span("pair.walk") as walk:
                replay_walk(words, state, steps, row_base=j * TB)
                if sync_each_block:
                    n0 = n
                    cy, cx, n = (int(v) for v in state.cpu())
                    walk.count(steps=n - n0)
            blocks += 1
            if sync_each_block:
                syncs += 1
                if cy == 0 or cx == 0:
                    break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            syncs += 1
        replay.count(tiles=blocks, cells=blocks * TB * C_real)
    t2 = time.perf_counter()
    counters.record(f"{dev.type}/wavefront-replay", blocks * TB * C_real, 1, t2 - t1)
    info = dict(blocks=blocks, n_blocks=t_dev.numel() // TB, tb_rows=TB, syncs=syncs,
                forward_s=t1 - t0, replay_s=t2 - t1)
    return end, ckpts, state, steps, info


def _chunked_walk_host(pp, tb_rows: int, tr: int):
    """The host walk of :func:`align_single_global_chunked`
    (``aligner_tpu/ops/wavefront.py:1439-1474``): the same forward fill,
    then from the last block up, each block the cursor enters replayed with
    directions on the row-scan fill, its words brought to the host and
    walked there by :func:`walk_block_host`.  No walk kernel is launched.
    Returns the end score tensor and the walk's codes and last cell."""
    from ..observability import counters, measure, span

    C_real, R_real, dev = pp["C_real"], pp["R_real"], pp["device"]
    TB = min(tb_rows, _cdiv(R_real, tr) * tr)
    t_dev = torch.as_tensor(_pad_rows(pp["t"], TB), device=dev)
    with span("pair.forward", launches=1), measure(f"{dev.type}/wavefront",
                                                    R_real * C_real, 1, device=dev):
        end, _, ckpts = _scan(pp, t_dev, None, 0, with_dirs=False, ckpt_every=TB,
                              tr=None if tr == TILE_ROWS else tr)
    t1 = time.perf_counter()
    cy, cx, codes, blocks = R_real, C_real, [], 0
    with span("pair.replay") as replay:
        for j in range((R_real - 1) // TB, -1, -1):
            _, words, _ = _scan(pp, t_dev[j * TB : (j + 1) * TB],
                                ckpts[j - 1] if j else None, j * TB, with_dirs=True, tr=tr)
            with span("pair.walk") as walk:
                w = words.cpu().numpy()  # one block's words at a time
                del words
                c, y, cx = walk_block_host(w, cy - j * TB, cx)
                walk.count(steps=len(c))
            codes += c
            cy = j * TB + y
            blocks += 1
            if cy == 0 or cx == 0:
                break
        replay.count(tiles=blocks, cells=blocks * TB * C_real)
    counters.record(f"{dev.type}/wavefront-replay", blocks * TB * C_real, 1,
                    time.perf_counter() - t1)
    return end, cy, cx, codes


def align_single_global_chunked(q, t, matrix, del_: float, ext: float, *,
                                tb_rows: int = TB_ROWS, tr: int = TILE_ROWS,
                                device=None, sync_each_block: bool = True,
                                walk: str = "device"):
    """Exact alignment of ONE huge global pair in bounded memory.

    Checkpoint-and-replay traceback: a scores-only forward fill stores one
    H row every ``tb_rows`` rows (O(R/tb · C) ints instead of an O(R·C)
    direction plane); the backward walk then re-fills one tb-row block at
    a time *with* directions.  The replayed block is the identical DP
    restricted to those rows, so the walk follows the exact directions a
    full-plane traceback would (no tie-break divergence by construction).
    About twice the fill cost in total.

    The cursor and the step stream stay on the device.  With
    ``sync_each_block`` the host reads the cursor after every block and
    stops at the first block the walk ends in; without it, every block
    from the last to the first is replayed and walked with no wait in
    between (a block the cursor never enters is left untouched by the
    walk).  On an H100 the two take the same time within 2 % at
    65,536 x 65,536 (PERF.md §6, Findings), so the read that can stop
    early is the default.

    ``walk="host"`` walks each replayed block on the host instead
    (:func:`_chunked_walk_host`; the JAX package's ``ALIGNER_DEVICE_WALK=0``),
    with the same result.

    Returns ``(end_score, qa, ta, coords)`` with the reference's traceback
    semantics (seeded last characters, simple/mod.rs:99-127).
    """
    _check_tr(tr)
    if tb_rows < tr or tb_rows % tr:
        raise ValueError("tb_rows must be a positive multiple of tr")
    if walk not in ("device", "host"):
        raise ValueError(f"walk must be device or host, got {walk!r}")
    from ..observability import span

    pp = _prep(q, t, matrix, del_, ext, device)
    _count_plane(1)
    if walk == "host":
        end, cy, cx, codes = _chunked_walk_host(pp, tb_rows, tr)
        with span("pair.decode"):
            qa, ta, coords = _assemble_codes(pp, cy, cx, codes)
    else:
        end, _, state, steps, _ = _chunked_walk(pp, tb_rows, tr, sync_each_block)
        with span("pair.decode"):
            qa, ta, coords = _assemble(pp, state, steps)
    return float(end.item()), qa, ta, coords


# ---------------------------------------------------------------------------
# the band fill and the end score
# ---------------------------------------------------------------------------

# what a row of a band holds before it enters its first column: inert
# under max, and far enough from -2^31 to take a score on top
NEG_I32 = -(2**30)
LANES = 128  # band heights are multiples of this, as in the reference
# The band fill's sizes: the rows of one band, the rows a lane owns (a row
# group is 32 of them a lane, a warp's work item), the slots a warp reads
# ahead (the steps of one chunk: 16, 32 or 64) and the warps of a block.
# Chosen by sweeps at 65,536 x 65,536 and 262,144 x 262,144 on an H100,
# ops/band_probe.py's among them, recorded in PERF.md §6 (Findings).
# Up to the width cap squared a pair is one band.  BAND_TD is what the end
# score pads its streams to, as the reference tiles them, so that its bands
# match the reference's stream for stream; the kernel does not read it.
BAND_ROWS = 262144
BAND_TD = 128
BAND_ROWS_PER_LANE = 2
BAND_READ_AHEAD = 32
BAND_WARPS = 4


@dataclass(frozen=True)
class BandPlan:
    """One launch of the band walk (``csrc/wavefront_band.cu``) over
    ``n_g`` row groups of ``RW`` = 32·``K`` rows of a block ``Cb`` columns
    wide: ``blocks`` blocks of ``warps`` warps, each warp taking groups by
    ticket and walking a group's ``steps_per_group`` steps in chunks of
    ``P`` steps, reading ``P`` slots of the row above a chunk ahead;
    ``copies`` of the (V, V + 1) score table a block and ``smem_bytes`` of
    dynamic shared memory a block, as the kernel lays them out (its
    ``wavefront_band_occupancy`` says how many copies fit); zeroed device memory:
    ``sync_ints`` ints (the ticket) and ``hand_words`` 64-bit words (the
    row handed from group to group, tagged); ``lag_steps``, the least lag
    from a group's start of a chunk to the next group's (RW + P: the row of
    a chunk is written at the next chunk's start); ``under_way``, the
    groups that can run at once; and the launch's critical path in steps
    (``critical_steps``): the last group's start behind the lags, or behind
    the rounds of groups when fewer warps are resident than there are
    groups, and then its own steps."""

    K: int
    P: int
    RW: int
    n_g: int
    warps: int
    blocks: int
    copies: int
    smem_bytes: int
    sync_ints: int
    hand_words: int
    steps_per_group: int
    lag_steps: int
    under_way: int
    critical_steps: int


def _band_groups(TB: int, Cb: int, D: int, K: int, P: int) -> int:
    """The row groups of a call, or ValueError for a shape the band walk
    does not take."""
    if K not in (1, 2, 4, 8):
        raise ValueError("rows_per_lane must be 1, 2, 4 or 8")
    if P not in (16, 32, 64):
        raise ValueError("read_ahead must be 16, 32 or 64")
    if TB <= 0 or TB % (32 * K):
        raise ValueError(f"TB {TB} must be a positive multiple of {32 * K}")
    if Cb < 1 or D < Cb + TB - 1:
        raise ValueError(f"need Cb >= 1 and D >= Cb + TB - 1 = {Cb + TB - 1}, got {D}")
    return TB // (32 * K)


def plan_band(TB: int, Cb: int, D: int, K: int, P: int, *, sms: int, blocks_per_sm: int,
              copies: int, smem_bytes: int, warps: int | None = None) -> BandPlan:
    """The launch plan of one call of the band walk: ``TB`` rows by ``Cb``
    columns over streams of ``D`` slots, row groups of 32·``K`` rows read
    ``P`` slots ahead, on a card of ``sms`` SMs that holds ``blocks_per_sm``
    blocks of ``warps`` warps (by default :data:`BAND_WARPS`, never more
    than there are groups) resident, each with ``copies`` of the score
    table in ``smem_bytes`` of shared memory (what the kernel's
    ``wavefront_band_occupancy`` says).  The grid is what the card holds
    resident, but never more warps than groups."""
    n_g = _band_groups(TB, Cb, D, K, P)
    RW = 32 * K
    warps = BAND_WARPS if warps is None else warps
    if warps < 1:
        raise ValueError("warps must be at least 1")
    w = min(warps, n_g)
    if blocks_per_sm < 1:
        raise ValueError(f"a block of {w} warps and {smem_bytes} B of shared memory "
                         f"({copies} copies of the score table) does not fit on an SM")
    per_group = RW - 1 + Cb
    lag = RW + P
    blocks = min(_cdiv(n_g, w), blocks_per_sm * sms)
    rounds = _cdiv(n_g, blocks * w)
    return BandPlan(
        K=K, P=P, RW=RW, n_g=n_g, warps=w, blocks=blocks, copies=copies,
        smem_bytes=smem_bytes, sync_ints=1, hand_words=D, steps_per_group=per_group,
        lag_steps=lag, under_way=_cdiv(per_group, lag),
        critical_steps=max((n_g - 1) * lag, (rounds - 1) * per_group) + per_group)


@functools.lru_cache(maxsize=None)
def _band_fit(index: int, K: int, P: int, warps: int, V: int) -> dict:
    """The kernel's ``wavefront_band_occupancy`` on device ``index``: the
    blocks an SM holds, the copies of the table and the shared memory of a
    block."""
    lib = _build.load()
    n, copies, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(lib, lib.wavefront_band_occupancy(
            K, P, warps, V, ctypes.byref(n), ctypes.byref(copies), ctypes.byref(smem)),
            "wavefront band occupancy")
    return dict(blocks_per_sm=n.value, copies=copies.value, smem_bytes=smem.value)


def band_plan(dev, TB: int, Cb: int, D: int, K: int, P: int, V: int) -> BandPlan:
    """:func:`plan_band` on CUDA device ``dev`` with :data:`BAND_WARPS` and
    a ``V``-symbol matrix."""
    w = min(BAND_WARPS, _band_groups(TB, Cb, D, K, P))
    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    return plan_band(TB, Cb, D, K, P, sms=_sms(index), warps=w,
                     **_band_fit(index, K, P, w, V))


def _check_band(t_band, q, f, c1, c2, fd, matrix, scal, Cb, check_codes):
    dev = t_band.device
    for name, a in (("t_band", t_band), ("q", q), ("f", f), ("c1", c1), ("c2", c2),
                    ("fd", fd), ("matrix", matrix)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, t_band on {dev}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if matrix.dim() != 2 or matrix.shape[0] != matrix.shape[1]:
        raise ValueError(f"matrix must be (V, V), got {tuple(matrix.shape)}")
    TB, D = t_band.numel(), q.numel()
    if t_band.dim() != 1 or TB == 0:
        raise ValueError("t_band (TB,) with TB >= 1 expected")
    for name, a in (("q", q), ("f", f), ("c1", c1), ("c2", c2), ("fd", fd)):
        if a.dim() != 1 or a.numel() != D:
            raise ValueError(f"{name} must be a stream of {D} slots like q")
    if Cb < 1 or D < Cb + TB - 1:
        raise ValueError(f"the streams need Cb + TB - 1 = {Cb + TB - 1} slots, got {D}")
    j_end, d_end, owned = (int(v) for v in scal)
    if owned and not (0 <= j_end < TB and 1 <= d_end <= D):
        raise ValueError("an owned end cell must lie in the band's rows and steps")
    if check_codes:
        # the kernel indexes the matrix with the codes
        V = matrix.shape[0]
        for name, a, top in (("t_band", t_band, V - 1), ("q", q, V)):
            lo, hi = torch.aminmax(a)
            if int(lo) < 0 or int(hi) > top:
                raise ValueError(f"{name} codes must lie in [0, {top}]")
    return j_end, d_end, int(bool(owned))


def run_block_band(t_band, q, f, c1, c2, fd, matrix, scal, *, Cb: int, ext: int,
                   with_rc: bool = True, read_ahead: int = BAND_READ_AHEAD,
                   rows_per_lane: int = BAND_ROWS_PER_LANE, check_codes: bool = True,
                   blocked: bool = False):
    """Fill one block of a global pair, TB rows by ``Cb`` columns, by
    anti-diagonal steps, scores only.

    Row j of the block (absolute row y_base + j + 1) is on column d - j at
    step d = 1 … Cb + TB - 1.  Values travel in hat coordinates, the plain H
    plus d·``ext`` at the step d they belong to.  All arguments are flat
    int32 tensors on one device; a stream has D >= Cb + TB - 1 slots, slot k
    for step k + 1 (the reference tiles the same streams as
    (n_chunks, 1, TD), flat slot = chunk·TD + offset, and its lanes as
    (S, 128), flat row = sublane·128 + lane):

    * ``t_band`` (TB,) target codes of the block's rows;
    * ``q`` (D,) the query codes of the block's columns, then the padding
      code V, which scores 0: cells right of the real columns are
      unspecified;
    * ``f`` (D,) the row above the block as row 0 reads it from above,
      slot k = H[y_base, x0 + k + 1] + k·ext, with the correction for cell
      (1,1) folded into slot 0 by the caller;
    * ``fd`` (D,) the same row as row 0 reads it diagonally,
      slot k = H[y_base, x0 + k] + (k - 1)·ext, without that correction;
    * ``c1``, ``c2`` (D,) what row k reads at its first column, from the
      column lb[i] = H[y_base + i, x0] left of the block:
      c1[k] = lb[k] + (k - 1)·ext, c2[k] = lb[k + 1] + k·ext (with the (1,1)
      correction in c2[0]); only slots < TB are read;
    * ``matrix`` (V, V), row = target symbol; ``scal`` = (j_end, d_end,
      owned): the row and the step of the pair's end cell, and whether this
      block holds it.

    Returns ``(rb, rc, end)``: ``rb`` (D,) the block's last row in hat
    coordinates, slot k = H[y_base + TB, x0 + k + 2 - TB] + (k + 1)·ext (the
    slots before TB - 1 belong to no cell and are unspecified); ``rc`` (TB,)
    the plain right column H[y_base + j + 1, x0 + Cb], zeros without
    ``with_rc``; ``end`` (1,) the plain end cell if owned, else 0.  See
    :func:`band_streams` and :func:`band_handoff` for the two ends of a
    block.

    CUDA tensors launch the kernel, once (TB must then be a multiple of
    32·``rows_per_lane``, the rows of a warp's group; ``read_ahead``, 16, 32
    or 64, is the slots of the row above a warp reads a chunk ahead;
    :func:`plan_band` sizes the launch); CPU tensors take
    :func:`run_block_band_plain`.  ``blocked`` is the column-blocked
    pipeline's alone (``parallel.wavefront_sp._forward_band`` passes it):
    its launches are counted in ``launches.band_sp``, apart from the end
    score's ``launches.band``.
    """
    j_end, d_end, owned = _check_band(t_band, q, f, c1, c2, fd, matrix, scal, Cb,
                                      check_codes)
    dev = t_band.device
    if dev.type == "cpu":
        return run_block_band_plain(t_band, q, f, c1, c2, fd, matrix,
                                    (j_end, d_end, owned), Cb=Cb, ext=ext,
                                    with_rc=with_rc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    TB, D = t_band.numel(), q.numel()
    K, P, V = int(rows_per_lane), int(read_ahead), matrix.shape[0]
    with torch.cuda.device(dev):
        plan = band_plan(dev, TB, int(Cb), D, K, P, V)
        lib = _build.load()
        i32 = dict(dtype=torch.int32, device=dev)
        # the call's own handoff row and ticket, zeroed on its stream
        hand = torch.zeros(plan.hand_words, dtype=torch.int64, device=dev)
        sync = torch.zeros(plan.sync_ints, **i32)
        rb = torch.full((D,), NEG_I32, **i32)
        rc = torch.zeros(TB, **i32)
        end = torch.zeros(1, **i32)
        err = lib.wavefront_band_launch(
            t_band.data_ptr(), q.data_ptr(), f.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            fd.data_ptr(), matrix.data_ptr(), V, TB, D, int(Cb), int(ext), K, P, j_end,
            d_end, owned, int(bool(with_rc)), hand.data_ptr(), sync.data_ptr(),
            rb.data_ptr(), rc.data_ptr(), end.data_ptr(), plan.warps, plan.blocks,
            plan.copies, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "wavefront_band")
        if blocked:
            launches.band_sp += 1
        else:
            launches.band += 1
        launches.band_tile_launches += 1
    return rb, rc, end


def run_block_band_plain(t_band, q, f, c1, c2, fd, matrix, scal, *, Cb: int, ext: int,
                         with_rc: bool = True):
    """Plain PyTorch version of the band kernel: one step of the block per
    iteration, all TB rows at once.  ``a`` is every row's hat of the last
    step; shifted down one row it is what the row below reads from above,
    and the same shift one step later its diagonal, with row 0 fed from
    ``f`` and ``fd``.  Same arguments and results as :func:`run_block_band`."""
    dev = t_band.device
    TB, D, V = t_band.numel(), q.numel(), matrix.shape[0]
    ext = int(ext)
    j_end, d_end, owned = (int(v) for v in scal)
    i32 = dict(dtype=torch.int32, device=dev)
    # scores with the recurrence's 2·ext folded in; the padding code V scores 0
    m2 = torch.cat([matrix, torch.zeros((V, 1), **i32)], dim=1) + 2 * ext
    srows = m2[t_band.long()]  # (TB, V + 1): each row's scores by query code
    rows = torch.arange(TB, device=dev)
    a = torch.full((TB,), NEG_I32, **i32)
    u2 = torch.full((TB,), NEG_I32, **i32)
    qrow = torch.full((TB,), V, dtype=torch.int64, device=dev)
    qcodes = q.long().clamp(0, V)
    rb = torch.empty(D, **i32)
    rc = torch.zeros(TB, **i32)
    end = torch.zeros(1, **i32)
    for k in range(D):
        d = k + 1
        qrow = torch.cat([qcodes[k : k + 1], qrow[:-1]])
        s2 = srows[rows, qrow]
        v = u2 + s2
        v[0] = s2[0] + fd[k]
        if d <= TB:  # row d - 1 enters: its diagonal and left come from the column
            v[d - 1] = torch.maximum(s2[d - 1] + c1[k], c2[k])
        u1 = torch.cat([f[k : k + 1], a[:-1]])
        h = torch.maximum(torch.maximum(v, a), u1)
        if owned and d == d_end:
            end[0] = h[j_end] - d * ext
        if with_rc and 0 <= d - Cb < TB:
            rc[d - Cb] = h[d - Cb] - d * ext
        rb[k] = h[TB - 1]
        a, u2 = h, u1
    return rb, rc, end


def band_streams(prev, lb, ext: int, corr: int = 0):
    """The four input streams of one block from its two borders: ``prev``
    (D,) the row above in hat coordinates, slot k = H[y_base, x0 + k + 1] +
    k·ext, and ``lb`` (TB + 1,) the plain column left of it,
    lb[i] = H[y_base + i, x0].  ``corr`` is del - ext for the block that
    holds cell (1,1), the only cell whose gap penalty is del
    (simple/mod.rs:72), and 0 for every other.  Returns ``(f, c1, c2, fd)``."""
    D, TB = prev.numel(), lb.numel() - 1
    dvec = torch.arange(1, D + 1, dtype=torch.int32, device=prev.device)
    c1 = (dvec - 2) * ext
    c1[:TB] += lb[:TB]
    c2 = (dvec - 1) * ext
    c2[:TB] += lb[1:]
    f = prev.clone()
    if corr:
        c2[0] -= corr
        f[0] -= corr
    fd = torch.cat([prev.new_zeros(1), prev[:-1]])
    return f, c1, c2, fd


def band_handoff(rb, TB: int, ext: int):
    """A block's last-row stream as the block below takes its row above:
    dropping the hat, moving TB - 1 slots and putting the hat back on add up
    to one constant."""
    return torch.cat([rb[TB - 1:], rb.new_zeros(TB - 1)]) - TB * ext


def _band_end_score(pp, tb: int, td: int, rows_per_lane: int, block=None, trace=None):
    """The device part of :func:`end_score_single_global_diag`: the band
    loop with every stream on the device.  Returns the end score as a (1,)
    tensor on the device, nothing downloaded, and a record of the call.
    ``block`` is the fill of one band (:func:`run_block_band`, or its plain
    version to run that on the card too); a ``trace`` list receives every
    band's ``(args, kwargs, outputs)``; ``td`` only pads the streams (see
    :func:`end_score_single_global_diag`)."""
    C_real, R_real, dev = pp["C_real"], pp["R_real"], pp["device"]
    del_, ext, V = pp["del"], pp["ext"], pp["V"]
    mult = max(LANES, 32 * rows_per_lane)
    if tb < mult or tb % mult:
        raise ValueError(f"tb must be a positive multiple of {mult}, got {tb}")
    TB = min(tb, _cdiv(R_real, mult) * mult)
    n_bands = _cdiv(R_real, TB)
    Cb = pp["C_pad"]
    D = _cdiv(Cb + TB - 1, td) * td
    i32 = dict(dtype=torch.int32, device=dev)
    qs = np.full(D, V, np.int32)
    qs[:C_real] = pp["q"]
    qs = torch.as_tensor(qs, device=dev)
    t_dev = torch.as_tensor(_pad_rows(pp["t"], TB), device=dev)
    dvec = torch.arange(1, D + 1, **i32)
    # the border row H[0, x] with its far corner, in hat coordinates
    prev = (torch.where(dvec == C_real, -(C_real + 1) * del_, -dvec * del_)
            + (dvec - 1) * ext).to(torch.int32)
    kw = dict(Cb=Cb, ext=ext)
    extra = dict(with_rc=False)
    if block is None:
        block = run_block_band
        extra.update(rows_per_lane=rows_per_lane, check_codes=False)
    end = torch.full((1,), NEG_I32, **i32)
    for jb in range(n_bands):
        y_base = jb * TB
        # the border column H[y, 0] with its far corner
        ys = y_base + torch.arange(TB + 1, **i32)
        lb = torch.where(ys == R_real, -(R_real + 1) * del_, -ys * del_).to(torch.int32)
        streams = band_streams(prev, lb, ext, del_ - ext if jb == 0 else 0)
        j_end = R_real - 1 - y_base
        owned = 0 <= j_end < TB
        args = (t_dev[y_base : y_base + TB], qs, *streams, pp["m_dev"],
                (j_end, C_real + j_end, owned))
        out = block(*args, **kw, **extra)
        if trace is not None:
            trace.append((args, kw, out))
        prev = band_handoff(out[0], TB, ext)
        if owned:
            end = out[2]
    return end, dict(bands=n_bands, tb=TB, td=td, steps=D)


def end_score_single_global_diag(q, t, matrix, del_: float, ext: float, *,
                                 tb: int = BAND_ROWS, td: int = BAND_TD,
                                 device=None) -> float:
    """Exact global end score H[tlen, qlen] of ONE pair on the band fill:
    no plane, no directions, no traceback.  Requires :func:`supported`.

    ``tb`` is the band height (a multiple of 128, clamped to the padded
    target length).  ``td`` is the reference's signature: it pads the
    streams to a multiple of ``td`` steps, as the reference tiles them, so
    that a band matches the reference's stream for stream; it changes
    neither the band walk's steps nor its result.  The bands
    run one after another, each handing the next its last row; the streams
    of every band are built on the device and nothing comes back between
    bands: the call waits for the device once, for the end score.
    """
    from ..observability import counters, span

    pp = _prep(q, t, matrix, del_, ext, device)
    t0 = time.perf_counter()
    with span("pair.forward") as forward:
        end, info = _band_end_score(pp, tb, td, BAND_ROWS_PER_LANE)
        forward.count(launches=info["bands"])
        score = float(end.item())  # the call's one wait for the device
    _count_plane(info["bands"], "diag")
    counters.record(f"{pp['device'].type}/wavefront-band", pp["R_real"] * pp["C_real"],
                    1, time.perf_counter() - t0)
    return score


# ---------------------------------------------------------------------------
# the column-block fill
# ---------------------------------------------------------------------------


def _check_block(q_blk, t_rows, matrix, h_prev, lbound, x0, y_base, C_real, R_real,
                 ckpt_every, check_codes):
    dev = q_blk.device
    for name, a in (("q_blk", q_blk), ("t_rows", t_rows), ("matrix", matrix),
                    ("h_prev", h_prev), ("lbound", lbound)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, q_blk on {dev}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if matrix.dim() != 2 or matrix.shape[0] != matrix.shape[1]:
        raise ValueError(f"matrix must be (V, V), got {tuple(matrix.shape)}")
    if q_blk.dim() != 1 or t_rows.dim() != 1 or q_blk.numel() == 0:
        raise ValueError("q_blk (Cb,) and t_rows (TR,) expected")
    Cb, TR = q_blk.numel(), t_rows.numel()
    if TR == 0 or TR % ROWS_PER_WORD:
        raise ValueError(f"TR must be a positive multiple of {ROWS_PER_WORD}")
    if tuple(h_prev.shape) != (Cb,) or tuple(lbound.shape) != (TR + 1,):
        raise ValueError(f"h_prev ({Cb},) and lbound ({TR + 1},) expected")
    if x0 < 0 or y_base < 0 or C_real < 1 or R_real < 1:
        raise ValueError("need x0 >= 0, y_base >= 0, C_real >= 1, R_real >= 1")
    if ckpt_every and (ckpt_every < 0 or TR % ckpt_every):
        raise ValueError("ckpt_every must divide TR")
    if check_codes:
        # the kernel indexes the matrix with the codes unchecked
        V = matrix.shape[0]
        for name, a in (("q_blk", q_blk), ("t_rows", t_rows)):
            lo, hi = torch.aminmax(a)
            if int(lo) < 0 or int(hi) >= V:
                raise ValueError(f"{name} codes must lie in [0, {V})")


def run_block_cs(q_blk, t_rows, matrix, h_prev, lbound, x0: int, y_base: int,
                 C_real: int, R_real: int, *, del_: int, ext: int,
                 with_dirs: bool = False, ckpt_every: int = 0,
                 tile_rows: int | None = None, cols_per_thread: int = COLS_PER_THREAD,
                 check_codes: bool = True):
    """Fill TR rows of one **column block** of a global pair: the absolute
    rows ``y_base`` + 1 … ``y_base`` + TR of the columns ``x0`` + 1 … ``x0`` + Cb.

    All tensors are flat int32 on one device: ``q_blk`` (Cb,) and ``t_rows``
    (TR,) codes, padded with any valid code; ``matrix`` (V, V), row = target
    symbol; ``h_prev`` (Cb,) the row above the block, H[y_base, x0 + 1 …]
    (the caller builds the border row, far corner included, for ``y_base``
    0); ``lbound`` (TR + 1,) the column left of the block as its left
    neighbour returned it, lbound[r] = H[y_base + r, x0], slot 0 the corner
    (the border column, far corner included, for ``x0`` 0).  ``C_real`` and
    ``R_real`` are the pair's lengths: they place the end cell, and with
    ``x0`` and ``y_base`` cell (1,1), the only one whose penalty is ``del_``.

    Returns ``(h_new, rights, end, words, ckpts)``: ``h_new`` (Cb,) the
    block's last row; ``rights`` (TR,) its right column,
    H[y_base + r + 1, x0 + Cb], the next block's ``lbound`` without its
    corner; ``end`` (1,) the pair's end cell H[R_real, C_real] when it lies
    in this block, else 0 (a real end score may be 0: the caller decides
    ownership from the block's place); ``words`` (TR/16, Cb) with
    ``with_dirs``, in :func:`row_scan`'s layout, else None; ``ckpts``
    (TR/ckpt_every, Cb) with ``ckpt_every``, ``ckpts[k]`` the block's part of
    the row H[y_base + (k+1)·ckpt_every], as :func:`row_scan` returns them,
    else None.  Cells of padded rows and columns are unspecified.

    CUDA tensors launch the kernel, once (TR and ``ckpt_every`` must then
    be multiples of ``tile_rows``, by default the largest strip height up to
    :data:`TILE_ROWS` (:data:`FORWARD_TILE_ROWS` without directions) that
    divides both, Cb of 32·``cols_per_thread``;
    :func:`plan_strips` sizes the launch); CPU tensors take
    :func:`run_block_cs_plain`.  The reference's operands (the packed
    per-query score words, (S, 128) tiles, SMEM scalars) are not carried
    over.
    """
    x0, y_base, C_real, R_real = int(x0), int(y_base), int(C_real), int(R_real)
    _check_block(q_blk, t_rows, matrix, h_prev, lbound, x0, y_base, C_real, R_real,
                 ckpt_every, check_codes)
    dev = q_blk.device
    if dev.type == "cpu":
        return run_block_cs_plain(q_blk, t_rows, matrix, h_prev, lbound, x0, y_base,
                                  C_real, R_real, del_=del_, ext=ext, with_dirs=with_dirs,
                                  ckpt_every=ckpt_every)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Cb, TR = q_blk.numel(), t_rows.numel()
    K, TRt = int(cols_per_thread), _strip_rows(TR, ckpt_every, tile_rows, with_dirs)
    if ckpt_every % TRt:
        raise ValueError("ckpt_every must be a multiple of tile_rows")
    with torch.cuda.device(dev):
        plan = strip_plan(dev, True, TR, Cb, TRt, K, matrix.shape[0], with_dirs)
        lib = _build.load()
        i32 = dict(dtype=torch.int32, device=dev)
        end = torch.zeros(1, **i32)  # only the block that holds the end cell writes it
        h_new = torch.empty(Cb, **i32)
        # the call's own handoff row and ticket, zeroed on its stream
        hand = torch.zeros(plan.hand_words, dtype=torch.int64, device=dev)
        sync = torch.zeros(plan.sync_ints, **i32)
        rights = torch.empty(TR, **i32)
        words = torch.empty((TR // ROWS_PER_WORD, Cb), **i32) if with_dirs else None
        ckpts = torch.empty((TR // ckpt_every, Cb), **i32) if ckpt_every else None
        err = lib.wavefront_block_cs_launch(
            q_blk.data_ptr(), t_rows.data_ptr(), matrix.data_ptr(), matrix.shape[0],
            h_prev.data_ptr(), lbound.data_ptr(), h_new.data_ptr(), hand.data_ptr(),
            sync.data_ptr(),
            rights.data_ptr(), x0, y_base, C_real, R_real, int(del_), int(ext), K, TRt,
            plan.n_tr, plan.n_tc, end.data_ptr(), words.data_ptr() if with_dirs else None,
            ckpts.data_ptr() if ckpt_every else None, int(ckpt_every), plan.warps,
            plan.blocks, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "wavefront_block_cs")
        if with_dirs:
            launches.block_cs_dirs += 1
        else:
            launches.block_cs += 1
        launches.block_cs_tile_launches += 1
    return h_new, rights, end, words, ckpts


def run_block_cs_plain(q_blk, t_rows, matrix, h_prev, lbound, x0: int, y_base: int,
                       C_real: int, R_real: int, *, del_: int, ext: int,
                       with_dirs: bool = False, ckpt_every: int = 0):
    """Plain PyTorch version of the column-block kernel: :func:`row_scan_plain`
    with the left border read from ``lbound`` and the tests on a column made
    on the global column ``x0`` + x.  One row per step, the row a
    max-prefix-scan, ``H[y,x] = cummax(M + (x0 + x)·ext)[x] - (x0 + x)·ext``.
    Same arguments and results as :func:`run_block_cs`.  Any int32 table:
    M is at most the cell's H and at least the value above it less ext, and
    the offset (x0 + x)·ext lies within the slack :func:`range_ok` keeps, so
    a term of a real cell stays inside int32 whatever the matrix's entries."""
    dev = q_blk.device
    Cb, TR = q_blk.numel(), t_rows.numel()
    del_, ext = int(del_), int(ext)
    i32 = dict(dtype=torch.int32, device=dev)
    xp = (x0 + torch.arange(1, Cb + 1, **i32)) * ext
    prev = h_prev.clone()
    srows = matrix[:, q_blk.long()].contiguous()  # (V, Cb): a score row per symbol
    t_codes = t_rows.tolist()
    lb = lbound.tolist()
    c_loc = C_real - 1 - x0  # the end cell's column within the block
    end = torch.zeros(1, **i32)
    rights = torch.empty(TR, **i32)
    words = torch.empty((TR // ROWS_PER_WORD, Cb), **i32) if with_dirs else None
    ckpts = torch.empty((TR // ckpt_every, Cb), **i32) if ckpt_every else None
    word = torch.zeros(Cb, dtype=torch.int64, device=dev)
    left_ext = lbound[1:] - ext  # the cell to the left of the first column, less ext
    for r in range(TR):
        y = y_base + r + 1  # 1-based absolute row
        bcur = lb[r + 1]
        dv = torch.cat((lbound[r : r + 1], prev[:-1])) + srows[t_codes[r]]
        m = torch.maximum(dv, prev - ext)
        # fold the left boundary into the first column; the pair's cell
        # (1,1) is the only cell whose penalty is del
        pen1 = del_ if (y == 1 and x0 == 0) else ext
        if pen1 == ext:
            torch.maximum(m[:1], left_ext[r : r + 1], out=m[:1])
        else:
            m[0] = torch.maximum(dv[0], prev[0] - pen1).clamp_min(bcur - pen1)
        h = torch.cummax(m + xp, 0).values - xp
        rights[r : r + 1] = h[-1:]
        if y == R_real and 0 <= c_loc < Cb:
            end[0] = h[c_loc]
        if with_dirs:
            pen_d = torch.full_like(h, ext)
            pen_d[0] = pen1
            top = prev - pen_d
            leftv = torch.empty_like(h)
            leftv[1:] = h[:-1]
            leftv[0] = bcur
            leftv -= pen_d
            # exact tie policy on integers: m - v < eps  <=>  m <= v
            d = torch.where(h <= top, TOP, torch.where(h <= leftv, LEFT, DIAG))
            word |= d.to(torch.int64) << (2 * (r % ROWS_PER_WORD))
            if r % ROWS_PER_WORD == ROWS_PER_WORD - 1:
                words[r // ROWS_PER_WORD] = _wrap_i32(word)
                word.zero_()
        if ckpt_every and (r + 1) % ckpt_every == 0:
            ckpts[(r + 1) // ckpt_every - 1] = h
        prev = h
    return prev, rights, end, words, ckpts
