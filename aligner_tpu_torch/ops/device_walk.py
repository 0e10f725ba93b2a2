"""Batched traceback walk on the device (``csrc/device_walk.cu``), its
plain version, and the host decode of the step streams.

Counterpart of ``aligner_tpu/ops/device_walk.py`` (packed format).  The
full-mode fill leaves its packed direction words on the device; the walk
runs B cursors backward from (sy, sx) until Beginning and records the
2-bit step stream.  Only the packed streams, lengths and end cells leave
the device; the host rebuilds the aligned strings arithmetically from the
step stream (cumulative-sum cursor replay, no plane access).

Walk semantics are exactly the reference's (stop at Beginning; per-step
emission per simple/mod.rs:107-127/220-242 for pairs and
pwm/mod.rs:81-103 for PWM, whose borders are all Beginning: the walk runs
in ``"local"`` mode there).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

TOP, LEFT, DIAG, BEG = 0, 1, 2, 3
BLANK = np.int16(98)

# the kernel's launch plan: one warp a problem, at most WALK_WARPS warps a
# block, a ring of word rows of WALK_SPAN columns a warp (its WALK_DEPTH rows
# are csrc/walk_core.cuh's; timed by ops/walk_probe.py on an H100: PERF.md,
# Findings)
WALK_WARPS = 4
WALK_SPAN = 128


@dataclass(frozen=True)
class WalkPlan:
    """The launch of one batched walk: ``blocks`` blocks of ``warps`` warps,
    one warp a problem, each keeping word rows of ``span`` columns in shared
    memory."""

    warps: int
    blocks: int
    span: int


def plan_walk(B: int, C: int, *, sms: int, warps: int | None = None,
              span: int | None = None) -> WalkPlan:
    """The plan for B problems of C columns on a card of ``sms`` SMs, from
    at most ``warps`` warps a block and rows of ``span`` columns (by default
    WALK_WARPS, WALK_SPAN): a staged row is at most as wide as the plane (C
    rounded up to 4 columns), so a plane that narrow never refills; and the
    warps a block halve, down to one, while the blocks would leave an SM
    without one."""
    warps = WALK_WARPS if warps is None else warps
    span = WALK_SPAN if span is None else span
    if B < 1 or C < 1 or sms < 1:
        raise ValueError(f"B, C and sms must be positive, got {B}, {C}, {sms}")
    if not 1 <= warps <= 8 or span < 4:
        raise ValueError(f"1 <= warps <= 8 and span >= 4 expected, got {warps}, {span}")
    span = min(span, _cdiv(C, 4) * 4)
    while warps > 1 and _cdiv(B, warps) < sms:
        warps //= 2
    return WalkPlan(warps, _cdiv(B, warps), span)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def walk_plan(B: int, C: int, device) -> WalkPlan:
    """:func:`plan_walk` for ``device``'s card."""
    dev = torch.device(device)
    return plan_walk(B, C, sms=_sms(dev.index if dev.index is not None
                                    else torch.cuda.current_device()))


class _Launches:
    """Launch counts of :func:`walk`'s kernel and of :func:`walk_counts`'s
    (plain integers, bumped only where the kernel is launched)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.walk = 0
        self.walk_count = 0


launches = _Launches()


def _check_walk(words, sy, sx, S: int, stats) -> None:
    dev = words.device
    for name, a in (("words", words), ("sy", sy), ("sx", sx)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, words on {dev}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.dim() != 3:
        raise ValueError(f"words must be (B, R8/8, C), got {tuple(words.shape)}")
    B = words.shape[0]
    if tuple(sy.shape) != (B,) or tuple(sx.shape) != (B,):
        raise ValueError("sy and sx must be (B,)")
    if S < 1:
        raise ValueError("S must be positive")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int32
                              or tuple(stats.shape) != (3,)):
        raise ValueError("stats must be an int32 (3,) tensor on the words' device")


def walk(words, sy, sx, *, S: int, mode: str, stats=None):
    """Walk B packed planes for ``S`` steps.

    ``words``: (B, R8/8, C) int32 problem-major packed directions (word
    (r >> 3)·C + c holds row r at bit 2·(r & 7)); ``sy``/``sx``: (B,)
    int32 start cells.  Global borders are synthesised as Left/Top, local
    borders are Beginning.  Returns (steps (ceil(S/16), B) int32 — 16
    two-bit codes per word, Beginning-padded —, n, end_y, end_x).  CUDA
    tensors launch the kernel (plan :func:`walk_plan`); CPU tensors take
    :func:`walk_plain`.  ``stats``: None, or an int32 (3,) tensor on the
    card to which the kernel adds the word rows its walks asked for, the
    rows they refilled and the rounds they walked (the plain version leaves
    it as it is).
    """
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be local|global, got {mode!r}")
    _check_walk(words, sy, sx, S, stats)
    dev = words.device
    B, _, C = words.shape
    if dev.type == "cpu":
        return walk_plain(words, sy, sx, S=S, mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load()
    with torch.cuda.device(dev):
        steps = torch.empty((-(-S // 16), B), dtype=torch.int32, device=dev)
        n = torch.empty(B, dtype=torch.int32, device=dev)
        ey = torch.empty(B, dtype=torch.int32, device=dev)
        ex = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return steps, n, ey, ex
        p = walk_plan(B, max(C, 1), dev)
        err = lib.device_walk_launch(
            words.data_ptr(), words.shape[1], C, sy.data_ptr(), sx.data_ptr(),
            B, S, int(mode == "global"), steps.data_ptr(), n.data_ptr(),
            ey.data_ptr(), ex.data_ptr(), p.warps, p.blocks, p.span,
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "device_walk")
        launches.walk += 1
    return steps, n, ey, ex


def walk_counts(words, sy, sx, q, t, alive, V: int, *, S: int, stats=None):
    """The counting walk: :func:`walk` in local mode for ``S`` steps, then
    each member's (target char, query char) pairs counted from its step
    stream as :func:`count_pairs_plain` counts them, in one launch.  Returns
    the (B, V, V) int32 counts.

    ``words``, ``sy``, ``sx`` and ``stats`` as for :func:`walk`; ``q``
    (B, C) and ``t`` (B, R) int32 padded codes, which the caller must hold
    in [0, V): the kernel indexes its shared-memory counts with them and
    does not check them (a check would read them back to the host on every
    call), so a code out of range corrupts other members' counts.
    :func:`~aligner_tpu_torch.heuristic.heuristic_align_population` checks
    its codes once, before its first launch.  ``alive`` (B,) bool, the
    members whose seed pair counts.  CUDA tensors launch the counting walk (plan
    :func:`walk_plan`; a V whose counts do not fit a block's shared memory
    raises ``ValueError``); CPU tensors take :func:`walk_counts_plain`.
    """
    _check_walk(words, sy, sx, S, stats)
    _check_codes(words.device, words.shape[0], q, t, alive, V)
    dev = words.device
    if dev.type == "cpu":
        return walk_counts_plain(words, sy, sx, q, t, alive, V, S=S)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, _, C = words.shape
    lib = _build.load()
    with torch.cuda.device(dev):
        counts = torch.empty((B, V, V), dtype=torch.int32, device=dev)
        if B == 0:
            return counts
        steps = torch.empty((-(-S // 16), B), dtype=torch.int32, device=dev)
        n, ey, ex = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
        p = walk_plan(B, max(C, 1), dev)
        err = lib.device_walk_count_launch(
            words.data_ptr(), words.shape[1], C, sy.data_ptr(), sx.data_ptr(), B, S,
            steps.data_ptr(), n.data_ptr(), ey.data_ptr(), ex.data_ptr(),
            q.data_ptr(), q.shape[1], t.data_ptr(), t.shape[1], alive.data_ptr(), V,
            counts.data_ptr(), p.warps, p.blocks, p.span,
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err == -2:
            raise ValueError(f"the counts of {V} symbols, {p.warps} warps a block, do "
                             f"not fit a block's shared memory")
        _build.check(lib, err, "device_walk_count")
        launches.walk_count += 1
    return counts


def walk_counts_plain(words, sy, sx, q, t, alive, V: int, *, S: int):
    """Plain PyTorch version of the counting walk: :func:`walk_plain` in
    local mode, then :func:`count_pairs_plain` on its streams."""
    steps, n, _, _ = walk_plain(words, sy, sx, S=S, mode="local")
    return count_pairs_plain(steps, n, sy, sx, q, t, alive, V)


def _check_codes(dev, M: int, q, t, alive, V: int) -> None:
    """The checks of a count's codes, its ``alive`` flags and V, for M
    members on ``dev``."""
    for name, a in (("q", q), ("t", t), ("alive", alive)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the stream on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.bool if name == "alive" else torch.int32
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}, got {a.dtype}")
    if tuple(alive.shape) != (M,):
        raise ValueError(f"alive must be ({M},), got {tuple(alive.shape)}")
    for name, a in (("q", q), ("t", t)):
        if a.dim() != 2 or a.shape[0] != M or a.shape[1] < 1:
            raise ValueError(f"{name} must be ({M}, L) with L >= 1, got {tuple(a.shape)}")
    if V < 1:
        raise ValueError(f"V must be positive, got {V}")


def count_pairs_plain(steps, n, sy, sx, q, t, alive, V: int):
    """(M, V, V) int32 counts of (target char, query char) pairs of M
    walks: the heuristic population's frequency count, the counting walk's
    epilogue (``csrc/count_core.cuh``), as plain PyTorch.

    Counterpart of the step unpack and frequency scatter-add inside the JAX
    package's fused population loop (``aligner_tpu/heuristic.py:207-242``).
    ``steps``: (ceil(S/16), M) int32 packed step streams, 16 two-bit codes
    a word, step-major; ``n`` (M,) int32 steps each walk took; ``sy``/``sx``
    (M,) int32 its start cell; ``q`` (M, C) and ``t`` (M, R) int32 padded
    codes in [0, V); ``alive`` (M,) bool, the members whose seed pair counts.
    A pair is counted on each DIAG step, at the cursor before the step
    (``t[y - 1]``, ``q[x - 1]``, clipped to the codes as in the JAX
    package; TOP and LEFT steps put a blank on one side, alignment.rs:13-23),
    plus the seeded argmax pair ``t[sy - 1]``, ``q[sx - 1]`` of a member
    that is alive and has ``sy > 0`` and ``sx > 0``, so a member's counts
    equal ``Alignment.frequency_matrix()`` of its alignment, as integers.
    Every step of every walk is unpacked at once, the cursors by a
    cumulative sum, the DIAG pairs counted by one ``bincount`` (the JAX
    package's scatter-add)."""
    words, M = steps.shape
    dev = steps.device
    shifts = 2 * torch.arange(16, device=dev, dtype=torch.int64)
    d = ((steps.to(torch.int64)[:, None, :] >> shifts[None, :, None]) & 3).reshape(-1, M)
    up = ((d == TOP) | (d == DIAG)).to(torch.int64)
    lf = ((d == LEFT) | (d == DIAG)).to(torch.int64)
    y_at = sy.to(torch.int64)[None, :] - (torch.cumsum(up, 0) - up)
    x_at = sx.to(torch.int64)[None, :] - (torch.cumsum(lf, 0) - lf)
    k = torch.arange(16 * words, device=dev)[:, None]
    valid = (k < n.to(torch.int64)[None, :]) & (d == DIAG)
    R, C = t.shape[1], q.shape[1]
    tc = t.T.to(torch.int64).gather(0, (y_at - 1).clamp(0, R - 1))
    qc = q.T.to(torch.int64).gather(0, (x_at - 1).clamp(0, C - 1))
    member = torch.arange(M, device=dev, dtype=torch.int64)
    idx = member[None, :] * (V * V) + tc * V + qc
    seed_t = t.to(torch.int64).gather(1, (sy.to(torch.int64) - 1).clamp(0, R - 1)[:, None])[:, 0]
    seed_q = q.to(torch.int64).gather(1, (sx.to(torch.int64) - 1).clamp(0, C - 1)[:, None])[:, 0]
    seed_ok = alive & (sy > 0) & (sx > 0)
    sidx = member * (V * V) + seed_t * V + seed_q
    counts = torch.bincount(torch.cat([idx[valid], sidx[seed_ok]]), minlength=M * V * V)
    return counts.to(torch.int32).reshape(M, V, V)


def walk_plain(words, sy, sx, *, S: int, mode: str):
    """Plain PyTorch version of the walk kernel: one vectorised step over
    all B cursors per iteration (the ``lax.scan`` of the JAX package)."""
    B = words.shape[0]
    C = words.shape[2]
    flat = words.reshape(B, -1)
    W = flat.shape[1]
    y = sy.to(torch.int64)
    x = sx.to(torch.int64)
    n = torch.zeros(B, dtype=torch.int64, device=words.device)
    done = torch.zeros(B, dtype=torch.bool, device=words.device)
    S16 = -(-S // 16) * 16
    ds = torch.full((S16, B), BEG, dtype=torch.int64, device=words.device)
    for s in range(S):
        r = y - 1
        idx = ((r >> 3) * C + (x - 1)).clamp(0, W - 1)
        w = flat.gather(1, idx[:, None])[:, 0].to(torch.int64)
        d = (w >> ((r & 7) * 2)) & 3
        if mode == "global":
            d = torch.where(
                y == 0,
                torch.where(x >= 1, LEFT, BEG),
                torch.where(x == 0, torch.where(y >= 1, TOP, BEG), d),
            )
        else:
            d = torch.where((y < 1) | (x < 1), BEG, d)
        d = torch.where(done, BEG, d)
        act = d != BEG
        y = y - ((d == TOP) | (d == DIAG)).to(torch.int64)
        x = x - ((d == LEFT) | (d == DIAG)).to(torch.int64)
        n = n + act.to(torch.int64)
        done = done | ~act
        ds[s] = d
    shifts = (2 * torch.arange(16, device=words.device, dtype=torch.int64))[None, :, None]
    packed = (ds.reshape(S16 // 16, 16, B) << shifts).sum(1) & 0xFFFFFFFF
    packed = torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)
    i32 = torch.int32
    return packed, n.to(i32), y.to(i32), x.to(i32)


def pack_codes(codes: np.ndarray, rows_per_word: int) -> torch.Tensor:
    """(..., R, C) 2-bit codes -> (..., R/rows_per_word, C) int32 words on
    the CPU, row r at bit 2 * (r % rows_per_word); R a multiple of
    ``rows_per_word``.  The layout of the fill's direction words (8 rows a
    word) and of the walk's step streams (16 steps a word)."""
    *lead, R, C = codes.shape
    c = codes.astype(np.int64).reshape(*lead, R // rows_per_word, rows_per_word, C)
    w = (c << (2 * np.arange(rows_per_word))[:, None]).sum(-2) & 0xFFFFFFFF
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


def _unpack_steps(packed: np.ndarray, S: int) -> np.ndarray:
    """(ceil(S/16), B) int32 → (S, B) uint8 step codes."""
    k = np.arange(16, dtype=np.int32) * 2
    d = (packed[:, None, :] >> k[None, :, None]) & 3
    return d.reshape(-1, packed.shape[1])[:S].astype(np.uint8)


def walk_batch(words, mode: str, sy, sx, R: int, C: int):
    """Run the walk over B packed planes and return host-side
    (steps (S, B) uint8, lens, end_y, end_x).

    ``words``: the fill's (B, R8/8, C) int32 output on its device, or a
    sharded fill's tuple of such tensors, each on its own device, that
    split the batch in order: each shard is walked where its words lie,
    every walk is launched before any is read, and the results are joined
    in batch order.  ``R``/``C``: the interior plane dims (padded batch
    shapes), S = R+C+1.
    """
    S = R + C + 1
    sy = np.array(sy, np.int32)
    sx = np.array(sx, np.int32)
    walks, lo = [], 0
    for w in words if isinstance(words, tuple) else (words,):
        hi = lo + w.shape[0]
        walks.append(walk(w, torch.as_tensor(sy[lo:hi], device=w.device),
                          torch.as_tensor(sx[lo:hi], device=w.device), S=S, mode=mode))
        lo = hi
    packed, n, ey, ex = (np.concatenate([r[i].cpu().numpy() for r in walks], axis=-1)
                         for i in range(4))
    return _unpack_steps(packed, S), n, ey, ex


def _cursor_replay_all(d: np.ndarray, sy, sx):
    """All-problems cursor replay: (y, x) positions BEFORE each step for
    the whole (S, B) step array, as a running sum row by row (a cumsum
    along the step axis strides through the (S, B) array and runs about
    ten times slower at a 65,536-problem batch)."""
    up = (d == TOP) | (d == DIAG)
    lf = (d == LEFT) | (d == DIAG)
    y = np.array(sy, np.int64)
    x = np.array(sx, np.int64)
    y_at = np.empty(d.shape, np.int64)
    x_at = np.empty(d.shape, np.int64)
    for s in range(d.shape[0]):
        y_at[s] = y
        x_at[s] = x
        y -= up[s]
        x -= lf[s]
    return y_at, x_at


def _walked(steps, lens):
    """The rows of the (S, B) step array that some walk reaches; the rows
    after the longest walk are Beginning padding."""
    return steps[: int(np.max(lens, initial=0))]


def decode_pair_batch(steps, lens, sy, sx, q: np.ndarray, t: np.ndarray):
    """Aligned char arrays of ALL B problems from their step streams
    (reversed into alignment order, seed pair NOT included — the callers
    append it).  ``q``/``t`` are the padded (B, L) code arrays
    (simple/mod.rs:99-127 traceback at batch scale)."""
    steps = _walked(steps, lens)
    y_at, x_at = _cursor_replay_all(steps, sy, sx)
    # clip only guards rows past lens[b] (sliced off below); real steps
    # never gather out of range (a consuming step has cursor >= 1)
    qi = np.clip(x_at - 1, 0, q.shape[1] - 1)
    ti = np.clip(y_at - 1, 0, t.shape[1] - 1)
    qa_all = np.where(
        steps == TOP, BLANK, np.take_along_axis(q.T, qi, axis=0)
    ).astype(np.int16)
    ta_all = np.where(
        steps == LEFT, BLANK, np.take_along_axis(t.T, ti, axis=0)
    ).astype(np.int16)
    return (
        [qa_all[: lens[b], b][::-1] for b in range(steps.shape[1])],
        [ta_all[: lens[b], b][::-1] for b in range(steps.shape[1])],
    )


def decode_pwm_batch(steps, lens, sy, sx, q: np.ndarray):
    """PWM-mode decode of ALL B problems (``q`` is the padded (B, L) query
    code array): ``numbered`` gets the PWM position (0 for a gap), ``qa``
    the query character or BLANK (an_traceback pwm_mode semantics).  The
    rows of a PWM plane are the query, its columns the PWM positions.

    The cursor is replayed a step row at a time and each row decoded as it
    goes, so no (S, B) array of positions is built: at the repeat search's
    survivors (tens of thousands of windows of 330 bases against a PWM of
    300) those made the decode take seconds on the host."""
    steps = _walked(steps, lens)
    B = steps.shape[1]
    flat = np.ascontiguousarray(q.T).ravel()  # code (y, b) at y * B + b
    hi = q.shape[1] - 1
    cols = np.arange(B, dtype=np.int64)
    y = np.array(sy, np.int64)
    x = np.array(sx, np.int32)
    qa_all = np.empty(steps.shape, np.int16)
    num_all = np.empty(steps.shape, np.int32)
    for s, d in enumerate(steps):
        # clip only guards rows past lens[b] (sliced off below)
        at = flat.take(np.clip(y - 1, 0, hi) * B + cols)
        qa_all[s] = np.where(d == LEFT, BLANK, at)
        num_all[s] = np.where(d == TOP, 0, x)
        y -= (d == TOP) | (d == DIAG)
        x -= (d == LEFT) | (d == DIAG)
    return (
        [qa_all[: lens[b], b][::-1] for b in range(steps.shape[1])],
        [num_all[: lens[b], b][::-1] for b in range(steps.shape[1])],
    )
