"""The batched DP fill kernel (``csrc/dp_fill.cu``): wrappers, modules and
host-side unpacking of its direction words.

Counterpart of ``aligner_tpu/ops/pallas_dp.py``: one kernel covers the
scores-only specialisations (``fill_scores_traced``,
``fill_pwm_scores_traced``) and the direction-word ones
(``fill_full_traced``, ``fill_pwm_full_traced``), pair mode local and
global and PWM mode, argmax tracking on and off, float32 and float64, and
with directions the score plane (``with_scores_plane``: the interior
values, which :func:`planes_from_interior` gives borders, as
``pallas_dp._assemble`` does).
:func:`fill` (pair) and :func:`fill_pwm` (PWM) launch the kernel for CUDA
tensors and take the plain versions
(:func:`aligner_tpu_torch.ops.scan_engine.fill_batch`,
:func:`~aligner_tpu_torch.ops.scan_engine.fill_pwm_batch`) for CPU
tensors.

Each problem's DP column stays on chip: :func:`plan_fill` picks the
threads a block and the rows of each column held in shared memory (all of
them wherever they fit); the rest of a column taller than that lives in a
device buffer allocated for those rows alone.  A pair-mode fill with
directions and argmax tracking of no more problems than the card has SMs
takes the lone design instead (``dp_fill_kernel_lone``): a block a
problem, one lane carrying the recurrence and a warp beside it writing the
direction words and the argmax.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
from torch import nn

from . import _build
from .scan_engine import BEG, LEFT, TOP, FillResult, fill_batch, fill_pwm_batch, round8


class _Launches:
    """Launch counts of the fill kernel, by specialisation: pair mode
    (:func:`fill`) and PWM mode (:func:`fill_pwm`), scores only and with
    directions (plain integers, bumped only where the kernel is
    launched)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.scores = self.dirs = 0
        self.pwm_scores = self.pwm_dirs = 0
        self.spilled = 0  # of all the above: launches with rows off chip
        self.planes = 0  # of all the above: launches that wrote the score plane
        self.lone = 0  # of ``dirs``: launches of the lone design


launches = _Launches()

# a warp's problems are the unit of a block; more than this many warps a
# block never keeps more problems resident
MAX_WARPS = 4
# the lone design's block: the chain's warp and the companion's
LONE_THREADS = 64


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What the launch plan needs to know of a card."""

    sms: int
    smem_per_block: int  # the dynamic shared memory a block may opt in to
    smem_per_sm: int
    smem_reserved: int  # the shared memory the runtime keeps per resident block


@dataclasses.dataclass(frozen=True)
class FillPlan:
    """One launch of the fill kernel: ``threads`` a block (one problem
    each), ``rows_on_chip`` (S) rows 0..S-1 of each column in shared
    memory, ``smem_bytes`` of dynamic shared memory a block (the shared
    matrix, the columns, the row codes), ``resident_per_sm`` problems an SM
    can hold at once by shared memory, ``mat_bytes`` of shared matrix in
    shared memory (0: read through the L1 cache).  ``lone``: the lone
    design, ``threads`` for one problem (its matrix, three columns, two
    score buffers and the row codes in shared memory)."""

    threads: int
    rows_on_chip: int
    smem_bytes: int
    resident_per_sm: int
    mat_bytes: int
    lone: bool = False


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _lone_plan(R8: int, itemsize: int, card: CardLimits, mat_bytes: int) -> FillPlan | None:
    """The lone design's plan: the problem's matrix in shared memory where
    it fits beside the columns (else read through the L1 cache); None where
    the columns alone do not fit."""
    columns = R8 * (5 * itemsize + 1)
    for m in (mat_bytes, 0):
        smem = _round16(m) + columns
        if smem <= card.smem_per_block:
            blocks = min(card.smem_per_sm // (smem + card.smem_reserved), 2048 // LONE_THREADS)
            return FillPlan(LONE_THREADS, R8 + 1, smem, blocks, m, lone=True)
    return None


def plan_fill(R8: int, itemsize: int, B: int, card: CardLimits, mat_bytes: int, *,
              own_mat_bytes: int | None = None, warps: int | None = None,
              lone: bool | None = None) -> FillPlan:
    """The fill kernel's launch plan for B problems of ``R8`` rows in a
    float type of ``itemsize`` bytes, with ``mat_bytes`` of shared matrix
    in shared memory (0: none).

    ``own_mat_bytes`` is given for the instances the lone design builds
    (pair mode with directions and argmax tracking, no score plane): the
    bytes of one problem's matrix, shared or its own.  Such a fill of at
    most ``card.sms`` problems, each with an SM to itself, takes the lone
    design where its columns fit a block's shared memory.  ``lone`` forces
    the design (tests and probes); True raises ``ValueError`` where the
    lone design cannot run.

    Otherwise a problem keeps S rows of its column in shared memory
    (``itemsize`` bytes each) and the codes of rows 1..S-1 (a byte each);
    S = 1 + 8k, at most R8 + 1, so the rows off chip start on an 8-row
    block.  Over 1..``MAX_WARPS`` warps a block (only ``warps`` if given),
    the plan takes the most rows on chip, then the most problems resident
    per SM, then the fewest warps.  A block of more than one warp must
    still leave every SM a block: a small batch runs in one-warp blocks, as
    spread out as it can be.
    """
    forced = lone is not None
    if not forced:
        lone = own_mat_bytes is not None and B <= card.sms
    if lone:
        plan = None if own_mat_bytes is None else _lone_plan(R8, itemsize, card, own_mat_bytes)
        if plan is not None:
            return plan
        if forced:
            raise ValueError("the lone design runs pair-mode fills with directions and "
                             "argmax tracking whose columns fit a block's shared memory")
    room = card.smem_per_block - _round16(mat_bytes)
    best = None
    for w in (warps,) if warps else range(1, MAX_WARPS + 1):
        nt = 32 * w
        if w > 1 and warps is None and -(-B // nt) < card.sms:
            break
        # S * itemsize + (S - 1) bytes a problem, S = 1 + 8k
        k = min(R8 // 8, (room // nt - itemsize) // (8 * (itemsize + 1)))
        if k < 0:
            continue
        S = 1 + 8 * k
        smem = _round16(mat_bytes) + nt * (S * itemsize + S - 1)
        blocks_per_sm = min(card.smem_per_sm // (smem + card.smem_reserved), 32, 2048 // nt)
        plan = FillPlan(nt, S, smem, nt * blocks_per_sm, mat_bytes)
        key = (S, plan.resident_per_sm, -w)
        if best is None or key > best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"no launch of the fill kernel fits {mat_bytes} bytes of "
                         f"matrix in {card.smem_per_block} bytes of shared memory")
    return best[1]


_CARDS: dict[int, CardLimits] = {}


def card_limits(dev) -> CardLimits:
    """The launch plan's limits of CUDA device ``dev``, read once."""
    idx = torch.device(dev).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _CARDS:
        lib = _build.load()
        out = (ctypes.c_int * 4)()
        _build.check(lib, lib.dp_fill_device_limits(idx, out), "dp_fill_device_limits")
        _CARDS[idx] = CardLimits(*out)
    return _CARDS[idx]


def launch_plan(B: int, R8: int, matrix: torch.Tensor, *, pwm: bool = False,
                dirs: bool = False, track: bool = True, plane: bool = False) -> FillPlan:
    """The plan of one launch on ``matrix``'s card, for the instance the
    flags name (PWM mode, direction words, argmax tracking, the score
    plane): a shared matrix may sit in shared memory when it takes at most
    half of a block's; the lone design builds pair mode with directions and
    argmax tracking, without the plane."""
    card = card_limits(matrix.device)
    itemsize = matrix.element_size()
    own = (matrix[0].numel() if matrix.dim() == 3 else matrix.numel()) * itemsize
    mat_bytes = matrix.numel() * itemsize
    if matrix.dim() == 3 or mat_bytes > card.smem_per_block // 2:
        mat_bytes = 0
    lone = not pwm and dirs and track and not plane
    return plan_fill(R8, itemsize, B, card, mat_bytes, own_mat_bytes=own if lone else None)


_FLOATS = (torch.float32, torch.float64)


def _check_tensors(dev, ints, matrix) -> None:
    for name, a in (*ints, ("matrix", matrix)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, q on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, a in ints:
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
    if matrix.dtype not in _FLOATS:
        raise TypeError(f"matrix must be float32 or float64, got {matrix.dtype}")


def _check_codes(V: int, *named) -> None:
    # the kernel indexes the matrix with the codes unchecked
    for name, a in named:
        if a.numel():
            lo, hi = torch.aminmax(a)
            if int(lo) < 0 or int(hi) >= V:
                raise ValueError(f"{name} codes must lie in [0, {V})")


def _query_row(q):
    """The codes ``q`` holds: its one row when its batch axis has stride 0
    (a query every problem reads, ``expand``ed from a (C,) row), else
    ``q``."""
    return q[0] if q.dim() == 2 and len(q) > 0 and q.stride(0) == 0 else q


def _check(q, qlen, t, tlen, matrix, code_range=None) -> None:
    row = _query_row(q)
    # t may also be the .T view of a contiguous (R, B) tensor
    _check_tensors(q.device, (("q", row), ("qlen", qlen),
                              ("t", t if t.is_contiguous() or t.dim() != 2 else t.T),
                              ("tlen", tlen)), matrix)
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"q (B, C) and t (B, R) expected, got {tuple(q.shape)}, "
                         f"{tuple(t.shape)}")
    B = q.shape[0]
    if tuple(qlen.shape) != (B,) or tuple(tlen.shape) != (B,):
        raise ValueError("qlen and tlen must be (B,)")
    if matrix.dim() == 3:
        if matrix.shape[0] != B or matrix.shape[1] != matrix.shape[2]:
            raise ValueError(f"batched matrix must be (B, V, V), got "
                             f"{tuple(matrix.shape)}")
    elif matrix.dim() != 2 or matrix.shape[0] != matrix.shape[1]:
        raise ValueError(f"matrix must be (V, V), got {tuple(matrix.shape)}")
    V = matrix.shape[-1]
    if code_range is None:
        _check_codes(V, ("q", row), ("t", t))
    elif code_range[0] < 0 or code_range[1] >= V:
        raise ValueError(f"codes from {code_range[0]} to {code_range[1]} must lie in [0, {V})")


def _check_pwm(q, qlen, pwm) -> None:
    if q.dim() != 2:
        raise ValueError(f"q (B, R) expected, got {tuple(q.shape)}")
    # q may also be the .T view of a contiguous (R, B) tensor
    _check_tensors(q.device, (("q", q if q.is_contiguous() else q.T),
                              ("qlen", qlen)), pwm)
    B = q.shape[0]
    if tuple(qlen.shape) != (B,):
        raise ValueError("qlen must be (B,)")
    if pwm.dim() == 3:
        if pwm.shape[0] != B or pwm.shape[1] != 4:
            raise ValueError(f"batched PWM must be (B, 4, W), got {tuple(pwm.shape)}")
    elif pwm.dim() != 2 or pwm.shape[0] != 4:
        raise ValueError(f"PWM must be (4, W), got {tuple(pwm.shape)}")
    _check_codes(4, ("q", q))


def fill(q, qlen, t, tlen, matrix, del_: float, ext: float, *,
         mode: str = "local", track_argmax: bool = True,
         with_dirs: bool = False, with_scores_plane: bool = False,
         code_range: tuple[int, int] | None = None) -> FillResult:
    """Batched exact fill of B (query, target) problems.

    ``q`` (B, C) and ``t`` (B, R) int32 codes, ``qlen``/``tlen`` (B,)
    int32, ``matrix`` (V, V) or (B, V, V) float32/float64, all contiguous
    on one device; ``q`` may also be one contiguous (C,) row expanded over
    the batch (stride 0), a query that every problem reads, and ``t`` the
    ``.T`` view of a contiguous (R, B) tensor (the kernel's own layout,
    read in place when R is a multiple of 8).  CUDA tensors launch the
    kernel; CPU tensors take the plain version.  Global mode always tracks
    the argmax.  With ``with_dirs``, ``with_scores_plane`` also returns the
    score plane's interior (``FillResult.plane``, (B, C, R8)) and tracks
    the argmax.  ``code_range``: the lowest and highest code of ``q`` and
    ``t`` where the caller knows them; the matrix is checked against them,
    and no code is read on the device.
    """
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be local|global, got {mode!r}")
    _check(q, qlen, t, tlen, matrix, code_range)
    if q.device.type == "cpu":
        return fill_batch(q, qlen, t, tlen, matrix, del_, ext, mode=mode,
                          track_argmax=track_argmax, with_dirs=with_dirs,
                          with_scores_plane=with_scores_plane)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, qlen, t, tlen, matrix, del_, ext, mode, track_argmax,
                   with_dirs, with_scores_plane)


def fill_pwm(q, qlen, pwm, del_: float, ext: float, *, track_argmax: bool = True,
             with_dirs: bool = False, with_scores_plane: bool = False) -> FillResult:
    """Batched exact local fill of B queries against a position-weight
    matrix: the plane is (qlen+1, W+1), rows are query positions and
    every PWM column is active.

    ``q`` (B, R) int32 codes in [0, 4) — contiguous, or the ``.T`` view of
    a contiguous (R, B) tensor (the kernel's own layout, read in place
    when R is a multiple of 8) —, ``qlen`` (B,) int32, ``pwm`` (4, W) or
    (B, 4, W) float32/float64, all on one device.  CUDA tensors launch the
    kernel; CPU tensors take the plain version.  The direction words are
    (B, R8/8, W) int32, problem-major; ``with_scores_plane`` as in
    :func:`fill`, the plane (B, W, R8).
    """
    _check_pwm(q, qlen, pwm)
    if q.device.type == "cpu":
        return fill_pwm_batch(q, qlen, pwm, del_, ext, track_argmax=track_argmax,
                              with_dirs=with_dirs, with_scores_plane=with_scores_plane)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(None, None, q, qlen, pwm, del_, ext, "pwm", track_argmax,
                   with_dirs, with_scores_plane)


def _launch(q, qlen, t, tlen, matrix, del_, ext, mode, track_argmax, with_dirs,
            with_scores_plane):
    """One kernel launch.  PWM mode: ``q``/``qlen`` are None, ``t`` holds
    the query codes (the rows) and ``tlen`` their lengths."""
    is_pwm = mode == "pwm"
    is_global = mode == "global"
    with_plane = with_dirs and with_scores_plane
    track = track_argmax or is_global or with_plane
    dev = t.device
    B, R = t.shape
    C = matrix.shape[-1] if is_pwm else q.shape[1]
    R8 = round8(R)
    V = matrix.shape[-2]
    if not is_pwm and V > 256:
        raise ValueError(f"the fill kernel keeps row codes in bytes: at most 256 "
                         f"symbols, got a {V} x {V} matrix")
    dtype = matrix.dtype
    lib = _build.load()
    with torch.cuda.device(dev):
        plan = launch_plan(B, R8, matrix, pwm=is_pwm, dirs=with_dirs, track=track,
                           plane=with_plane)
        S = plan.rows_on_chip
        # (R8, B) and (C, B): a warp's 32 problems read 32 neighbouring words;
        # a query row expanded over the batch is broadcast into (C, B) here
        tT = t.T if R == R8 and t.T.is_contiguous() else None
        if tT is None:
            tT = torch.zeros((R8, B), dtype=torch.int32, device=dev)
            tT[:R] = t.T
        qT = None if is_pwm else q.T.contiguous()
        # rows S..R8 of each column, when the whole column does not fit on chip
        spill = (torch.empty((R8 + 1 - S, B), dtype=dtype, device=dev)
                 if S <= R8 else None)
        fmax = torch.empty(B, dtype=dtype, device=dev)
        fy = torch.empty(B, dtype=torch.int32, device=dev)
        fx = torch.empty(B, dtype=torch.int32, device=dev)
        end = torch.empty(B, dtype=dtype, device=dev)
        words = (torch.empty((B, R8 // 8, C), dtype=torch.int32, device=dev)
                 if with_dirs else None)
        plane = (torch.empty((B, C, R8), dtype=dtype, device=dev) if with_plane
                 else None)
        if B == 0:
            return FillResult(fmax, fy, fx, end, words, plane)
        if plan.lone:
            err = lib.dp_fill_lone_launch(
                qT.data_ptr(), tT.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                matrix.data_ptr(), matrix[0].numel() if matrix.dim() == 3 else 0,
                V, B, C, R8, float(del_), float(ext), int(dtype == torch.float64),
                int(is_global), fmax.data_ptr(), fy.data_ptr(), fx.data_ptr(),
                end.data_ptr(), words.data_ptr(), int(plan.mat_bytes > 0), plan.smem_bytes,
                torch.cuda.current_stream(dev).cuda_stream,
            )
            _build.check(lib, err, "dp_fill")
            launches.dirs += 1
            launches.lone += 1
            return FillResult(fmax, fy, fx, end, words, plane)
        err = lib.dp_fill_launch(
            None if is_pwm else qT.data_ptr(), tT.data_ptr(),
            None if is_pwm else qlen.data_ptr(), tlen.data_ptr(),
            matrix.data_ptr(), matrix[0].numel() if matrix.dim() == 3 else 0,
            V, B, C, R8, float(del_), float(ext),
            int(dtype == torch.float64), int(is_pwm), int(is_global), int(track),
            int(with_dirs), None if spill is None else spill.data_ptr(),
            fmax.data_ptr(), fy.data_ptr(), fx.data_ptr(), end.data_ptr(),
            words.data_ptr() if with_dirs else None,
            plane.data_ptr() if with_plane else None,
            plan.threads, S, int(plan.mat_bytes > 0), plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "dp_fill")
        if spill is not None:
            launches.spilled += 1
        if with_plane:
            launches.planes += 1
        if is_pwm:
            if with_dirs:
                launches.pwm_dirs += 1
            else:
                launches.pwm_scores += 1
        elif with_dirs:
            launches.dirs += 1
        else:
            launches.scores += 1
    return FillResult(fmax, fy, fx, end, words, plane)


class DPFill(nn.Module):
    """Scoring state of a batched fill: the matrix (a buffer) and the gap
    penalties.  Calling it runs :func:`fill` on the given problems."""

    def __init__(self, matrix: torch.Tensor, del_: float, ext: float):
        super().__init__()
        self.register_buffer("matrix", matrix.contiguous())
        self.del_ = float(del_)
        self.ext = float(ext)

    @classmethod
    def from_numpy(cls, matrix, del_: float, ext: float, *, device,
                   dtype: torch.dtype) -> "DPFill":
        """Carry the JAX package's scoring state across: a numpy (V, V) or
        (B, V, V) matrix and the gap penalties."""
        m = np.asarray(matrix)
        if m.ndim not in (2, 3):
            raise ValueError(f"matrix must be (V, V) or (B, V, V), got {m.shape}")
        return cls(torch.as_tensor(np.array(m), dtype=dtype, device=device), del_, ext)

    def forward(self, q, qlen, t, tlen, *, mode: str = "local",
                track_argmax: bool = True, with_dirs: bool = False,
                with_scores_plane: bool = False,
                code_range: tuple[int, int] | None = None) -> FillResult:
        return fill(q, qlen, t, tlen, self.matrix, self.del_, self.ext,
                    mode=mode, track_argmax=track_argmax, with_dirs=with_dirs,
                    with_scores_plane=with_scores_plane, code_range=code_range)


class PWMFill(nn.Module):
    """Scoring state of a batched PWM fill: the (4, W) or (B, 4, W)
    position-weight matrix (a buffer) and the gap penalties.  Calling it
    runs :func:`fill_pwm` on the given queries."""

    def __init__(self, pwm: torch.Tensor, del_: float, ext: float):
        super().__init__()
        self.register_buffer("pwm", pwm.contiguous())
        self.del_ = float(del_)
        self.ext = float(ext)

    @classmethod
    def from_numpy(cls, pwm, del_: float, ext: float, *, device,
                   dtype: torch.dtype) -> "PWMFill":
        """Carry the JAX package's PWM across: a numpy (4, W) or (B, 4, W)
        array and the gap penalties."""
        m = np.asarray(pwm)
        if m.ndim not in (2, 3) or m.shape[-2] != 4:
            raise ValueError(f"PWM must be (4, W) or (B, 4, W), got {m.shape}")
        return cls(torch.as_tensor(np.array(m), dtype=dtype, device=device), del_, ext)

    def forward(self, q, qlen, *, track_argmax: bool = True,
                with_dirs: bool = False, with_scores_plane: bool = False) -> FillResult:
        return fill_pwm(q, qlen, self.pwm, self.del_, self.ext,
                        track_argmax=track_argmax, with_dirs=with_dirs,
                        with_scores_plane=with_scores_plane)


# byte → its four 2-bit direction codes (for host-side plane unpacking)
_UNPACK_LUT = np.array(
    [[(b >> (2 * k)) & 3 for k in range(4)] for b in range(256)], dtype=np.uint8
)


def _unpack_words_pm(w: np.ndarray, R: int, C: int) -> np.ndarray:
    """Problem-major packed words (B, R//8, C) int32 → (B, R, C) uint8
    direction codes (each word uses its low 2 bytes)."""
    B = w.shape[0]
    w8 = np.ascontiguousarray(w).view(np.uint8).reshape(B, R // 8, C, 4)[..., :2]
    d = _UNPACK_LUT[w8]  # (B, R//8, C, 2, 4) u8
    return np.transpose(d, (0, 1, 3, 4, 2)).reshape(B, R, C)


def dirs_from_packed(w: np.ndarray, qlen, tlen, mode: str) -> np.ndarray:
    """Problem-major packed direction words → (B, R+1, C+1) uint8 planes
    with the reference border directions (simple/mod.rs:61,66)."""
    B, R8, C = w.shape
    R = R8 * 8
    d = _unpack_words_pm(w, R, C)
    qlen = np.asarray(qlen)
    tlen = np.asarray(tlen)
    dirs = np.full((B, R + 1, C + 1), np.uint8(BEG))
    if mode == "global":
        xs = np.arange(1, C + 1, dtype=np.int32)
        ys = np.arange(1, R + 1, dtype=np.int32)
        dirs[:, 0, 1:] = np.where(
            xs[None, :] <= qlen[:, None], np.uint8(LEFT), np.uint8(BEG)
        )
        dirs[:, 1:, 0] = np.where(
            ys[None, :] <= tlen[:, None], np.uint8(TOP), np.uint8(BEG)
        )
    dirs[:, 1:, 1:] = d
    return dirs


def planes_from_interior(v: np.ndarray, qlen, tlen, mode: str, del_: float,
                         rows: int) -> np.ndarray:
    """The score plane's interior (B, C, R8), as a fill returns it
    (``FillResult.plane`` on the host) → (B, rows+1, C+1) planes in its dtype
    with the reference's borders (``pallas_dp._assemble``): global rows and
    columns ``-i·del`` with the far corners ``-(len+1)·del``, local borders
    0.  Rows past ``rows``, the 8-row padding, are dropped."""
    B, C, R8 = v.shape
    plane = np.zeros((B, R8 + 1, C + 1), v.dtype)
    if mode == "global":
        qlen = np.asarray(qlen)
        tlen = np.asarray(tlen)
        fdt = plane.dtype
        xs = np.arange(1, C + 1, dtype=np.int32)
        ys = np.arange(1, R8 + 1, dtype=np.int32)
        qlf = qlen.astype(fdt)[:, None]
        tlf = tlen.astype(fdt)[:, None]
        plane[:, 0, 1:] = np.where(xs[None, :] == qlen[:, None],
                                   -(qlf + 1) * del_, -xs[None, :].astype(fdt) * del_)
        plane[:, 1:, 0] = np.where(ys[None, :] == tlen[:, None],
                                   -(tlf + 1) * del_, -ys[None, :].astype(fdt) * del_)
    plane[:, 1:, 1:] = np.transpose(v, (0, 2, 1))
    return plane[:, : rows + 1]
