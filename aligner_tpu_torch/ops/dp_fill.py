"""The batched DP fill kernel (``csrc/dp_fill.cu``): wrappers, modules and
host-side unpacking of its direction words.

Counterpart of ``aligner_tpu/ops/pallas_dp.py``: one kernel covers the
scores-only specialisations (``fill_scores_traced``,
``fill_pwm_scores_traced``) and the direction-word ones
(``fill_full_traced``, ``fill_pwm_full_traced``), pair mode local and
global and PWM mode, argmax tracking on and off, float32 and float64.
:func:`fill` (pair) and :func:`fill_pwm` (PWM) launch the kernel for CUDA
tensors and take the plain versions
(:func:`aligner_tpu_torch.ops.scan_engine.fill_batch`,
:func:`~aligner_tpu_torch.ops.scan_engine.fill_pwm_batch`) for CPU
tensors.
"""

from __future__ import annotations

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


launches = _Launches()

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


def _check(q, qlen, t, tlen, matrix) -> None:
    _check_tensors(q.device, (("q", q), ("qlen", qlen), ("t", t), ("tlen", tlen)),
                   matrix)
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
    _check_codes(matrix.shape[-1], ("q", q), ("t", t))


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
         with_dirs: bool = False) -> FillResult:
    """Batched exact fill of B (query, target) problems.

    ``q`` (B, C) and ``t`` (B, R) int32 codes, ``qlen``/``tlen`` (B,)
    int32, ``matrix`` (V, V) or (B, V, V) float32/float64, all contiguous
    on one device.  CUDA tensors launch the kernel; CPU tensors take the
    plain version.  Global mode always tracks the argmax.
    """
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be local|global, got {mode!r}")
    _check(q, qlen, t, tlen, matrix)
    if q.device.type == "cpu":
        return fill_batch(q, qlen, t, tlen, matrix, del_, ext, mode=mode,
                          track_argmax=track_argmax, with_dirs=with_dirs)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, qlen, t, tlen, matrix, del_, ext, mode, track_argmax,
                   with_dirs)


def fill_pwm(q, qlen, pwm, del_: float, ext: float, *, track_argmax: bool = True,
             with_dirs: bool = False) -> FillResult:
    """Batched exact local fill of B queries against a position-weight
    matrix: the plane is (qlen+1, W+1), rows are query positions and
    every PWM column is active.

    ``q`` (B, R) int32 codes in [0, 4) — contiguous, or the ``.T`` view of
    a contiguous (R, B) tensor (the kernel's own layout, read in place
    when R is a multiple of 8) —, ``qlen`` (B,) int32, ``pwm`` (4, W) or
    (B, 4, W) float32/float64, all on one device.  CUDA tensors launch the
    kernel; CPU tensors take the plain version.  The direction words are
    (B, R8/8, W) int32, problem-major.
    """
    _check_pwm(q, qlen, pwm)
    if q.device.type == "cpu":
        return fill_pwm_batch(q, qlen, pwm, del_, ext, track_argmax=track_argmax,
                              with_dirs=with_dirs)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(None, None, q, qlen, pwm, del_, ext, "pwm", track_argmax,
                   with_dirs)


def _launch(q, qlen, t, tlen, matrix, del_, ext, mode, track_argmax, with_dirs):
    """One kernel launch.  PWM mode: ``q``/``qlen`` are None, ``t`` holds
    the query codes (the rows) and ``tlen`` their lengths."""
    is_pwm = mode == "pwm"
    is_global = mode == "global"
    track = track_argmax or is_global
    dev = t.device
    B, R = t.shape
    C = matrix.shape[-1] if is_pwm else q.shape[1]
    R8 = round8(R)
    V = matrix.shape[-2]
    dtype = matrix.dtype
    lib = _build.load()
    with torch.cuda.device(dev):
        # (R8, B) and (C, B): a warp's 32 problems read 32 neighbouring words
        tT = t.T if R == R8 and t.T.is_contiguous() else None
        if tT is None:
            tT = torch.zeros((R8, B), dtype=torch.int32, device=dev)
            tT[:R] = t.T
        qT = None if is_pwm else q.T.contiguous()
        col = torch.empty((R8 + 1, B), dtype=dtype, device=dev)
        fmax = torch.empty(B, dtype=dtype, device=dev)
        fy = torch.empty(B, dtype=torch.int32, device=dev)
        fx = torch.empty(B, dtype=torch.int32, device=dev)
        end = torch.empty(B, dtype=dtype, device=dev)
        words = (torch.empty((B, R8 // 8, C), dtype=torch.int32, device=dev)
                 if with_dirs else None)
        if B == 0:
            return FillResult(fmax, fy, fx, end, words)
        err = lib.dp_fill_launch(
            None if is_pwm else qT.data_ptr(), tT.data_ptr(),
            None if is_pwm else qlen.data_ptr(), tlen.data_ptr(),
            matrix.data_ptr(), matrix[0].numel() if matrix.dim() == 3 else 0,
            V, B, C, R8, float(del_), float(ext),
            int(dtype == torch.float64), int(is_pwm), int(is_global), int(track),
            int(with_dirs), col.data_ptr(), fmax.data_ptr(), fy.data_ptr(),
            fx.data_ptr(), end.data_ptr(),
            words.data_ptr() if with_dirs else None,
            _build.threads_for(B, dev), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "dp_fill")
        if is_pwm:
            if with_dirs:
                launches.pwm_dirs += 1
            else:
                launches.pwm_scores += 1
        elif with_dirs:
            launches.dirs += 1
        else:
            launches.scores += 1
    return FillResult(fmax, fy, fx, end, words)


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
                track_argmax: bool = True, with_dirs: bool = False) -> FillResult:
        return fill(q, qlen, t, tlen, self.matrix, self.del_, self.ext,
                    mode=mode, track_argmax=track_argmax, with_dirs=with_dirs)


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
                with_dirs: bool = False) -> FillResult:
        return fill_pwm(q, qlen, self.pwm, self.del_, self.ext,
                        track_argmax=track_argmax, with_dirs=with_dirs)


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
