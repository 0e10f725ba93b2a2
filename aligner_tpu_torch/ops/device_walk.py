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

import numpy as np
import torch

from . import _build

TOP, LEFT, DIAG, BEG = 0, 1, 2, 3
BLANK = np.int16(98)


class _Launches:
    """Launch count of :func:`walk`'s kernel (a plain integer, bumped only
    where the kernel is launched)."""

    def __init__(self):
        self.walk = 0

    def reset(self) -> None:
        self.walk = 0


launches = _Launches()


def walk(words, sy, sx, *, S: int, mode: str):
    """Walk B packed planes for ``S`` steps.

    ``words``: (B, R8/8, C) int32 problem-major packed directions (word
    (r >> 3)·C + c holds row r at bit 2·(r & 7)); ``sy``/``sx``: (B,)
    int32 start cells.  Global borders are synthesised as Left/Top, local
    borders are Beginning.  Returns (steps (ceil(S/16), B) int32 — 16
    two-bit codes per word, Beginning-padded —, n, end_y, end_x).  CUDA
    tensors launch the kernel; CPU tensors take :func:`walk_plain`.
    """
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be local|global, got {mode!r}")
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
    B, _, C = words.shape
    if tuple(sy.shape) != (B,) or tuple(sx.shape) != (B,):
        raise ValueError("sy and sx must be (B,)")
    if S < 1:
        raise ValueError("S must be positive")
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
        err = lib.device_walk_launch(
            words.data_ptr(), words.shape[1] * C, sy.data_ptr(), sx.data_ptr(),
            B, C, S, int(mode == "global"), steps.data_ptr(), n.data_ptr(),
            ey.data_ptr(), ex.data_ptr(), _build.threads_for(B, dev),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "device_walk")
        launches.walk += 1
    return steps, n, ey, ex


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


def _unpack_steps(packed: np.ndarray, S: int) -> np.ndarray:
    """(ceil(S/16), B) int32 → (S, B) uint8 step codes."""
    k = np.arange(16, dtype=np.int32) * 2
    d = (packed[:, None, :] >> k[None, :, None]) & 3
    return d.reshape(-1, packed.shape[1])[:S].astype(np.uint8)


def walk_batch(words, mode: str, sy, sx, R: int, C: int):
    """Run the walk over B packed planes and return host-side
    (steps (S, B) uint8, lens, end_y, end_x).

    ``words``: the fill's (B, R8/8, C) int32 output on its device;
    ``R``/``C``: the interior plane dims (padded batch shapes), S = R+C+1.
    """
    S = R + C + 1
    dev = words.device
    packed, n, ey, ex = walk(
        words, torch.as_tensor(np.array(sy, np.int32), device=dev),
        torch.as_tensor(np.array(sx, np.int32), device=dev), S=S, mode=mode,
    )
    return (
        _unpack_steps(packed.cpu().numpy(), S),
        n.cpu().numpy(),
        ey.cpu().numpy(),
        ex.cpu().numpy(),
    )


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
    rows of a PWM plane are the query, its columns the PWM positions."""
    steps = _walked(steps, lens)
    y_at, x_at = _cursor_replay_all(steps, sy, sx)
    qi = np.clip(y_at - 1, 0, q.shape[1] - 1)
    qa_all = np.where(
        steps == LEFT, BLANK, np.take_along_axis(q.T, qi, axis=0)
    ).astype(np.int16)
    num_all = np.where(steps == TOP, 0, x_at).astype(np.int32)
    return (
        [qa_all[: lens[b], b][::-1] for b in range(steps.shape[1])],
        [num_all[: lens[b], b][::-1] for b in range(steps.shape[1])],
    )
