"""The heuristic population's frequency count on the device
(``csrc/freq_count.cu``) and its plain version.

Counterpart of the step unpack and frequency scatter-add inside the JAX
package's fused population loop (``aligner_tpu/heuristic.py:207-242``,
jnp there, not Pallas): from each member's packed step stream (the batched
walk's output, ``ops/device_walk.py:walk``) it counts the (target char,
query char) pairs of its alignment into a (V, V) matrix.  A pair is counted
on each DIAG step, at the cursor before the step (``t[y - 1]``,
``q[x - 1]``; TOP and LEFT steps put a blank on one side and are not
counted, alignment.rs:13-23), plus the seeded argmax pair ``t[sy - 1]``,
``q[sx - 1]`` of a member that is alive and has ``sy > 0`` and ``sx > 0``.
So a member's counts equal ``Alignment.frequency_matrix()`` of its
alignment, as integers.

The population counts with the counting walk
(:func:`~aligner_tpu_torch.ops.device_walk.walk_counts`), which runs this
kernel's body (``csrc/count_core.cuh``) as the walk's epilogue, one launch
for both; :func:`count_pairs` stays as its earlier build, and
:func:`count_pairs_plain` is the plain version of both.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .device_walk import BEG, DIAG, LEFT, TOP, pack_codes


class _Launches:
    """Launch count of :func:`count_pairs`'s kernel (a plain integer, bumped
    only where the kernel is launched)."""

    def __init__(self):
        self.freq_count = 0

    def reset(self) -> None:
        self.freq_count = 0


launches = _Launches()


def check_codes(dev, M: int, q, t, alive, V: int) -> None:
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


def _check(steps, n, sy, sx, q, t, alive, V) -> None:
    dev = steps.device
    for name, a in (("steps", steps), ("n", n), ("sy", sy), ("sx", sx)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, steps on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be {torch.int32}, got {a.dtype}")
    if steps.dim() != 2:
        raise ValueError(f"steps must be (ceil(S/16), M), got {tuple(steps.shape)}")
    M = steps.shape[1]
    for name, a in (("n", n), ("sy", sy), ("sx", sx)):
        if tuple(a.shape) != (M,):
            raise ValueError(f"{name} must be ({M},), got {tuple(a.shape)}")
    check_codes(dev, M, q, t, alive, V)


def count_pairs(steps, n, sy, sx, q, t, alive, V: int):
    """(M, V, V) int32 counts of (target char, query char) pairs of M
    walks.

    ``steps``: (ceil(S/16), M) int32 packed step streams, 16 two-bit codes
    a word, step-major; ``n`` (M,) int32 steps each walk took; ``sy``/``sx``
    (M,) int32 its start cell; ``q`` (M, C) and ``t`` (M, R) int32 padded
    codes in [0, V) (not checked: the kernel indexes the counts with them);
    ``alive`` (M,) bool, the members whose seed pair counts.  A cursor is
    clipped to the codes, as in the JAX package.  CUDA tensors launch the
    kernel; CPU tensors take :func:`count_pairs_plain`.
    """
    _check(steps, n, sy, sx, q, t, alive, V)
    dev = steps.device
    if dev.type == "cpu":
        return count_pairs_plain(steps, n, sy, sx, q, t, alive, V)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M = steps.shape[1]
    lib = _build.load()
    with torch.cuda.device(dev):
        out = torch.empty((M, V, V), dtype=torch.int32, device=dev)
        if M == 0:
            return out
        err = lib.freq_count_launch(
            steps.data_ptr(), steps.shape[0], n.data_ptr(), sy.data_ptr(), sx.data_ptr(),
            q.data_ptr(), q.shape[1], t.data_ptr(), t.shape[1], alive.data_ptr(), M, V,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        if err == -1:
            raise ValueError(f"the counts of {V} symbols do not fit a block's shared memory")
        _build.check(lib, err, "freq_count")
        launches.freq_count += 1
    return out


def count_pairs_plain(steps, n, sy, sx, q, t, alive, V: int):
    """Plain PyTorch version of the count kernel: every step of every walk
    unpacked at once, the cursors by a cumulative sum, the DIAG pairs
    counted by one ``bincount`` (the JAX package's scatter-add)."""
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


def ragged_streams(rng, M: int, R: int, C: int, V: int, *, kind: str = "random",
                   done_frac: float = 0.0, stale_frac: float = 0.0):
    """Step streams of M members on random (M, C) and (M, R) codes in
    [0, V), as CPU tensors in :func:`count_pairs`'s argument order (without
    V), to hold the kernel against the plain version.  ``kind`` "random":
    n codes of TOP, LEFT and DIAG (n up to S = R + C + 1) from a random
    start cell, so most walks leave the plane and are clipped; "full": the
    same with n = S; "in-plane": from (R, C), min(R, C) / 4 DIAG codes and
    as many TOP and LEFT codes as leave 20 rows and columns in a random
    order, so a walk stays on the plane (at 344 x 344 past its first round
    of 32 words).  Beginning after n.  A share ``done_frac`` of the members
    done (n = 0 from (0, 0), not alive), as the population masks them, and
    a share ``stale_frac`` not alive yet with a stream and a start (only
    their seed pair is left out)."""
    S = R + C + 1
    if kind == "in-plane":
        diag = min(R, C) // 4
        path = [DIAG] * diag + [TOP] * (R - diag - 20) + [LEFT] * (C - diag - 20)
        n = np.full(M, len(path))
        codes = np.full((S, M), BEG)
        for m in range(M):
            codes[: n[m], m] = rng.permutation(path)
        sy, sx = np.full(M, R), np.full(M, C)
    else:
        codes = rng.choice([DIAG, TOP, LEFT], size=(S, M), p=[0.7, 0.15, 0.15])
        n = np.full(M, S) if kind == "full" else rng.integers(0, S + 1, M)
        sy = rng.integers(0, R + 1, M)
        sx = rng.integers(0, C + 1, M)
    done = rng.random(M) < done_frac
    n[done] = 0
    sy[done] = 0
    sx[done] = 0
    alive = ~done & ~(rng.random(M) < stale_frac)
    S16 = -(-S // 16) * 16
    padded = np.full((S16, M), BEG)
    padded[:S] = np.where(np.arange(S)[:, None] < n[None, :], codes, BEG)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)

    return (pack_codes(padded, 16), i32(n), i32(sy), i32(sx),
            i32(rng.integers(0, V, (M, C))), i32(rng.integers(0, V, (M, R))),
            torch.as_tensor(alive))
