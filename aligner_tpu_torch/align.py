"""Batched alignment: the port's main path.

:func:`batch_align` → :func:`_fill` → one fill kernel over B independent
(query, target) problems (``ops/dp_fill.py``) → with alignments, one
batched walk over the packed direction words (``ops/device_walk.py``) →
host decode.  The PWM path is the same in PWM mode:
:func:`batch_align_pwm` → :func:`_fill_pwm` → the kernel's PWM
specialisation → the walk in local mode → :func:`decode_pwm_batch`.
Counterparts of ``aligner_tpu.align.batch_align``/``batch_align_pwm``/
``align_pwm`` and bit-identical to them.

``device=None`` picks ``cuda`` when a card is present (the kernels) and
the CPU otherwise (their plain PyTorch versions).  The dtype follows the
data (:func:`aligner_tpu_torch.backend.dtype_for`): float32 on CUDA only
for integer-valued scoring, float64 otherwise and on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .alphabet import DNA, Alphabet, Protein
from .backend import dtype_for, resolve_device
from .errors import MatrixShapeError, ResultIsEmpty, UnnecessaryArgument, ValidationError
from .result import Alignment, AlignmentResult, PWMAlignment

# below this many cells a single PWM problem runs on the host engine when
# the caller names no device (aligner_tpu.backend.SMALL_PROBLEM_CELLS_NATIVE)
SMALL_PROBLEM_CELLS_NATIVE = 768 * 768


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


def _fill(q, ql, t, tl, matrix, del_, ext, mode, with_dirs, device, dtype,
          track_argmax=True):
    """One batched fill on ``device``; returns the FillResult with its
    tensors (and packed words when ``with_dirs``) left on the device."""
    from .observability import measure
    from .ops.dp_fill import DPFill

    cells = int((np.asarray(ql, np.int64) * np.asarray(tl, np.int64)).sum())
    vol = np.asarray(matrix).shape[-1]
    for name, a in (("query", q), ("target", t)):
        if a.size and (int(a.min()) < 0 or int(a.max()) >= vol):
            raise ValidationError(
                f"{name} codes must lie in the {vol}-symbol scoring alphabet"
            )
    dp = DPFill.from_numpy(matrix, del_, ext, device=device, dtype=dtype)

    def dev_i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    with measure(f"{device.type}/{mode}", cells, len(ql), device=device):
        res = dp(dev_i32(q), dev_i32(ql), dev_i32(t), dev_i32(tl), mode=mode,
                 track_argmax=track_argmax, with_dirs=with_dirs)
    return res


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
    """
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

    if mode not in ("local", "global"):
        raise ValidationError(f"mode must be local|global, got {mode!r}")
    qs = [_encode(s, alphabet) for s in queries]
    ts = [_encode(s, alphabet) for s in targets]
    if len(qs) != len(ts):
        raise ValidationError("queries and targets must have the same length")
    n_real = len(qs)
    q, ql = pad_batch(qs)
    t, tl = pad_batch(ts)
    if skip is not None:
        ql = np.where(np.asarray(skip, bool), 0, ql).astype(np.int32)
        tl = np.where(np.asarray(skip, bool), 0, tl).astype(np.int32)
    if pad_to is not None:
        if len(qs) > pad_to:
            raise ValidationError(
                f"pad_to={pad_to} is smaller than the batch ({len(qs)})"
            )
        extra = pad_to - len(qs)
        q = np.pad(q, ((0, extra), (0, 0)))
        t = np.pad(t, ((0, extra), (0, 0)))
        ql = np.pad(ql, (0, extra))
        tl = np.pad(tl, (0, extra))
        if matrix is not None and np.asarray(matrix).ndim == 3:
            matrix = np.pad(
                np.asarray(matrix), ((0, extra), (0, 0), (0, 0))
            )
    device = resolve_device(device)
    dtype = dtype or dtype_for(device, matrix, del_, ext)
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


def _fill_pwm(q, ql, pwm, del_, ext, with_dirs, device, dtype, track_argmax=True):
    """One batched PWM fill on ``device``; returns the FillResult with its
    tensors (and packed words when ``with_dirs``) left on the device."""
    from .observability import measure
    from .ops.dp_fill import PWMFill

    width = np.asarray(pwm).shape[-1]
    cells = int(np.asarray(ql, np.int64).sum()) * int(width)
    if q.size and (int(q.min()) < 0 or int(q.max()) >= 4):
        raise ValidationError("query codes must lie in the 4-symbol DNA alphabet")
    dp = PWMFill.from_numpy(pwm, del_, ext, device=device, dtype=dtype)

    def dev_i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    with measure(f"{device.type}/pwm", cells, len(ql), device=device):
        res = dp(dev_i32(q), dev_i32(ql), track_argmax=track_argmax,
                 with_dirs=with_dirs)
    return res


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
):
    """Batched query-vs-PWM alignment (one PWM shared or (B, 4, W) batched).

    The window-scan primitive of the latent-repeat search: all windows
    become one launch.  ``track_argmax=False`` (scores-only mode only)
    skips the per-cell argmax bookkeeping when the caller consumes just
    ``fmax``; fy/fx/end then come back zero.

    ``pad_to``/``skip`` as in :func:`batch_align`: padding problems are
    zero-length and not returned; skipped real problems return ``None``
    (score 0 in scores-only mode).
    """
    pwm = np.asarray(pwm)
    if pwm.ndim not in (2, 3) or pwm.shape[-2] != 4:
        raise MatrixShapeError(f"PWM must have 4 rows, got shape {pwm.shape}")
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
    dtype = dtype or dtype_for(device, pwm, del_, ext)
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


def align_pwm(
    query,
    pwm: np.ndarray,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = DNA,
    device=None,
    dtype: torch.dtype | None = None,
) -> AlignmentResult:
    """Query-vs-PWM local alignment (pwm/mod.rs:29-126).

    ``device=None`` runs a problem of at most 768² cells on the host
    engine (native C++), as ``aligner_tpu.backend.pick_backend`` does, and
    a larger one on the default device.  An empty query is not an error:
    the reference's PWM traceback walks from the all-zero plane's (0, 0)
    argmax and returns an empty ``PWMAlignment`` with coords
    ((1, 1), (1, 1)) and f = 0, on every route.
    """
    from . import host, native

    pwm = np.asarray(pwm)
    if pwm.ndim != 2 or pwm.shape[0] != 4:
        raise MatrixShapeError(f"PWM must have 4 rows, got shape {pwm.shape}")
    q = _encode(query, alphabet)
    if device is None and native.available() \
            and len(q) * pwm.shape[1] <= SMALL_PROBLEM_CELLS_NATIVE:
        r = host.align_pwm(q, pwm, del_, ext)
        return AlignmentResult(PWMAlignment(
            r.target_aligned.astype(np.int32), r.query_aligned, pwm.shape[1],
            r.coords, r.f, alphabet,
        ))
    (res,) = batch_align_pwm([q], pwm, del_, ext, alphabet=alphabet, device=device,
                             dtype=dtype, with_alignments=True)
    return res


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
