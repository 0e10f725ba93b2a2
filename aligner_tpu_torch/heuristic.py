"""Heuristic (matrix-free) aligners: pairwise, PWM and the population.

Counterpart of ``aligner_tpu/heuristic.py`` (itself the equivalent of
aligner-core/src/heuristic/mod.rs): derive a scoring matrix iteratively —
align locally with a transformed matrix, take the alignment's
substitution-frequency matrix, project it back onto the (kd, r²)
constraint surface, realign — until the local score stops strictly
improving.  The returned result is the first *non-improving* alignment
with the matrix that produced it attached.

* :func:`heuristic_align` (and :class:`HeuristicAligner`) is a host loop
  over :func:`~aligner_tpu_torch.align.align_local`, the transforms in
  numpy on the host, as in the JAX package.
* :func:`heuristic_align_population` runs the loop for a whole population
  of starting matrices, the job of a service worker.  On the card it is a
  host loop over device kernels with the population's state kept on the
  card: per iteration one batched fill with direction words
  (``ops/dp_fill.py``), one counting walk (``ops/device_walk.py:walk_counts``:
  the batched walk with the frequency count as its epilogue, one launch)
  and the batched float64 transform
  (:func:`~aligner_tpu_torch.matrices.transform_matrix_torch`), and one
  read of the ``done`` flags back to the host.  The TPU fused the loop into
  one dispatch only because of its per-dispatch round trip; the port keeps
  one loop, and ``device="cpu"`` runs it on the kernels' plain versions.
* :func:`heuristic_align_pwm` (and :class:`HeuristicPWMAligner`) is the
  query-vs-PWM loop the repeat search's testing mode runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .align import _encode, align_local, align_pwm, batch_align, pad_batch
from .alphabet import DNA, Alphabet, Protein
from .backend import resolve_device
from .errors import MissingArgument, ResultIsEmpty, ValidationError, WrongMatrixSpecified
from .matrices import transform_matrix, transform_matrix_torch
from .observability import span
from .result import AlignmentResult


@dataclasses.dataclass
class Heuristics:
    """Matrix-derivation parameters (lib.rs:21-25)."""

    kd: float
    r_squared: float
    frequencies: np.ndarray


def _r_squared(heuristics: Heuristics, rows: int, cols: int) -> float:
    """``r_squared == 0`` defaults to rows*cols of the seed matrix
    (heuristic/mod.rs:48-50; the PWM variant has no default)."""
    r_squared = heuristics.r_squared
    if abs(r_squared) < np.finfo(np.float64).eps:
        r_squared = float(rows * cols)
    return r_squared


def heuristic_align(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    heuristics: Heuristics | None,
    *,
    alphabet: type[Alphabet] = Protein,
    device=None,
    max_iters: int = 1000,
) -> AlignmentResult:
    """Pairwise heuristic local alignment (heuristic/mod.rs:36-78).

    ``r_squared == 0`` defaults to rows*cols of the seed matrix
    (heuristic/mod.rs:48-50).  ``max_iters`` is a safety bound absent in
    the reference (whose loop is unbounded); when it is spent while the
    score still improves, the result carries the matrix that produced it.
    """
    if heuristics is None:
        raise MissingArgument("heuristic aligner requires Heuristics")
    matrix = np.asarray(matrix, dtype=np.float64)
    r_squared = _r_squared(heuristics, *matrix.shape)
    transformed = transform_matrix(matrix, heuristics.kd, r_squared,
                                   heuristics.frequencies)
    if max_iters < 1:
        raise ValidationError("max_iters must be >= 1")
    max_f = 0.0
    for _ in range(max_iters):
        current = transformed  # the matrix THIS iteration aligns with
        result = align_local(query, target, current, del_, ext, alphabet=alphabet,
                             device=device)
        if result.alignment.f > max_f:
            max_f = result.alignment.f
            transformed = transform_matrix(
                result.alignment.frequency_matrix(),
                heuristics.kd, r_squared, heuristics.frequencies,
            )
        else:
            result.matrix = current
            return result
    # max_iters spent while still improving: the matrix that PRODUCED the
    # returned alignment, not the fresh transform
    result.matrix = current
    return result


@dataclasses.dataclass
class _Population:
    """The state of a population on its device: per member the matrix it
    aligns with next (``trans``), the one that produced its last accepted
    alignment (``prod``), its best score, and whether it is done or dead
    (no positive-scoring cell)."""

    trans: torch.Tensor
    prod: torch.Tensor
    max_f: torch.Tensor
    done: torch.Tensor
    dead: torch.Tensor


def _population_loop(q2, ql0, t2, tl0, state: _Population, del_, ext, kd, r_squared,
                     freqs, max_iters: int) -> int:
    """Run the population's iterations on ``q2``'s device until every
    member is done or ``max_iters`` are spent; returns the iterations run.
    A transform with no real roots leaves NaN in ``state.trans``."""
    from .ops import device_walk, dp_fill

    V = state.trans.shape[-1]
    S = t2.shape[1] + q2.shape[1] + 1

    def finished(it: int) -> bool:
        if it >= max_iters:
            return True
        with span("population.done_read"):  # the host waits for the card here
            return bool(state.done.all())

    it = 0
    stop = finished(it)
    while not stop:
        with span("population.iteration"):
            alive = ~state.done
            ql = torch.where(state.done, 0, ql0)
            tl = torch.where(state.done, 0, tl0)
            with span("population.fill"):
                r = dp_fill.fill(q2, ql, t2, tl, state.trans, del_, ext, mode="local",
                                 with_dirs=True)
            with span("population.counting_walk"):
                counts = device_walk.walk_counts(r.words, r.fy, r.fx, q2, t2, alive, V, S=S)
            with span("population.transform"):
                newt = transform_matrix_torch(counts.to(torch.float64), kd, r_squared, freqs)
            newly_dead = alive & ((r.fy == 0) | (r.fx == 0))
            improved = alive & ~newly_dead & (r.fmax > state.max_f)
            keep = improved[:, None, None]
            state.prod = torch.where(keep, state.trans, state.prod)
            state.trans = torch.where(keep, newt, state.trans)
            state.max_f = torch.where(improved, r.fmax, state.max_f)
            state.done = state.done | (alive & ~improved)
            state.dead = state.dead | newly_dead
            it += 1
            stop = finished(it)
    return it


def heuristic_align_population(
    query,
    target,
    matrices: np.ndarray,  # (M, V, V) candidate starting matrices
    del_: float,
    ext: float,
    heuristics: Heuristics | None,
    *,
    alphabet: type[Alphabet] = Protein,
    device=None,
    max_iters: int = 1000,
) -> list[AlignmentResult | None]:
    """Run the heuristic loop for a whole matrix population at once, each
    member by :func:`heuristic_align`'s iteration rule, bit for bit with
    the JAX package's host loop (``device_loop=False``).

    The starting matrices are transformed on the host (numpy, as the
    reference does: a matrix with no real roots raises
    :class:`WrongMatrixSpecified` there); then every iteration runs on
    ``device`` as one batched fill, one counting walk (the walk and the
    frequency count in one launch) and the float64 transform over the
    still-improving members, the converged ones masked
    to zero length.  A transform with no real roots inside the loop leaves
    NaN in the final matrices and raises :class:`WrongMatrixSpecified` after
    the loop, checked over every member before a member that spent
    ``max_iters`` takes the matrix that produced its last accepted
    alignment.  One with-alignments :func:`batch_align` on the final
    matrices then gives each member its alignment, with ``.matrix`` set.
    A query or target code outside the matrices' V symbols raises
    :class:`ValidationError` before any work.

    A member whose transformed matrix admits NO positive-scoring cell has
    no local alignment; its entry is ``None`` (the reference would panic
    the whole process on the 0-index traceback seed there,
    simple/mod.rs:213-218 — one dead candidate must not take down the
    other M-1).
    """
    if heuristics is None:
        raise MissingArgument("heuristic aligner requires Heuristics")
    with span("population", members=len(matrices)) as sp:
        with span("population.start"):
            matrices = np.asarray(matrices, dtype=np.float64)
            M = matrices.shape[0]
            r_squared = _r_squared(heuristics, matrices.shape[1], matrices.shape[2])
            transformed = np.stack([
                transform_matrix(matrices[m], heuristics.kd, r_squared,
                                 heuristics.frequencies)
                for m in range(M)
            ])
            if max_iters < 1:
                raise ValidationError("max_iters must be >= 1")
            device = resolve_device(device)
            q = _encode(query, alphabet)
            t = _encode(target, alphabet)
            if len(q) == 0 or len(t) == 0:
                raise ResultIsEmpty("empty sequence")
            # the loop's kernels index the matrices and the counts with the codes
            # unchecked: refuse codes outside them before any reaches the device
            V = matrices.shape[-1]
            for name, a in (("query", q), ("target", t)):
                if int(a.min()) < 0 or int(a.max()) >= V:
                    raise ValidationError(
                        f"{name} codes must lie in the {V}-symbol scoring alphabet")

            def on_dev(a, dtype=torch.int32):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

            # the padding of batch_align's final launch (multiples of 8)
            q2, ql0 = pad_batch([q] * M)
            t2, tl0 = pad_batch([t] * M)
            trans = on_dev(transformed, torch.float64)
            state = _Population(trans, trans,
                                torch.zeros(M, dtype=torch.float64, device=device),
                                torch.zeros(M, dtype=torch.bool, device=device),
                                torch.zeros(M, dtype=torch.bool, device=device))
            rows = (on_dev(q2), on_dev(ql0), on_dev(t2), on_dev(tl0))
            freqs = on_dev(heuristics.frequencies, torch.float64)
        iterations = _population_loop(*rows, state, del_, ext, heuristics.kd, r_squared,
                                      freqs, max_iters)
        sp.count(iterations=iterations)
        with span("population.final"):
            final = state.trans.cpu().numpy()
            if np.isnan(final).any():
                raise WrongMatrixSpecified("no real roots for the scaling quadratic")
            done = state.done.cpu().numpy()
            dead = state.dead.cpu().numpy()
            exhausted = ~done & ~dead
            if exhausted.any():
                final = np.where(exhausted[:, None, None], state.prod.cpu().numpy(), final)
            batch = batch_align([q] * M, [t] * M, final, del_, ext, mode="local",
                                alphabet=alphabet, device=device, with_alignments=True,
                                skip=dead)
        for m, res in enumerate(batch):
            if res is not None:
                res.matrix = final[m].copy()
        return batch


def warmup_population(
    query,
    target,
    n_matrices: int,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    device=None,
) -> None:
    """Get the population's kernels ready for these shapes WITHOUT doing
    any work (the worker's ``--warmup`` path): on the card, build (or load)
    the kernel library, then run the final with-alignments launch with
    every problem skipped (zero-length — free)."""
    from .ops import _build

    device = resolve_device(device)
    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    M, V = int(n_matrices), alphabet.volume()
    if len(q) == 0 or len(t) == 0 or M == 0:
        return
    if device.type == "cuda":
        _build.load()
    batch_align([q] * M, [t] * M, np.zeros((M, V, V)), del_, ext, mode="local",
                alphabet=alphabet, device=device, with_alignments=True,
                skip=np.ones(M, bool))


def heuristic_align_pwm(
    query,
    pwm,
    del_: float,
    ext: float,
    heuristics: Heuristics | None,
    *,
    alphabet: type[Alphabet] = DNA,
    device=None,
    max_iters: int = 1000,
) -> AlignmentResult:
    """Query-vs-PWM heuristic alignment (heuristic/mod.rs:103-141).

    The PWM variant does *not* apply the r_squared == 0 default of the
    pairwise one.  ``max_iters`` is a safety bound absent in the
    reference (whose loop is unbounded).
    """
    if heuristics is None:
        raise MissingArgument("heuristic aligner requires Heuristics")
    pwm = np.asarray(pwm, dtype=np.float64)
    transformed = transform_matrix(
        pwm, heuristics.kd, heuristics.r_squared, heuristics.frequencies
    )
    if max_iters < 1:
        raise ValidationError("max_iters must be >= 1")
    max_f = 0.0
    for _ in range(max_iters):
        current = transformed
        result = align_pwm(query, current, del_, ext, alphabet=alphabet, device=device)
        if result.alignment.f > max_f:
            max_f = result.alignment.f
            transformed = transform_matrix(
                result.alignment.frequency_matrix(),
                heuristics.kd, heuristics.r_squared, heuristics.frequencies,
            )
        else:
            result.matrix = current
            return result
    result.matrix = current
    return result


class HeuristicAligner:
    """Equivalent of aligner-core HeuristicAligner (heuristic/mod.rs:10-79)."""

    def __init__(self, query, target, alphabet=Protein):
        self.query = query
        self.target = target
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, target: str, alphabet=Protein):
        return cls(alphabet.encode(query, strict=True),
                   alphabet.encode(target, strict=True), alphabet)

    @classmethod
    def from_seqs(cls, query, target, alphabet=Protein):
        return cls(np.asarray(query, np.int8), np.asarray(target, np.int8), alphabet)

    def perform_alignment(self, del_, ext, matrix, heuristics=None, **kw):
        return heuristic_align(
            self.query, self.target, matrix, del_, ext, heuristics,
            alphabet=self.alphabet, **kw,
        )


class HeuristicPWMAligner:
    """Equivalent of aligner-core HeuristicPWMAligner (heuristic/mod.rs:81-142)."""

    def __init__(self, query, alphabet=DNA):
        self.query = query
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, alphabet=DNA):
        return cls(alphabet.encode(query), alphabet)

    @classmethod
    def from_seqs(cls, query, alphabet=DNA):
        return cls(np.asarray(query, np.int8), alphabet)

    def perform_alignment(self, del_, ext, pwm, heuristics=None, **kw):
        return heuristic_align_pwm(
            self.query, pwm, del_, ext, heuristics, alphabet=self.alphabet, **kw
        )
