"""Substitution matrices, random PWMs and the heuristic matrix transform.

* ``blosum62()`` reproduces the matrix embedded in the reference
  (aligner-core/src/lib.rs:61-90).  Note the reference quirk: the embedded
  data is the standard NCBI 24-column BLOSUM62 in order
  ``A R N D C Q E G H I L K M F P S T W Y V B Z X *`` while the alphabet
  labels positions 21..23 as ``J Z X`` — i.e. symbol ``J`` scores as
  standard ``Z``, ``Z`` as ``X`` and ``X`` as ``*``.  We replicate the data
  bit-for-bit (it is required for output parity on the protein examples).
* ``blosum50()`` vendors standard NCBI BLOSUM50 with the same column
  relabeling, for the legacy golden tests (src/tests/test_alignment.rs)
  whose matrix lived in a module missing from the reference tree.
* ``transform_matrix()`` is the heuristic's core projection
  (aligner-helpers/src/matrices/mod.rs:19-68): rescale+shift a matrix onto
  the constraint surface ``sum(p ∘ M') = k_d`` and ``‖M'‖² = r²`` where
  ``p = freqs ⊗ uniform``.  ``transform_matrix_torch()`` is the same
  projection batched over a population's members on their device, in
  float64, bit for bit with it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .errors import WrongMatrixSpecified

_BLOSUM62 = """\
4 -1 -2 -2 0 -1 -1 0 -2 -1 -1 -1 -1 -2 -1 1 0 -3 -2 0 -2 -1 0 -4
-1 5 0 -2 -3 1 0 -2 0 -3 -2 2 -1 -3 -2 -1 -1 -3 -2 -3 -1 0 -1 -4
-2 0 6 1 -3 0 0 0 1 -3 -3 0 -2 -3 -2 1 0 -4 -2 -3 3 0 -1 -4
-2 -2 1 6 -3 0 2 -1 -1 -3 -4 -1 -3 -3 -1 0 -1 -4 -3 -3 4 1 -1 -4
0 -3 -3 -3 9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1 1 0 0 -3 5 2 -2 0 -3 -2 1 0 -3 -1 0 -1 -2 -1 -2 0 3 -1 -4
-1 0 0 2 -4 2 5 -2 0 -3 -3 1 -2 -3 -1 0 -1 -3 -2 -2 1 4 -1 -4
0 -2 0 -1 -3 -2 -2 6 -2 -4 -4 -2 -3 -3 -2 0 -2 -2 -3 -3 -1 -2 -1 -4
-2 0 1 -1 -3 0 0 -2 8 -3 -3 -1 -2 -1 -2 -1 -2 -2 2 -3 0 0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3 4 2 -3 1 0 -3 -2 -1 -3 -1 3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3 2 4 -2 2 0 -3 -2 -1 -2 -1 1 -4 -3 -1 -4
-1 2 0 -1 -3 1 1 -2 -1 -3 -2 5 -1 -3 -1 0 -1 -3 -2 -2 0 1 -1 -4
-1 -1 -2 -3 -1 0 -2 -3 -2 1 2 -1 5 0 -2 -1 -1 -1 -1 1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1 0 0 -3 0 6 -4 -2 -2 1 3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4 7 -1 -1 -4 -3 -2 -2 -1 -2 -4
1 -1 1 0 -1 0 0 0 -1 -2 -2 0 -1 -2 -1 4 1 -3 -2 -2 0 0 0 -4
0 -1 0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1 1 5 -2 -2 0 -1 -1 0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1 1 -4 -3 -2 11 2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3 2 -1 -1 -2 -1 3 -3 -2 -2 2 7 -1 -3 -2 -1 -4
0 -3 -3 -3 -1 -2 -2 -3 -3 3 1 -2 1 -1 -2 -2 0 -3 -1 4 -3 -2 -1 -4
-2 -1 3 4 -3 0 1 -1 0 -3 -4 0 -3 -3 -2 0 -1 -4 -3 -3 4 1 -1 -4
-1 0 0 1 -3 3 4 -2 0 -3 -3 1 -1 -3 -1 0 -1 -3 -2 -2 1 4 -1 -4
0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2 0 0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 1"""

_BLOSUM50 = """\
5 -2 -1 -2 -1 -1 -1 0 -2 -1 -2 -1 -1 -3 -1 1 0 -3 -2 0 -2 -1 -1 -5
-2 7 -1 -2 -4 1 0 -3 0 -4 -3 3 -2 -3 -3 -1 -1 -3 -1 -3 -1 0 -1 -5
-1 -1 7 2 -2 0 0 0 1 -3 -4 0 -2 -4 -2 1 0 -4 -2 -3 4 0 -1 -5
-2 -2 2 8 -4 0 2 -1 -1 -4 -4 -1 -4 -5 -1 0 -1 -5 -3 -4 5 1 -1 -5
-1 -4 -2 -4 13 -3 -3 -3 -3 -2 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1 -3 -3 -2 -5
-1 1 0 0 -3 7 2 -2 1 -3 -2 2 0 -4 -1 0 -1 -1 -1 -3 0 4 -1 -5
-1 0 0 2 -3 2 6 -3 0 -4 -3 1 -2 -3 -1 -1 -1 -3 -2 -3 1 5 -1 -5
0 -3 0 -1 -3 -2 -3 8 -2 -4 -4 -2 -3 -4 -2 0 -2 -3 -3 -4 -1 -2 -2 -5
-2 0 1 -1 -3 1 0 -2 10 -4 -3 0 -1 -1 -2 -1 -2 -3 2 -4 0 0 -1 -5
-1 -4 -3 -4 -2 -3 -4 -4 -4 5 2 -3 2 0 -3 -3 -1 -3 -1 4 -4 -3 -1 -5
-2 -3 -4 -4 -2 -2 -3 -4 -3 2 5 -3 3 1 -4 -3 -1 -2 -1 1 -4 -3 -1 -5
-1 3 0 -1 -3 2 1 -2 0 -3 -3 6 -2 -4 -1 0 -1 -3 -2 -3 0 1 -1 -5
-1 -2 -2 -4 -2 0 -2 -3 -1 2 3 -2 7 0 -3 -2 -1 -1 0 1 -3 -1 -1 -5
-3 -3 -4 -5 -2 -4 -3 -4 -1 0 1 -4 0 8 -4 -3 -2 1 4 -1 -4 -4 -2 -5
-1 -3 -2 -1 -4 -1 -1 -2 -2 -3 -4 -1 -3 -4 10 -1 -1 -4 -3 -3 -2 -1 -2 -5
1 -1 1 0 -1 0 -1 0 -1 -3 -3 0 -2 -3 -1 5 2 -4 -2 -2 0 0 -1 -5
0 -1 0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1 2 5 -3 -2 0 0 -1 0 -5
-3 -3 -4 -5 -5 -1 -3 -3 -3 -3 -2 -3 -1 1 -4 -4 -3 15 2 -3 -5 -2 -3 -5
-2 -1 -2 -3 -3 -1 -2 -3 2 -1 -1 -2 0 4 -3 -2 -2 2 8 -1 -3 -2 -1 -5
0 -3 -3 -4 -1 -3 -3 -4 -4 4 1 -3 1 -1 -3 -2 0 -3 -1 5 -4 -3 -1 -5
-2 -1 4 5 -3 0 1 -1 0 -4 -4 0 -3 -4 -2 0 0 -5 -3 -4 5 2 -1 -5
-1 0 0 1 -3 4 5 -2 0 -3 -3 1 -1 -4 -1 0 -1 -2 -2 -3 2 5 -1 -5
-1 -1 -1 -1 -2 -1 -1 -2 -1 -1 -1 -1 -1 -2 -2 -1 0 -3 -1 -1 -1 -1 -1 -5
-5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 1"""


def _parse(text: str) -> np.ndarray:
    return np.array(
        [[float(v) for v in line.split()] for line in text.splitlines()],
        dtype=np.float64,
    )


@functools.cache
def blosum62() -> np.ndarray:
    """24x24 BLOSUM62 as embedded in the reference (lib.rs:61-90)."""
    m = _parse(_BLOSUM62)
    m.setflags(write=False)
    return m


@functools.cache
def blosum50() -> np.ndarray:
    """24x24 standard BLOSUM50, for the legacy golden tests."""
    m = _parse(_BLOSUM50)
    m.setflags(write=False)
    return m


def random_pwm(length: int, rng: np.random.Generator) -> np.ndarray:
    """(4, length) PWM with uniform entries in {-1, 0, 1} (lib.rs:92-96).

    Unlike the reference (unseeded thread_rng), the generator is explicit so
    runs are reproducible.
    """
    return rng.integers(-1, 2, size=(4, length)).astype(np.float64)


def get_threshold(dim: int) -> float:
    """Minimum pairwise L2 distance for matrix populations
    (aligner-helpers/src/matrices/mod.rs:8-17)."""
    return {20: 22.6, 21: 23.1, 22: 23.6, 23: 24.1, 24: 24.6}.get(dim, 0.0)


def transform_matrix(
    matrix: np.ndarray,
    k_d: float,
    r_squared: float,
    frequencies: np.ndarray,
) -> np.ndarray:
    """Project ``matrix`` onto the constraint surface.

    Returns ``M' = p·b + x·(M + p·(a−b))`` where ``x`` solves the quadratic
    fixing ``‖M'‖² = r²``, and ``p = frequencies ⊗ uniform(1/cols)``; by
    construction ``Σ p∘M' = k_d``.  Root selection follows
    matrices/mod.rs:44-65: the positive root if the two roots straddle zero,
    otherwise whichever root's result is L2-closest to ``M``.

    Raises :class:`WrongMatrixSpecified` when the quadratic has no real
    roots.
    """
    matrix = np.asarray(matrix, dtype=np.float64)
    frequencies = np.asarray(frequencies, dtype=np.float64)
    rows, cols = matrix.shape
    if frequencies.shape != (rows,):
        raise WrongMatrixSpecified(
            f"frequencies shape {frequencies.shape} != ({rows},)"
        )

    f = np.full(cols, 1.0 / cols)
    p = np.outer(frequencies, f)

    p_squared = float((p * p).sum())
    k_0 = float((p * matrix).sum())

    a = (k_d - k_0) / p_squared
    b = k_d / p_squared
    base = matrix + p * (a - b)

    denominator = float((base * base).sum())
    a_coeff = 2.0 * b * float((p * base).sum()) / denominator
    b_coeff = (b * b * p_squared - r_squared) / denominator

    disc = a_coeff * a_coeff - 4.0 * b_coeff
    if disc < 0.0:
        raise WrongMatrixSpecified("no real roots for the scaling quadratic")
    if disc == 0.0:
        root = -a_coeff / 2.0
        return p * b + root * base

    sq = math.sqrt(disc)
    r0 = (-a_coeff - sq) / 2.0
    r1 = (-a_coeff + sq) / 2.0
    if r0 < 0.0 < r1:
        return p * b + r1 * base
    m0 = p * b + r0 * base
    m1 = p * b + r1 * base
    d0 = float(np.linalg.norm(matrix - m0))
    d1 = float(np.linalg.norm(matrix - m1))
    return m0 if d0 < d1 else m1


def _leaf_sums(x, length: int):
    """numpy's sum of each block of ``length`` entries on the last axis of
    ``x`` (..., k, length), rounded as numpy rounds it, by elementwise adds."""
    if length < 8:
        s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(length):
            s = s + x[..., i]
        return s
    r = x[..., :8]
    i = 8
    while i < length - length % 8:
        r = r + x[..., i:i + 8]
        i += 8
    s = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
        (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for j in range(i, length):
        s = s + x[..., j]
    return s


@functools.lru_cache(maxsize=None)
def _pairwise_gathers(n: int, device: torch.device):
    """numpy's pairwise summation of ``n`` entries (``pairwise_sum_DOUBLE``:
    sequential below 8 entries, 8 accumulators up to 128, halving above
    with the split rounded down to a multiple of 8) as a tree, a leaf
    ``(start, length)`` and a node a pair of subtrees; and for each leaf
    length the leaves' starts and their (k, length) gather index on
    ``device`` (made once, so a sum on the card copies nothing from the
    host)."""

    def split(start, length):
        if length <= 128:
            return (start, length)
        half = length // 2
        half -= half % 8
        return (split(start, half), split(start + half, length - half))

    tree = split(0, n)
    leaves = []

    def collect(node):
        if isinstance(node[0], tuple):
            collect(node[0])
            collect(node[1])
        else:
            leaves.append(node)

    collect(tree)
    gathers = []
    for length in sorted({m for _, m in leaves}):
        starts = [s for s, m in leaves if m == length]
        idx = torch.tensor(starts)[:, None] + torch.arange(length)[None, :]
        gathers.append((length, starts, idx.to(device)))
    return tree, gathers


def pairwise_sum(x):
    """The sum over the last axis of ``x`` in numpy's pairwise order, so
    that it equals ``np.sum`` of the same entries bit for bit (elementwise
    adds round alike in numpy and in torch, on the CPU and on the card).
    The leaves of one length are summed together, then the tree's nodes."""
    tree, gathers = _pairwise_gathers(x.shape[-1], x.device)
    sums = {}
    for length, starts, idx in gathers:
        for s, v in zip(starts, _leaf_sums(x[..., idx], length).unbind(-1)):
            sums[s] = v

    def total(node):
        if isinstance(node[0], tuple):
            return total(node[0]) + total(node[1])
        return sums[node[0]]

    return total(tree)


def _sqrt(x):
    """Correctly rounded square root, as numpy's and the card's: PyTorch's
    CPU ``sqrt`` for float64 is off by an ULP on some inputs, so on the CPU
    numpy takes it (NaN below zero, without a warning)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.numpy()))


def transform_matrix_torch(matrices, k_d: float, r_squared: float, frequencies):
    """:func:`transform_matrix` of each member of ``matrices``, (M, V, V)
    float64, on the tensor's device: (M, V, V) float64 out.

    The counterpart of ``aligner_tpu.matrices.transform_matrix_jax`` (vmapped
    over a population), held bit for bit to the host reference
    :func:`transform_matrix` rather than to the float32 TPU version: every
    sum follows numpy's pairwise order over the flattened V·V entries
    (:func:`pairwise_sum`), the elementwise ``+ − × ÷`` round alike in
    numpy and in torch, on the CPU and on the card, and so does ``sqrt``
    on the card (on the CPU :func:`_sqrt` takes numpy's).  A
    negative discriminant gives NaN for that member instead of raising
    :class:`WrongMatrixSpecified`; the caller surfaces it.  So does a
    matrix whose shifted ``base`` is all zero, where numpy's divides a
    Python float by zero and raises ``ZeroDivisionError``; the frequency
    count of a live member, which holds its seed pair, is never one.

    Its one gap: the choice between two roots of one sign takes the
    candidate nearer to the matrix by ``sqrt`` of a pairwise sum of
    squares, where ``np.linalg.norm`` sums by BLAS ``ddot`` in an order
    that cannot be reproduced.  So the two can pick differently only where
    both candidates lie within a few ULPs of one distance.
    """
    m = matrices
    if m.dim() != 3 or m.dtype != torch.float64:
        raise ValueError(f"matrices must be (M, V, V) float64, got {tuple(m.shape)} "
                         f"{m.dtype}")
    M, rows, cols = m.shape
    freqs = torch.as_tensor(frequencies, dtype=torch.float64, device=m.device)
    if tuple(freqs.shape) != (rows,):
        raise WrongMatrixSpecified(f"frequencies shape {tuple(freqs.shape)} != ({rows},)")
    f = torch.full((cols,), 1.0 / cols, dtype=torch.float64, device=m.device)
    p = (freqs[:, None] * f[None, :]).reshape(1, -1)
    mf = m.reshape(M, -1)

    p_squared = pairwise_sum(p * p)
    k_0 = pairwise_sum(p * mf)
    a = (k_d - k_0) / p_squared
    b = k_d / p_squared
    base = mf + p * (a - b)[:, None]

    denominator = pairwise_sum(base * base)
    a_coeff = 2.0 * b * pairwise_sum(p * base) / denominator
    b_coeff = (b * b * p_squared - r_squared) / denominator

    disc = a_coeff * a_coeff - 4.0 * b_coeff
    sq = _sqrt(disc)  # NaN where disc < 0
    r0 = (-a_coeff - sq) / 2.0
    r1 = (-a_coeff + sq) / 2.0
    pb = p * b[:, None]
    m0 = pb + r0[:, None] * base
    m1 = pb + r1[:, None] * base
    d0 = _sqrt(pairwise_sum((mf - m0) * (mf - m0)))
    d1 = _sqrt(pairwise_sum((mf - m1) * (mf - m1)))
    straddle = (r0 < 0.0) & (0.0 < r1)
    out = torch.where((straddle | ~(d0 < d1))[:, None], m1, m0)
    out = torch.where((disc == 0.0)[:, None], pb + (-a_coeff / 2.0)[:, None] * base, out)
    return out.reshape(M, rows, cols)
