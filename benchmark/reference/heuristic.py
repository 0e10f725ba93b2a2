"""The reference's heuristic matrix population, in plain NumPy and the
plain fill of :mod:`reference.fill`.

Frozen copies of the rules the service applies (copied from
``aligner_tpu_torch/matrices.py:116-177`` ``get_threshold`` and
``transform_matrix``, themselves aligner-helpers ``matrices/mod.rs:8-65``,
and ``aligner_tpu_torch/result.py:27-37`` ``frequency_matrix``,
alignment.rs:13-23), and the loop of ``heuristic/mod.rs:36-78`` run for
every member of a population at once: align locally with the member's
transformed matrix, and while the score strictly improves, transform the
alignment's pair counts into the next matrix.  A member's answer is the
first alignment that does not improve, with the matrix that produced it;
a member whose fill has no positive cell has none (the reference would
panic there, simple/mod.rs:213-218).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .fill import BLANK, local_fill, pad, traceback


class NoRealRoots(ValueError):
    """The transform's quadratic has no real roots (WrongMatrixSpecified)."""


def get_threshold(dim: int) -> float:
    """Least L2 distance between a population's matrices
    (aligner-helpers/src/matrices/mod.rs:8-17)."""
    return {20: 22.6, 21: 23.1, 22: 23.6, 23: 24.1, 24: 24.6}.get(dim, 0.0)


def transform_matrix(matrix, k_d: float, r_squared: float, frequencies) -> np.ndarray:
    """``M' = p·b + x·(M + p·(a−b))`` with ``x`` the root of the quadratic
    that fixes ``‖M'‖² = r²`` (matrices/mod.rs:44-65): the positive root
    when the roots straddle 0, else the root whose result lies nearer M."""
    matrix = np.asarray(matrix, dtype=np.float64)
    frequencies = np.asarray(frequencies, dtype=np.float64)
    rows, cols = matrix.shape
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
        raise NoRealRoots("no real roots for the scaling quadratic")
    if disc == 0.0:
        return p * b + (-a_coeff / 2.0) * base
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


def frequency_matrix(query_aligned, target_aligned, vol: int) -> np.ndarray:
    """(vol, vol) counts of (target, query) code pairs, gaps excluded."""
    q = np.asarray(query_aligned, dtype=np.int64)
    t = np.asarray(target_aligned, dtype=np.int64)
    keep = (q != BLANK) & (t != BLANK)
    m = np.zeros((vol, vol), dtype=np.float64)
    np.add.at(m, (t[keep], q[keep]), 1.0)
    return m


def r_squared_of(r_squared: float, rows: int, cols: int) -> float:
    """``r_squared == 0`` means rows·cols (heuristic/mod.rs:48-50)."""
    return float(rows * cols) if abs(r_squared) < np.finfo(np.float64).eps else r_squared


@dataclasses.dataclass
class Member:
    f: float
    coords: tuple
    query: np.ndarray
    target: np.ndarray
    matrix: np.ndarray
    iterations: int


@dataclasses.dataclass
class PopulationTrace:
    """What the loop did: per iteration the members aligned and the steps
    of their tracebacks (the work of the program's fill and counting walk)."""

    members_aligned: list
    walk_steps: list
    walk_pairs: list


def populations(tasks, del_, ext, kd, r_squared, *, device, dtype=torch.float64,
                max_iters: int = 1000):
    """Run the loop for several populations at once, ``tasks`` a list of
    (query codes, target codes, (M, V, V) starting matrices, frequencies).
    Returns, per task, a list of :class:`Member` or None, and a
    :class:`PopulationTrace` per task."""
    mem = []  # (task, q, t, start) per member
    for ti, (q, t, starts, freqs) in enumerate(tasks):
        r2 = r_squared_of(r_squared, *starts.shape[1:])
        for m in starts:
            mem.append((ti, q, t, transform_matrix(m, kd, r2, freqs), freqs, r2))
    n = len(mem)
    V = tasks[0][2].shape[-1]
    trans = np.stack([x[3] for x in mem])
    max_f = np.zeros(n)
    done = np.zeros(n, bool)
    answer: list = [None] * n
    last: list = [None] * n
    traces = [PopulationTrace([], [], []) for _ in tasks]
    qd, qld = pad([x[1] for x in mem], device)
    td, tld = pad([x[2] for x in mem], device)
    qn, tn = qd.cpu().numpy(), td.cpu().numpy()
    task_of = np.array([x[0] for x in mem])
    it = 0
    while it < max_iters and not done.all():
        it += 1
        act = np.flatnonzero(~done)
        ai = torch.as_tensor(act, device=device)
        cur = trans[act].copy()
        r = local_fill(qd[ai], qld[ai], td[ai], tld[ai],
                       torch.as_tensor(cur, device=device), del_, ext,
                       dtype=dtype, with_dirs=True)
        w = traceback(r.dirs.cpu().numpy(), r.fy.cpu().numpy(), r.fx.cpu().numpy(),
                      qn[act], tn[act])
        f = r.f.cpu().numpy().astype(np.float64)
        for ti, tr in enumerate(traces):
            mine = task_of[act] == ti
            if mine.any():
                ks = [k for k in np.flatnonzero(mine) if w.query[k] is not None]
                tr.members_aligned.append(int(mine.sum()))
                # a step a cell read: the argmax and each cell moved to
                tr.walk_steps.append(sum(len(w.query[k]) for k in ks))
                tr.walk_pairs.append(sum(int(((w.query[k] != BLANK) & (w.target[k] != BLANK)).sum())
                                         for k in ks))
        for k, i in enumerate(act):
            if w.query[k] is None:
                done[i] = True  # no positive cell: no alignment
                answer[i] = None
                continue
            last[i] = Member(float(f[k]), w.coords[k], w.query[k], w.target[k],
                             cur[k], it)
            if f[k] > max_f[i]:
                max_f[i] = f[k]
                fm = frequency_matrix(w.query[k], w.target[k], V)
                trans[i] = transform_matrix(fm, kd, mem[i][5], mem[i][4])
            else:
                done[i] = True
                answer[i] = last[i]
    for i in np.flatnonzero(~done):
        answer[i] = last[i]  # max_iters spent: the last alignment, its matrix
    out, start = [], 0
    for q, t, starts, freqs in tasks:
        out.append(answer[start:start + len(starts)])
        start += len(starts)
    return out, traces
