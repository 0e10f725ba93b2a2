"""The port on the card: the CUDA kernels against their plain PyTorch
versions, bit for bit: the fill kernel in pair mode (K1/K2) and in PWM
mode (K3), also around the rows of a column it keeps on chip, the walk
(K4), the row-scan fill of one global pair (K5), the replay walk (also
with a column base), the band fill (K6) with the end score built on it,
and the column-block fill (K7) with the column-blocked pipeline built on
it (its three block engines and the engine pick), and the heuristic
population's counting walk with the float64 transform and the population
built on them, and the fill's score plane with ``keep_planes`` and the
simple aligners on it, and the host walks (``walk="host"``) against the
device walks.  Then the main path through the entry points a user calls:
the golden fixtures, ``calculate_p_value`` against the fit on native C++
scores, ``aligner-search``, ``aligner-align -g`` on a pair wider than one
plane and ``aligner-repeat-search`` against the same CLIs on the CPU, one
service request drained by a worker process on the card with its p-values
from ``aligner-torch-calc``, and a full-mode batch against native C++.

Marked ``cuda``; every test skips where no CUDA device is present.  The
machine with the card has no JAX, so run this file there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import contextlib
import io
import json
import os
import pathlib
import sqlite3
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import aligner_tpu_torch as port
from aligner_tpu_torch import host, native
from aligner_tpu_torch.cli import search as cli_search
from aligner_tpu_torch.io import read_fasta_file
from aligner_tpu_torch.matrices import blosum62, transform_matrix, transform_matrix_torch
from aligner_tpu_torch.ops import device_walk, dp_fill, wavefront
from aligner_tpu_torch.ops.scan_engine import fill_batch, fill_pwm_batch
from test_torch_walk_host import COUNT_CASES as WALK_COUNT_CASES
from test_torch_walk_host import count_case as walk_count_case

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

V = 24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batch(seed, B, C, R, dense, dev):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, V, (B, C)).astype(np.int32)
    t = rng.integers(0, V, (B, R)).astype(np.int32)
    if dense:
        ql, tl = np.full(B, C, np.int32), np.full(B, R, np.int32)
    else:
        ql = rng.integers(0, C + 1, B).astype(np.int32)
        tl = rng.integers(0, R + 1, B).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)]


def _equal(a, b):
    for f in ("fmax", "fy", "fx", "end", "words"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("track", [True, False], ids=["argmax", "noargmax"])
@pytest.mark.parametrize("dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("dense", [False, True], ids=["ragged", "dense"])
def test_fill_kernel_matches_plain(dev, dtype, mode, track, dirs, dense):
    q, ql, t, tl = _batch(1, 300, 40, 37, dense, dev)
    m = torch.as_tensor(np.array(blosum62()), dtype=dtype, device=dev)
    kw = dict(mode=mode, track_argmax=track, with_dirs=dirs)
    got = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, **kw)
    torch.cuda.synchronize()
    _equal(got, fill_batch(q, ql, t, tl, m, 11.0, 2.0, **kw))


@pytest.mark.parametrize("mode", ["local", "global"])
def test_fill_kernel_batched_float_matrix_f64(dev, mode):
    q, ql, t, tl = _batch(2, 130, 24, 29, False, dev)
    rng = np.random.default_rng(3)
    m = torch.as_tensor(rng.normal(0.0, 3.0, (130, V, V)), device=dev)
    kw = dict(mode=mode, with_dirs=True)
    _equal(dp_fill.fill(q, ql, t, tl, m, 3.5, 1.25, **kw),
           fill_batch(q, ql, t, tl, m, 3.5, 1.25, **kw))


@pytest.mark.parametrize("mode", ["local", "global"])
def test_walk_kernel_matches_plain(dev, mode):
    q, ql, t, tl = _batch(4, 257, 40, 45, False, dev)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32, device=dev)
    r = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, mode=mode, with_dirs=True)
    sy, sx = (tl, ql) if mode == "global" else (r.fy, r.fx)
    S = t.shape[1] + q.shape[1] + 1
    got = device_walk.walk(r.words, sy, sx, S=S, mode=mode)
    want = device_walk.walk_plain(r.words, sy, sx, S=S, mode=mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_launch_counters_count_kernel_launches(dev):
    q, ql, t, tl = _batch(5, 40, 16, 16, False, dev)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32, device=dev)
    s0, d0, w0 = dp_fill.launches.scores, dp_fill.launches.dirs, device_walk.launches.walk
    r = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, with_dirs=True)
    dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0)
    device_walk.walk(r.words, r.fy, r.fx, S=33, mode="local")
    assert (dp_fill.launches.scores, dp_fill.launches.dirs, device_walk.launches.walk) \
        == (s0 + 1, d0 + 1, w0 + 1)


def _thread_design(monkeypatch):
    """Hold every fill to one thread a problem: ``plan_fill``'s test-only
    ``lone=False``."""
    planned = dp_fill.plan_fill
    monkeypatch.setattr(dp_fill, "plan_fill",
                        lambda *a, **kw: planned(*a, **{**kw, "lone": False}))


def _rows_on_chip_at_most(matrix, B):
    """S of the fill's launch plan for B problems whose columns are too
    tall for the chip."""
    return dp_fill.launch_plan(B, 8_000, matrix).rows_on_chip


@pytest.mark.parametrize("where", [-8, 0, 8], ids=["below", "at", "spilled"])
@pytest.mark.parametrize("dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("kind", ["local", "global", "pwm-shared", "pwm-batched"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fill_kernel_around_the_rows_on_chip(dev, monkeypatch, dtype, kind, dirs, where):
    """Columns of R8 = S - 1 + where rows: one 8-row block short of the
    most the chip holds, exactly that (S = R8 + 1), and one block more
    (rows S..R8 in the device buffer).  One thread a problem: 40 pair
    problems with directions would take the lone design."""
    _thread_design(monkeypatch)
    B, C = 40, 5
    rng = np.random.default_rng(11)
    if kind.startswith("pwm"):
        shape = (B, 4, C) if kind == "pwm-batched" else (4, C)
        matrix = torch.as_tensor(rng.normal(0.0, 3.0, shape), dtype=dtype, device=dev)
    else:
        matrix = torch.as_tensor(np.array(blosum62()), dtype=dtype, device=dev)
    R8 = _rows_on_chip_at_most(matrix, B) - 1 + where
    assert (dp_fill.launch_plan(B, R8, matrix).rows_on_chip < R8 + 1) == (where > 0)
    # most rows reach the bottom of the column; a few problems are ragged
    rl = np.clip(R8 - rng.integers(0, 20, B), 0, R8).astype(np.int32)
    rl[::7] = rng.integers(0, R8 + 1, len(rl[::7]))
    spilled = dp_fill.launches.spilled
    if kind.startswith("pwm"):
        q = torch.as_tensor(rng.integers(0, 4, (B, R8)), dtype=torch.int32, device=dev)
        ql = torch.as_tensor(rl, device=dev)
        kw = dict(with_dirs=dirs)
        got = dp_fill.fill_pwm(q, ql, matrix, 6.5, 1.75, **kw)
        want = fill_pwm_batch(q, ql, matrix, 6.5, 1.75, **kw)
    else:
        q = torch.as_tensor(rng.integers(0, V, (B, C)), dtype=torch.int32, device=dev)
        ql = torch.as_tensor(rng.integers(0, C + 1, B), dtype=torch.int32, device=dev)
        t = torch.as_tensor(rng.integers(0, V, (B, R8)), dtype=torch.int32, device=dev)
        tl = torch.as_tensor(rl, device=dev)
        kw = dict(mode=kind, with_dirs=dirs)
        got = dp_fill.fill(q, ql, t, tl, matrix, 11.0, 2.0, **kw)
        want = fill_batch(q, ql, t, tl, matrix, 11.0, 2.0, **kw)
    torch.cuda.synchronize()
    assert dp_fill.launches.spilled == spilled + (where > 0)
    _equal(got, want)


@pytest.mark.parametrize("dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("rows", ["short", "spilled"])
def test_fill_kernel_reads_a_broadcast_query_as_its_replicated_rows(dev, rows, dtype,
                                                                    mode, dirs):
    """A query row expanded over the batch (stride 0), as a search bucket
    hands it, gives the launch of the replicated rows bit for bit: a batch
    of 300 (not a multiple of 32), columns that fit on chip and columns
    with rows off chip."""
    B, C = 300, 45
    rng = np.random.default_rng(22)
    m = torch.as_tensor(np.array(blosum62()), dtype=dtype, device=dev)
    R8 = 40 if rows == "short" else _rows_on_chip_at_most(m, B) + 15
    row = torch.as_tensor(rng.integers(0, V, C), dtype=torch.int32, device=dev)
    ql = torch.full((B,), C, dtype=torch.int32, device=dev)
    ql[::13] = 0  # a skipped problem reads the row too
    t = torch.as_tensor(rng.integers(0, V, (B, R8)), dtype=torch.int32, device=dev)
    tl = torch.as_tensor(np.clip(R8 - rng.integers(0, 30, B), 0, R8), dtype=torch.int32,
                         device=dev)
    spilled = dp_fill.launches.spilled
    kw = dict(mode=mode, with_dirs=dirs)
    got = dp_fill.fill(row.expand(B, -1), ql, t, tl, m, 11.0, 2.0, **kw)
    want = dp_fill.fill(row.repeat(B, 1), ql, t, tl, m, 11.0, 2.0, **kw)
    torch.cuda.synchronize()
    assert dp_fill.launches.spilled == spilled + 2 * (rows == "spilled")
    _equal(got, want)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_batch_align_with_one_query_object_on_the_card(dev, mode):
    """``batch_align`` of ``[q] * n`` (the query sent once, read by every
    problem) against the same batch of distinct copies, on the card."""
    rng = np.random.default_rng(23)
    q = rng.integers(0, V, 333).astype(np.int8)
    ts = [rng.integers(0, V, int(n)).astype(np.int8) for n in rng.integers(1, 500, 1000)]
    ts[17] = q.copy()
    for kw in ({}, {"with_alignments": True, "skip": np.arange(1000) % 9 == 4}):
        got = port.batch_align([q] * 1000, ts, blosum62(), 11.0, 2.0, mode=mode,
                               device=dev, **kw)
        want = port.batch_align([q.copy() for _ in ts], ts, blosum62(), 11.0, 2.0,
                                mode=mode, device=dev, **kw)
        if not kw:
            for f in ("fmax", "fy", "fx", "end"):
                assert np.array_equal(getattr(got, f), getattr(want, f)), f
            continue
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.alignment.f == b.alignment.f
                assert a.alignment.coords == b.alignment.coords
                assert np.array_equal(a.alignment.query, b.alignment.query)
                assert np.array_equal(a.alignment.target, b.alignment.target)


def test_fill_kernel_refuses_more_shared_memory_than_the_card_has(dev, monkeypatch):
    """A plan that asks for more shared memory than a block may have is
    refused at launch and raises; it never runs with less."""
    roomy = dp_fill.CardLimits(sms=132, smem_per_block=10**7, smem_per_sm=10**7,
                               smem_reserved=1024)
    monkeypatch.setattr(dp_fill, "card_limits", lambda d: roomy)
    q, ql, t, tl = _batch(12, 40, 8, 2000, True, dev)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="dp_fill launch failed"):
        dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0)


def test_fill_kernel_takes_at_most_256_symbols(dev):
    q, ql, t, tl = _batch(13, 8, 4, 4, True, dev)
    with pytest.raises(ValueError, match="at most 256"):
        dp_fill.fill(q, ql, t, tl, torch.zeros((300, 300), device=dev), 11.0, 2.0)


def _lone_matrix(kind, B, dev):
    """The search's f32 BLOSUM62, in f64, and the population's f64 matrix a
    problem."""
    if kind == "f64-each":
        rng = np.random.default_rng(B)
        return torch.as_tensor(rng.normal(0.0, 3.0, (B, V, V)), device=dev)
    dtype = torch.float32 if kind == "f32" else torch.float64
    return torch.as_tensor(np.array(blosum62()), dtype=dtype, device=dev)


def _lone_against_both(monkeypatch, q, ql, t, tl, m, del_, ext, mode):
    """The fill on the lone design (one launch of it) equal to the same fill
    on one thread a problem and to the plain version, bit for bit."""
    kw = dict(mode=mode, with_dirs=True)
    lone = dp_fill.launches.lone
    got = dp_fill.fill(q, ql, t, tl, m, del_, ext, **kw)
    torch.cuda.synchronize()
    assert dp_fill.launches.lone == lone + 1
    with monkeypatch.context() as mp:
        _thread_design(mp)
        thread = dp_fill.fill(q, ql, t, tl, m, del_, ext, **kw)
        torch.cuda.synchronize()
    assert dp_fill.launches.lone == lone + 1
    _equal(got, thread)
    _equal(got, fill_batch(q, ql, t, tl, m, del_, ext, **kw))


@pytest.mark.parametrize("matrix", ["f32", "f64", "f64-each"])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("B", [1, 10, 64, 132])
def test_lone_design_is_the_thread_design_and_the_plain_fill(dev, monkeypatch, B, mode,
                                                            matrix):
    """Ragged problems (rows not a multiple of 8), one of them whole."""
    q, ql, t, tl = _batch(40 + B, B, 45, 61, False, dev)
    ql[0], tl[0] = 45, 61
    _lone_against_both(monkeypatch, q, ql, t, tl, _lone_matrix(matrix, B, dev), 11.0, 2.0,
                       mode)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_lone_design_at_the_top_10s_height(dev, monkeypatch, mode):
    """Ten targets of up to 2,000 residues, the tallest whole, as the
    search's top 10 has them."""
    q, ql, t, tl = _batch(50, 10, 40, 2_000, False, dev)
    ql[:] = 40
    tl[3] = 2_000
    _lone_against_both(monkeypatch, q, ql, t, tl, _lone_matrix("f32", 10, dev), 11.0, 2.0,
                       mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["local", "global"])
def test_lone_design_on_ties_and_zero_columns(dev, monkeypatch, mode, dtype):
    """A matrix of -1, 0 and 1 whose symbol 0 scores 0 against all, queries
    that start with three 0s, penalties 1 and 1: tied directions and maxima,
    and local columns that hold 0 alone."""
    rng = np.random.default_rng(51)
    q, ql, t, tl = _batch(52, 10, 30, 27, False, dev)
    q[:, :3] = 0
    m = rng.integers(-1, 2, (V, V)).astype(np.float64)
    m[:, 0] = 0.0
    _lone_against_both(monkeypatch, q, ql, t, tl, torch.as_tensor(m, dtype=dtype, device=dev),
                       1.0, 1.0, mode)


def test_lone_launches_are_counted(dev):
    """``launches.lone`` counts the pair-mode fills with directions and
    argmax tracking of at most one problem an SM, and nothing else."""
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32, device=dev)
    pwm = torch.as_tensor(np.random.default_rng(0).normal(0.0, 3.0, (4, 30)), device=dev)
    sms = dp_fill.card_limits(dev).sms

    def lone_after(fn):
        before = dp_fill.launches.lone, dp_fill.launches.dirs
        fn()
        torch.cuda.synchronize()
        return dp_fill.launches.lone - before[0], dp_fill.launches.dirs - before[1]

    def pair(B, **kw):
        q, ql, t, tl = _batch(60, B, 20, 20, False, dev)
        return lambda: dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, **kw)

    assert lone_after(pair(sms, with_dirs=True)) == (1, 1)
    assert lone_after(pair(10, mode="global", with_dirs=True)) == (1, 1)
    assert lone_after(pair(sms + 1, with_dirs=True)) == (0, 1)
    assert lone_after(pair(10, with_dirs=True, track_argmax=False)) == (0, 1)
    assert lone_after(pair(10, with_dirs=True, with_scores_plane=True)) == (0, 1)
    assert lone_after(pair(10)) == (0, 0)
    q = torch.as_tensor(np.random.default_rng(1).integers(0, 4, (10, 24)), dtype=torch.int32,
                        device=dev)
    ql = torch.full((10,), 24, dtype=torch.int32, device=dev)
    assert lone_after(lambda: dp_fill.fill_pwm(q, ql, pwm, 3.0, 1.0, with_dirs=True)) \
        == (0, 0)
    rng = np.random.default_rng(2)
    qs = [rng.integers(0, V, 50).astype(np.int8) for _ in range(10)]
    assert lone_after(lambda: port.batch_align(qs, qs, blosum62(), 11.0, 2.0, device=dev,
                                               with_alignments=True)) == (1, 1)


def test_search_top_10_on_the_lone_design_is_todays(dev, monkeypatch):
    """A search's hits with alignments, its top 10 filled by the lone
    design (one launch), equal to the same search on one thread a
    problem."""
    from aligner_tpu_torch import search

    rng = np.random.default_rng(27)
    lens = list(rng.integers(30, 400, 2000))
    db = [rng.integers(0, 20, int(n)).astype(np.int8) for n in lens]
    q = rng.integers(0, 20, 600).astype(np.int8)
    for i, w in ((100, 600), (200, 300), (300, 450)):
        db[i] = q[600 - w:].copy()
        db[i][rng.integers(0, w, w // 10)] = rng.integers(0, 20, w // 10)

    def hits():
        monkeypatch.setattr(search, "_resident", search._Resident())
        lone = dp_fill.launches.lone
        found = port.search_database(q, db, blosum62(), 11.0, 2.0, k=10, device=dev)
        return [(h.index, h.score, h.coords, h.query_aligned.tolist(),
                 h.target_aligned.tolist()) for h in found], dp_fill.launches.lone - lone

    got, lone = hits()
    assert lone == 1 and len(got) == 10 and {100, 200, 300} <= {h[0] for h in got}
    with monkeypatch.context() as mp:
        _thread_design(mp)
        want, lone = hits()
    assert lone == 0 and got == want


def test_population_on_the_lone_design_is_todays(dev, monkeypatch):
    """One population task of 64 members: every fill with directions, an
    iteration's and the final alignments', takes the lone design, and the
    members equal those of the same task on one thread a problem."""
    rng = np.random.default_rng(4)
    q = rng.integers(0, 24, 120).astype(np.int8)
    t = q.copy()
    t[rng.integers(1, 120, 25)] = rng.integers(0, 24, 25)
    mats = rng.integers(-2, 3, (64, 24, 24)).astype(np.float64)
    freqs = rng.random(24)
    freqs /= freqs.sum()
    h = port.Heuristics(kd=0.0, r_squared=1e5, frequencies=freqs)
    port.warmup_population(q, t, 64, 11.0, 1.0)
    before = dp_fill.launches.lone, dp_fill.launches.dirs
    got = port.heuristic_align_population(q, t, mats, 11.0, 1.0, h)
    lone, dirs = dp_fill.launches.lone - before[0], dp_fill.launches.dirs - before[1]
    assert lone == dirs >= 2
    with monkeypatch.context() as mp:
        _thread_design(mp)
        want = port.heuristic_align_population(q, t, mats, 11.0, 1.0, h)
    assert dp_fill.launches.lone - before[0] == lone
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.alignment.f == b.alignment.f
            assert np.array_equal(a.alignment.query, b.alignment.query)
            assert np.array_equal(a.alignment.target, b.alignment.target)
            assert a.alignment.coords == b.alignment.coords
            assert np.array_equal(a.matrix, b.matrix)


def _pwm_batch(seed, B, R, W, batched, integral, dev):
    """B ragged queries (lengths 0..R, some 0) and a shared or per-problem
    asymmetric PWM: integral for f32, non-integral for f64."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, R)).astype(np.int32)
    ql = rng.integers(0, R + 1, B).astype(np.int32)
    ql[::17] = 0
    shape = (B, 4, W) if batched else (4, W)
    if integral:
        pwm = torch.as_tensor(rng.integers(-4, 6, shape), dtype=torch.float32)
    else:
        pwm = torch.as_tensor(rng.normal(0.0, 3.0, shape), dtype=torch.float64)
    return torch.from_numpy(q).to(dev), torch.from_numpy(ql).to(dev), pwm.to(dev)


@pytest.mark.parametrize("integral", [True, False], ids=["f32int", "f64"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
@pytest.mark.parametrize("track", [True, False], ids=["argmax", "noargmax"])
@pytest.mark.parametrize("dirs", [False, True], ids=["scores", "dirs"])
def test_pwm_fill_kernel_matches_plain(dev, integral, batched, track, dirs):
    # R and W multiples of neither 8 nor 32
    q, ql, pwm = _pwm_batch(6, 300, 45, 37, batched, integral, dev)
    kw = dict(track_argmax=track, with_dirs=dirs)
    got = dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, **kw)
    torch.cuda.synchronize()
    _equal(got, fill_pwm_batch(q, ql, pwm, 6.5, 1.75, **kw))


def test_pwm_fill_kernel_reads_the_row_layout_in_place(dev):
    q, ql, pwm = _pwm_batch(7, 200, 40, 29, False, False, dev)
    rows = q.T.contiguous()  # (R, B), R a multiple of 8: read in place
    a = dp_fill.fill_pwm(rows.T, ql, pwm, 6.5, 1.75, track_argmax=False)
    _equal(a, fill_pwm_batch(q, ql, pwm, 6.5, 1.75, track_argmax=False))


@pytest.mark.parametrize("W", [2000, 8000], ids=["optin-smem", "l1"])
def test_pwm_fill_kernel_large_shared_pwm(dev, W):
    """A shared f64 PWM above 48 KB opts in to the larger dynamic shared
    memory (W = 2000: 64 KB); above that limit (W = 8000: 256 KB) it is
    read through the cache."""
    q, ql, pwm = _pwm_batch(8, 40, 16, W, False, False, dev)
    kw = dict(with_dirs=True)
    _equal(dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, **kw),
           fill_pwm_batch(q, ql, pwm, 6.5, 1.75, **kw))


def test_walk_kernel_on_pwm_words(dev):
    q, ql, pwm = _pwm_batch(9, 257, 45, 37, False, False, dev)
    r = dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, with_dirs=True)
    S = q.shape[1] + pwm.shape[-1] + 1
    got = device_walk.walk(r.words, r.fy, r.fx, S=S, mode="local")
    want = device_walk.walk_plain(r.words, r.fy, r.fx, S=S, mode="local")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pwm_launch_counters_count_kernel_launches(dev):
    q, ql, pwm = _pwm_batch(10, 40, 16, 20, False, False, dev)
    s0, d0 = dp_fill.launches.pwm_scores, dp_fill.launches.pwm_dirs
    p0 = dp_fill.launches.scores + dp_fill.launches.dirs
    dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, with_dirs=True)
    dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75)
    assert (dp_fill.launches.pwm_scores, dp_fill.launches.pwm_dirs) == (s0 + 1, d0 + 1)
    assert dp_fill.launches.scores + dp_fill.launches.dirs == p0


def _scan_case(seed, C, R, tr, dev, y_offset=0, ckpt_every=0):
    """A padded (q, t, matrix, h0) on the card for the row-scan fill."""
    rng = np.random.default_rng(seed)
    C_pad = -(-C // wavefront.COL_PAD) * wavefront.COL_PAD
    R_pad = -(-R // (ckpt_every or tr)) * (ckpt_every or tr)
    q = np.pad(rng.integers(0, V, C), (0, C_pad - C)).astype(np.int32)
    t = np.pad(rng.integers(0, V, R), (0, R_pad - R)).astype(np.int32)
    h0 = rng.integers(-500, 500, C_pad).astype(np.int32) if y_offset else None
    m = np.array(blosum62()).astype(np.int32)
    return [None if a is None else torch.from_numpy(a).to(dev) for a in (q, t, m, h0)]


SCAN_SHAPES = [(1, 1, 16), (1, 37, 16), (127, 40, 16), (128, 33, 32), (129, 70, 64),
               (257, 21, 16), (299, 97, 32), (4096, 4096, 64)]


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("C,R,tr", SCAN_SHAPES, ids=[f"{c}x{r}" for c, r, _ in SCAN_SHAPES])
def test_row_scan_kernel_matches_plain(dev, C, R, tr, K):
    """End cell, checkpoint rows and direction codes of the real cells; a
    forward fill with checkpoints, a fill with directions, and a block
    replayed from a row in the middle of the pair."""
    ck = 2 * tr if R > tr else 0
    q, t, m, _ = _scan_case(20, C, R, tr, dev, ckpt_every=ck)
    kw = dict(tile_rows=tr, cols_per_thread=K)
    end, _, ckpts = wavefront.row_scan(q, t, m, 11, 2, None, 0, C, R, with_dirs=False,
                                       ckpt_every=ck, **kw)
    torch.cuda.synchronize()
    end_p, _, ckpts_p = wavefront.row_scan_plain(q, t, m, 11, 2, None, 0, C, R, False, ck)
    assert torch.equal(end, end_p)
    assert ck == 0 or torch.equal(ckpts[:, :C], ckpts_p[:, :C])
    for y_offset in (0, 48):
        q, t, m, h0 = _scan_case(21, C, R, tr, dev, y_offset=y_offset)
        args = (q, t, m, 11, 2, h0, y_offset, C, R + y_offset)
        end, words, _ = wavefront.row_scan(*args, with_dirs=True, **kw)
        torch.cuda.synchronize()
        end_p, words_p, _ = wavefront.row_scan_plain(*args, True)
        assert torch.equal(end, end_p)
        d, d_p = (wavefront._unpack_dir_words(w.cpu().numpy())[:R, :C]
                  for w in (words, words_p))
        assert np.array_equal(d, d_p)


@pytest.mark.parametrize("C,R,tr", SCAN_SHAPES, ids=[f"{c}x{r}" for c, r, _ in SCAN_SHAPES])
def test_replay_walk_kernel_matches_plain(dev, C, R, tr):
    rng = np.random.default_rng(22)
    qn = rng.integers(0, 20, C)
    tn = np.resize(qn, R).copy()
    mask = rng.random(R) < 0.25
    tn[mask] = rng.integers(0, 20, int(mask.sum()))
    C_pad = -(-C // wavefront.COL_PAD) * wavefront.COL_PAD
    R_pad = -(-R // tr) * tr
    q = torch.from_numpy(np.pad(qn, (0, C_pad - C)).astype(np.int32)).to(dev)
    t = torch.from_numpy(np.pad(tn, (0, R_pad - R)).astype(np.int32)).to(dev)
    m = torch.from_numpy(np.array(blosum62()).astype(np.int32)).to(dev)
    _, words, _ = wavefront.row_scan(q, t, m, 11, 2, None, 0, C, R, with_dirs=True,
                                     tile_rows=tr)
    got = wavefront.new_walk(R, C, R_pad + C_pad + 1, dev)
    want = wavefront.new_walk(R, C, R_pad + C_pad + 1, dev)
    wavefront.replay_walk(words, *got, row_base=0)
    torch.cuda.synchronize()
    wavefront.replay_walk_plain(words, *want, row_base=0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cy, cx, n = got[0].tolist()
    assert (cy == 0 or cx == 0) and n >= min(R, C)
    # a cursor outside the block's rows is left alone
    far = wavefront.new_walk(R + R_pad, C, R_pad + C_pad + 1, dev)
    wavefront.replay_walk(words, *far, row_base=0)
    assert far[0].tolist() == [R + R_pad, C, 0]


def test_wavefront_launch_counters_count_kernel_launches(dev):
    """One kernel launch a call of the row-scan fill, whatever its strips
    and chunks (3 x 4 here)."""
    q, t, m, _ = _scan_case(23, 300, 130, 64, dev)
    L = wavefront.launches
    before = (L.row_scan, L.row_scan_dirs, L.tile_launches, L.replay_walk)
    _, words, _ = wavefront.row_scan(q, t, m, 11, 2, None, 0, 300, 130, with_dirs=True,
                                     tile_rows=64, cols_per_thread=4)
    wavefront.row_scan(q, t, m, 11, 2, None, 0, 300, 130, with_dirs=False,
                       tile_rows=64, cols_per_thread=4)
    wavefront.replay_walk(words, *wavefront.new_walk(130, 300, 1000, dev), row_base=0)
    assert (L.row_scan, L.row_scan_dirs, L.tile_launches, L.replay_walk) == \
        (before[0] + 1, before[1] + 1, before[2] + 2, before[3] + 1)


def _scan_both(q, t, m, h0, y_offset, C, R_real, ckpt_every, **kw):
    """The row-scan fill on the card against its plain version, forward
    with checkpoints and with directions: end cell, checkpoint rows and
    codes of the real cells (``R_real`` may lie past the call)."""
    rows = min(t.numel(), R_real - y_offset)
    for dirs in (False, True):
        ck = 0 if dirs else ckpt_every
        got = wavefront.row_scan(q, t, m, 11, 2, h0, y_offset, C, R_real, with_dirs=dirs,
                                 ckpt_every=ck, **kw)
        torch.cuda.synchronize()
        want = wavefront.row_scan_plain(q, t, m, 11, 2, h0, y_offset, C, R_real, dirs, ck)
        assert torch.equal(got[0], want[0])
        if dirs:
            d, d_p = (wavefront._unpack_dir_words(w.cpu().numpy())[:rows, :C]
                      for w in (got[1], want[1]))
            assert np.array_equal(d, d_p)
        elif ck:
            assert torch.equal(got[2][:, :C], want[2][:, :C])


# (C, R, strip rows, columns a lane, y_offset, R_real past the call): one
# strip, one chunk, 16/32/64-row strips, a call from the middle of the pair,
# the end cell past the call
STRIP_SCAN_CASES = [(300, 64, 64, 4, 0, 0), (256, 640, 64, 8, 0, 0),
                    (128, 600, 32, 4, 0, 0), (1000, 700, 16, 2, 0, 0),
                    (700, 500, 32, 8, 96, 0), (513, 300, 64, 2, 64, 50),
                    (2048, 2048, 16, 8, 0, 0), (4096, 1024, 64, 2, 1024, 7)]


@pytest.mark.parametrize("C,R,tr,K,y_offset,past", STRIP_SCAN_CASES,
                         ids=[f"{c}x{r}-tr{tr}-k{k}-y{y}-p{p}"
                              for c, r, tr, k, y, p in STRIP_SCAN_CASES])
def test_strip_walk_row_scan_matches_plain(dev, C, R, tr, K, y_offset, past):
    q, t, m, h0 = _scan_case(60 + C, C, R, tr, dev, y_offset=y_offset)
    _scan_both(q, t, m, h0, y_offset, C, R + y_offset + past, tr, tile_rows=tr,
               cols_per_thread=K)


def _small_card(monkeypatch, blocks_per_sm=1, sms=1):
    """Plans for a card that holds ``blocks_per_sm`` blocks on ``sms`` SMs,
    so that a call has more strips than the grid has warps."""
    monkeypatch.setattr(wavefront, "_sms", lambda index: sms)
    monkeypatch.setattr(wavefront, "_blocks_per_sm", lambda *a: blocks_per_sm)


@pytest.mark.parametrize("warps", [1, 4])
def test_strip_walk_more_strips_than_the_grid_holds(dev, monkeypatch, warps):
    """40 strips on one block of 1 or 4 warps: the warps take strips by
    ticket in rounds."""
    _small_card(monkeypatch)
    monkeypatch.setattr(wavefront, "STRIP_WARPS", warps)
    plan = wavefront.strip_plan(dev, False, 40 * 16, 768, 16, 4, V, False)
    assert (plan.n_tr, plan.warps, plan.blocks) == (40, warps, 1)
    q, t, m, _ = _scan_case(70, 700, 40 * 16, 16, dev)
    _scan_both(q, t, m, None, 0, 700, 40 * 16, 32, tile_rows=16, cols_per_thread=4)
    args = _block_case(71, 600, 640, 256, 640, 1, 0, dev)
    for dirs in (False, True):
        kw = dict(del_=11, ext=2, with_dirs=dirs, ckpt_every=0 if dirs else 32)
        got = wavefront.run_block_cs(*args, **kw, tile_rows=16, cols_per_thread=2)
        torch.cuda.synchronize()
        assert _same_block(got, wavefront.run_block_cs_plain(*args, **kw), 640, 256)


def test_strip_walk_back_to_back_on_one_stream(dev):
    """Two calls in a row with no synchronisation between them: each has
    its own counters, and the second does not read the first's."""
    a = _scan_case(72, 900, 400, 32, dev)
    b = _scan_case(73, 900, 400, 32, dev)
    got = [wavefront.row_scan(q, t, m, 11, 2, None, 0, 900, 400, with_dirs=True,
                              tile_rows=32) for q, t, m, _ in (a, b, a)]
    torch.cuda.synchronize()
    for (q, t, m, _), g in zip((a, b, a), got):
        want = wavefront.row_scan_plain(q, t, m, 11, 2, None, 0, 900, 400, True)
        assert torch.equal(g[0], want[0]) and torch.equal(g[1][:, :900], want[1][:, :900])


def test_strip_walk_on_two_streams(dev):
    """Two calls on two streams at once, each with its own counters."""
    cases = [_scan_case(74 + k, 2000, 1024, 64, dev) for k in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    torch.cuda.synchronize()
    got = []
    for (q, t, m, _), st in zip(cases, streams):
        with torch.cuda.stream(st):
            got.append(wavefront.row_scan(q, t, m, 11, 2, None, 0, 2000, 1024,
                                          with_dirs=False, ckpt_every=64))
    torch.cuda.synchronize()
    for (q, t, m, _), g in zip(cases, got):
        want = wavefront.row_scan_plain(q, t, m, 11, 2, None, 0, 2000, 1024, False, 64)
        assert torch.equal(g[0], want[0]) and torch.equal(g[2][:, :2000], want[2][:, :2000])


@pytest.mark.parametrize("budget", [None, 1000], ids=["direct", "chunked"])
def test_align_global_on_the_card_matches_the_host_engine(dev, monkeypatch, budget):
    from aligner_tpu_torch import align_global, host

    if budget:
        monkeypatch.setattr(wavefront, "DIRECT_PLANE_CELLS", budget)
    rng = np.random.default_rng(24)
    q = rng.integers(0, 20, 700).astype(np.int8)
    t = np.resize(q, 900).copy()
    t[rng.random(900) < 0.25] = 3
    ref = host.align_global(q, t, np.array(blosum62()), 11.0, 2.0)
    a = align_global(q, t, blosum62(), 11.0, 2.0, device=dev).alignment
    assert np.array_equal(a.query, ref.query_aligned)
    assert np.array_equal(a.target, ref.target_aligned)
    assert tuple(map(tuple, a.coords)) == tuple(map(tuple, ref.coords))


def _band_case(seed, C, R, TB, jb, dev, m=None, d=11, e=2, K=1):
    """The inputs of band ``jb`` of a seeded pair on the card, as
    ``end_score_single_global_diag`` builds them for a kernel of ``K`` rows
    a lane (a band taller than the pair is cut to a multiple of 32 K rows);
    the bands above it are filled with the plain version."""
    rng = np.random.default_rng(seed)
    m = np.array(blosum62()) if m is None else m
    q = rng.integers(0, m.shape[0], C)
    t = rng.integers(0, m.shape[0], R)
    pp = wavefront._prep(q, t, m, d, e, dev)
    bands = []
    wavefront._band_end_score(pp, TB, 32, K, block=wavefront.run_block_band_plain,
                              trace=bands)
    args, kw, _ = bands[jb]
    return args, kw


def _same_band(got, want, TB, Cb):
    """rb on the slots that cells of the block's columns feed, rc and end."""
    return (torch.equal(got[0][TB - 1:TB - 1 + Cb], want[0][TB - 1:TB - 1 + Cb])
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))


# (C, R, TB, band): band heights at, below and one past the row count,
# widths at and one past a tile seam, band 0 and a later band
BAND_SHAPES = [(1, 1, 256, 0), (255, 256, 256, 0), (257, 257, 256, 1), (256, 600, 256, 2),
               (257, 100, 512, 0), (700, 1025, 512, 1), (64, 700, 256, 2)]


@pytest.mark.parametrize("with_rc", [True, False], ids=["rc", "norc"])
@pytest.mark.parametrize("K,P", [(1, 16), (2, 32), (4, 64), (8, 32)])
@pytest.mark.parametrize("C,R,TB,jb", BAND_SHAPES,
                         ids=[f"{c}x{r}-tb{tb}-band{j}" for c, r, tb, j in BAND_SHAPES])
def test_band_kernel_matches_plain(dev, C, R, TB, jb, K, P, with_rc):
    args, kw = _band_case(30, C, R, TB, jb, dev, K=K)
    got = wavefront.run_block_band(*args, **kw, with_rc=with_rc, read_ahead=P,
                                   rows_per_lane=K)
    torch.cuda.synchronize()
    want = wavefront.run_block_band_plain(*args, **kw, with_rc=with_rc)
    assert _same_band(got, want, args[0].numel(), kw["Cb"])


def test_band_kernel_wide_range_matrix(dev):
    m = np.random.default_rng(31).integers(-30, 30, (4, 4)).astype(np.float64)
    args, kw = _band_case(32, 150, 170, 128, 1, dev, m=m, d=5, e=2)
    got = wavefront.run_block_band(*args, **kw)
    want = wavefront.run_block_band_plain(*args, **kw)
    assert _same_band(got, want, 128, kw["Cb"])


def test_band_kernel_streamed_left_boundary(dev):
    """Column blocks fed their left neighbour's right column, against the
    host engine's plane and the plain version's grid."""
    from aligner_tpu_torch import host
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    rng = np.random.default_rng(33)
    C, R, tb, cb = 600, 300, 128, 256
    q, t = rng.integers(0, V, C).astype(np.int8), rng.integers(0, V, R).astype(np.int8)
    m = np.array(blosum62())
    H = host.align_global(q, t, m, 11.0, 2.0).score
    end, rights, bottoms = sp.band_grid(q, t, m, 11.0, 2.0, tb=tb, cb=cb, device=dev,
                                        read_ahead=64)
    end_p, rights_p, bottoms_p = sp.band_grid(
        q, t, m, 11.0, 2.0, tb=tb, cb=cb, device=dev, block=wavefront.run_block_band_plain)
    assert int(end) == int(end_p) == H[R, C]
    for ci in range(2):  # the third block's right column lies past the query
        col = rights[ci][:R]
        assert torch.equal(col, rights_p[ci][:R])
        assert np.array_equal(col.cpu().numpy(), H[1:R + 1, (ci + 1) * cb])
    for jb in range(2):
        for ci in range(3):
            n = min(cb, C - ci * cb)
            row = bottoms[jb][ci][:n]
            assert torch.equal(row, bottoms_p[jb][ci][:n])
            assert np.array_equal(row.cpu().numpy(),
                                  H[(jb + 1) * tb, ci * cb + 1:ci * cb + 1 + n])


def test_band_launch_counter_counts_kernel_launches(dev):
    """One kernel launch a call, whatever the groups."""
    L = wavefront.launches
    for C, R, TB, K in ((300, 130, 256, 4), (2000, 2000, 2048, 1), (70, 1, 128, 2)):
        args, kw = _band_case(34, C, R, TB, 0, dev, K=K)
        before = (L.band, L.band_tile_launches, L.row_scan)
        wavefront.run_block_band(*args, **kw, rows_per_lane=K)
        assert L.band == before[0] + 1 and L.band_tile_launches == before[1] + 1
        assert L.row_scan == before[2]


def test_band_kernel_more_groups_than_the_grid_holds(dev, monkeypatch):
    """A grid of one warp takes every group in turn, by its ticket."""
    args, kw = _band_case(36, 900, 1100, 1024, 0, dev, K=1)
    fit = wavefront._band_fit
    monkeypatch.setattr(wavefront, "BAND_WARPS", 1)
    monkeypatch.setattr(wavefront, "_sms", lambda index: 1)
    monkeypatch.setattr(wavefront, "_band_fit", lambda *a: dict(fit(*a), blocks_per_sm=1))
    plan = wavefront.band_plan(dev, args[0].numel(), kw["Cb"], args[1].numel(), 1,
                               wavefront.BAND_READ_AHEAD, V)
    assert plan.warps * plan.blocks == 1 < plan.n_g
    got = wavefront.run_block_band(*args, **kw, rows_per_lane=1)
    want = wavefront.run_block_band_plain(*args, **kw)
    assert _same_band(got, want, args[0].numel(), kw["Cb"])


# V -> the copies of the score table a block of 4 warps reading 32 slots
# ahead keeps on an H100 (228 KB of shared memory an SM): the most with
# which two blocks share an SM, and one copy where only one block fits
TABLE_COPIES = {4: 32, 24: 32, 48: 8, 64: 4, 200: 1}


@pytest.mark.parametrize("V", list(TABLE_COPIES))
def test_band_kernel_any_alphabet(dev, V):
    """An integral matrix over V symbols: the block keeps as many copies of
    the table as leave room for two blocks an SM, and the kernel matches
    the plain version."""
    m = np.random.default_rng(V).integers(-30, 30, (V, V)).astype(np.float64)
    args, kw = _band_case(38, 700, 1000, 512, 1, dev, m=m, d=9, e=3, K=2)
    plan = wavefront.band_plan(dev, args[0].numel(), kw["Cb"], args[1].numel(), 2,
                               wavefront.BAND_READ_AHEAD, V)
    assert plan.copies == TABLE_COPIES[V] and plan.blocks >= 1
    got = wavefront.run_block_band(*args, **kw, rows_per_lane=2)
    want = wavefront.run_block_band_plain(*args, **kw)
    assert _same_band(got, want, args[0].numel(), kw["Cb"])


def test_band_plan_refuses_an_alphabet_no_sm_holds(dev):
    """A 256-symbol table does not fit in an SM's shared memory even once:
    the plan says so before any launch."""
    with pytest.raises(ValueError, match="does not fit on an SM"):
        wavefront.band_plan(dev, 512, 700, 1211, 2, wavefront.BAND_READ_AHEAD, 256)


def test_band_kernel_back_to_back_calls(dev):
    """Calls queued one after another, no wait between them: each has its
    own zeroed row and ticket."""
    cases = [_band_case(37 + i, 500, 600, 512, i % 2, dev, K=2) for i in range(4)]
    got = [wavefront.run_block_band(*a, **kw, rows_per_lane=2) for a, kw in cases]
    torch.cuda.synchronize()
    for (a, kw), g in zip(cases, got):
        assert _same_band(g, wavefront.run_block_band_plain(*a, **kw), a[0].numel(),
                          kw["Cb"])


def test_band_kernel_on_two_streams(dev):
    """Two calls running at once on two streams of one card."""
    cases = [_band_case(41 + i, 3000, 2048, 2048, 0, dev, K=2) for i in range(2)]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    got = []
    for (a, kw), st in zip(cases, streams):
        with torch.cuda.stream(st):
            got.append(wavefront.run_block_band(*a, **kw, rows_per_lane=2))
    torch.cuda.synchronize()
    for (a, kw), g in zip(cases, got):
        assert _same_band(g, wavefront.run_block_band_plain(*a, **kw), a[0].numel(),
                          kw["Cb"])


@pytest.mark.parametrize("C,R", [(700, 900), (1, 1), (129, 1), (3000, 70), (2500, 2500)])
def test_global_end_score_on_the_card_matches_the_host_engine(dev, C, R):
    from aligner_tpu_torch import global_end_score, host

    rng = np.random.default_rng(35)
    q, t = rng.integers(0, 20, C).astype(np.int8), rng.integers(0, 20, R).astype(np.int8)
    ref = host.align_global(q, t, np.array(blosum62()), 11.0, 2.0)
    for tb in (256, 65536):
        got = wavefront.end_score_single_global_diag(q, t, np.array(blosum62()), 11.0, 2.0,
                                                     tb=tb, device=dev)
        assert got == ref.score[R, C]
    assert global_end_score(q, t, blosum62(), 11.0, 2.0, device=dev) == ref.score[R, C]


def _block_case(seed, C, R, cb, tr, d, j, dev, m=None, del_=11, ext=2):
    """The inputs of block (row block ``j``, column block ``d``) of a seeded
    pair on the card, as the column-blocked pipeline builds them from the
    records of its forward fill."""
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    rng = np.random.default_rng(seed)
    m = np.array(blosum62()) if m is None else m
    q = rng.integers(0, m.shape[0], C)
    t = rng.integers(0, m.shape[0], R)
    pp = sp._prep_sharded(-(-C // cb), q, t, m, del_, ext, tr, tr, None, dev)
    _, lb_hist, ckpts = sp._forward(pp, True)
    h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, j, d)
    Cb, tr = pp["Cb"], pp["tr"]  # a block is no taller than the padded target
    assert Cb == cb
    return (pp["q_dev"][d * Cb:(d + 1) * Cb], pp["t_dev"][j * tr:(j + 1) * tr],
            pp["m_dev"], h0, lb, d * Cb, j * tr, C, R)


def _same_block(got, want, rows, cols):
    """Two results of the column-block fill on the block's real rows and
    columns: the last row, the right column, the end cell, the words and the
    checkpoint rows."""
    ok = torch.equal(got[0][:cols], want[0][:cols])
    ok = ok and torch.equal(got[1][:rows], want[1][:rows]) and torch.equal(got[2], want[2])
    if got[3] is not None:
        d, d_p = (wavefront._unpack_dir_words(w.cpu().numpy())[:rows, :cols]
                  for w in (got[3], want[3]))
        ok = ok and np.array_equal(d, d_p)
    if got[4] is not None:
        ok = ok and torch.equal(got[4][:, :cols], want[4][:, :cols])
    return ok


# (C, R, column block, rows of a block, column block d, row block j): x0 and
# y_base zero and not, the block with cell (1,1), the block that owns the end
# cell, C_real on a block's last column (512 = 2 x 256) and on the first
# column of the last block (513)
BLOCK_CASES = [(512, 128, 256, 64, 0, 0), (512, 128, 256, 64, 1, 1),
               (513, 100, 256, 64, 2, 1), (513, 100, 256, 64, 1, 0),
               (700, 300, 512, 128, 1, 2), (300, 70, 512, 64, 0, 1),
               (1, 1, 256, 16, 0, 0)]


@pytest.mark.parametrize("K,tile", [(2, 16), (4, 32), (8, 64), (4, 64)])
@pytest.mark.parametrize("with_dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("C,R,cb,tr,d,j", BLOCK_CASES,
                         ids=[f"{c}x{r}-blk{j}.{d}" for c, r, _, _, d, j in BLOCK_CASES])
def test_block_cs_kernel_matches_plain(dev, C, R, cb, tr, d, j, K, tile, with_dirs):
    args = _block_case(40, C, R, cb, tr, d, j, dev)
    rows = args[1].numel()
    # checkpoint rows inside the call with the scores, as the forward fill asks
    kw = dict(del_=11, ext=2, with_dirs=with_dirs,
              ckpt_every=0 if with_dirs else min(tile, rows))
    got = wavefront.run_block_cs(*args, **kw, tile_rows=min(tile, rows),
                                 cols_per_thread=K)
    torch.cuda.synchronize()
    want = wavefront.run_block_cs_plain(*args, **kw)
    x0, y_base = args[5], args[6]
    assert _same_block(got, want, min(rows, R - y_base), min(args[0].numel(), C - x0))
    assert (got[3] is None) == (not with_dirs) and (got[4] is None) == with_dirs


def test_block_cs_kernel_wide_range_matrix(dev):
    m = np.random.default_rng(41).integers(-30, 30, (4, 4)).astype(np.float64)
    args = _block_case(42, 600, 200, 256, 64, 1, 1, dev, m=m, del_=5, ext=2)
    kw = dict(del_=5, ext=2, with_dirs=True)
    got = wavefront.run_block_cs(*args, **kw)
    assert _same_block(got, wavefront.run_block_cs_plain(*args, **kw), 64, 256)


@pytest.mark.parametrize("C,R", [(600, 300), (300, 600), (1000, 64)])
def test_replay_walk_kernel_with_a_column_base(dev, C, R):
    """Every tile the cursor crosses, kernel against plain: the walk leaves
    a tile by its top or by its left edge and reports a global column; a
    tile the cursor is not in is left alone."""
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    rng = np.random.default_rng(43)
    qn = rng.integers(0, 20, C)
    tn = np.resize(qn, R).copy()
    mask = rng.random(R) < 0.25
    tn[mask] = rng.integers(0, 20, int(mask.sum()))
    pp = sp._prep_sharded(-(-C // 256), qn, tn, np.array(blosum62()), 11, 2, 64, 64, None,
                          dev)
    _, lb_hist, ckpts = sp._forward(pp, True)
    got = wavefront.new_walk(R, C, pp["R_pad"] + pp["C_pad"] + 1, dev)
    want = wavefront.new_walk(R, C, pp["R_pad"] + pp["C_pad"] + 1, dev)
    cy, cx, left = R, C, 0
    while cy > 0 and cx > 0:
        j, d = (cy - 1) // 64, (cx - 1) // 256
        h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, j, d)
        words = sp._block(pp, d, pp["t_dev"][j * 64:(j + 1) * 64], h0, lb, j * 64,
                          with_dirs=True)[3]
        if d:  # the tile to the left is not the cursor's
            wavefront.replay_walk(words, *got, row_base=j * 64, col_base=(d - 1) * 256)
            assert got[0].tolist()[:2] == [cy, cx]
        wavefront.replay_walk(words, *got, row_base=j * 64, col_base=d * 256)
        torch.cuda.synchronize()
        wavefront.replay_walk_plain(words, *want, row_base=j * 64, col_base=d * 256)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        cy, cx, _ = got[0].tolist()
        left += cx == d * 256 and cy > j * 64
    assert left > 0 or C <= 256 or R > C


def test_block_cs_launch_counters_count_kernel_launches(dev):
    """One kernel launch a call of the column-block fill."""
    args = _block_case(44, 512, 128, 256, 64, 1, 1, dev)
    L = wavefront.launches
    before = (L.block_cs, L.block_cs_dirs, L.block_cs_tile_launches, L.row_scan)
    wavefront.run_block_cs(*args, del_=11, ext=2, tile_rows=32, cols_per_thread=4)
    wavefront.run_block_cs(*args, del_=11, ext=2, with_dirs=True, tile_rows=32,
                           cols_per_thread=4)
    assert (L.block_cs, L.block_cs_dirs, L.block_cs_tile_launches, L.row_scan) == \
        (before[0] + 1, before[1] + 1, before[2] + 2, before[3])


# (C, R, column block, rows of a block, column block d, row block j, strip
# rows, columns a lane): x0 > 0 and y_base > 0, cell (1,1), the end cell in
# the block and not, one strip (64 rows), one chunk (256 columns at K 8),
# 16/32/64-row strips
STRIP_BLOCK_CASES = [(1024, 512, 256, 256, 0, 0, 16, 2), (1024, 512, 256, 256, 3, 1, 32, 8),
                     (1000, 512, 512, 512, 1, 0, 64, 4), (900, 300, 256, 64, 2, 3, 64, 4),
                     (700, 700, 256, 128, 1, 2, 16, 8), (200, 300, 256, 64, 0, 2, 32, 8)]


@pytest.mark.parametrize("with_dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("C,R,cb,tr,d,j,tile,K", STRIP_BLOCK_CASES,
                         ids=[f"{c}x{r}-blk{j}.{d}-tr{t}-k{k}"
                              for c, r, _, _, d, j, t, k in STRIP_BLOCK_CASES])
def test_strip_walk_block_cs_matches_plain(dev, C, R, cb, tr, d, j, tile, K, with_dirs):
    args = _block_case(80 + C, C, R, cb, tr, d, j, dev)
    rows = args[1].numel()
    kw = dict(del_=11, ext=2, with_dirs=with_dirs, ckpt_every=0 if with_dirs else tile)
    got = wavefront.run_block_cs(*args, **kw, tile_rows=tile, cols_per_thread=K)
    torch.cuda.synchronize()
    want = wavefront.run_block_cs_plain(*args, **kw)
    assert _same_block(got, want, min(rows, R - args[6]), min(args[0].numel(), C - args[5]))


def test_column_blocked_pair_on_the_card(dev):
    """An 8,192 x 8,192 pair as 4 column blocks of 2,048: strings and
    coordinates equal the single-plane route's, the end score equals the band
    fill's and the rescored path, and the checkpoint rows, every value of
    which has passed through the right columns of the blocks to its left,
    equal the row-scan fill's."""
    from aligner_tpu_torch import align_global, global_end_score
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    rng = np.random.default_rng(45)
    n = 8192
    q = rng.integers(0, 20, n).astype(np.int8)
    t = q.copy()
    mask = rng.random(n) < 0.25
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    m = np.array(blosum62())
    end, qa, ta, coords = sp.sharded_global_align(4, q, t, m, 11.0, 2.0, tb_rows=1024,
                                                  device=dev)
    a = align_global(q, t, m, 11.0, 2.0, device=dev).alignment
    assert np.array_equal(qa, a.query) and np.array_equal(ta, a.target)
    assert coords == a.coords
    assert end == global_end_score(q, t, m, 11.0, 2.0, device=dev)
    assert end == sp.sharded_global_end_score(4, q, t, m, 11.0, 2.0, device=dev)
    assert wavefront.rescore_steps(*wavefront.alignment_steps(qa, ta), q, t, m, 11, 2) == end
    b = align_global(q, t, m, 11.0, 2.0, backend="wavefront_sp", device=dev).alignment
    assert np.array_equal(b.query, qa) and np.array_equal(b.target, ta)
    pp = sp._prep_sharded(4, q, t, m, 11, 2, None, 1024, "pallas", dev)
    assert pp["tr"] == n and pp["tb"] == 1024  # one forward block, 8 checkpoints in it
    _, _, ckpts = sp._forward(pp, True)
    pp1 = wavefront._prep(q, t, m, 11, 2, dev)
    _, _, ck1 = wavefront._scan(pp1, pp["t_dev"], None, 0, with_dirs=False, ckpt_every=1024)
    assert torch.equal(ckpts[:, :n], ck1[:, :n])


def _related(rng, q, share=0.25):
    """``q`` with a share of its positions substituted."""
    t = q.copy()
    mask = rng.random(len(t)) < share
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    return t


def _homolog(seed, n):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, n).astype(np.int8)
    return q, _related(rng, q)


def test_band_engine_on_the_card(dev):
    """The column-blocked pipeline's band engine on an 8,192 x 8,192 pair in 4
    column blocks: its boundary history, checkpoint rows and step stream
    equal the row-scan engine's, each band of its forward fill equals the
    plain band fill, and one launch a band is counted as the pipeline's."""
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    q, t = _homolog(46, 8192)
    m = np.array(blosum62())
    band = sp._prep_sharded(4, q, t, m, 11, 2, None, 1024, "band", dev)
    rows = sp._prep_sharded(4, q, t, m, 11, 2, None, 1024, "pallas", dev)
    assert (band["tr"], band["tb"]) == (1024, 1024) and rows["tb"] == 1024
    L = wavefront.launches
    before = (L.band, L.band_sp, L.band_tile_launches)
    eb, lb_b, ck_b, state_b, steps_b, info = sp._sharded_walk(band)
    assert (L.band, L.band_sp, L.band_tile_launches) == \
        (before[0], before[1] + 32, before[2] + 32) and info["engine"] == "band"
    er, lb_r, ck_r, state_r, steps_r, _ = sp._sharded_walk(rows)
    assert torch.equal(eb, er) and torch.equal(lb_b, lb_r) and torch.equal(ck_b, ck_r)
    assert torch.equal(state_b, state_r) and torch.equal(steps_b, steps_r)
    trace = []
    sp._forward(band, False, trace=trace)
    for args, kw, out in trace[:5] + trace[-3:]:
        want = wavefront.run_block_band_plain(*args, Cb=kw["Cb"], ext=kw["ext"])
        TB = args[0].numel()  # the last row's slots before TB - 1 hold no cell
        assert torch.equal(out[0][TB - 1:], want[0][TB - 1:])
        assert torch.equal(out[1], want[1]) and torch.equal(out[2], want[2])
    a = sp.sharded_global_align(4, q, t, m, 11.0, 2.0, tb_rows=1024, engine="band",
                                device=dev)
    b = sp.sharded_global_align(4, q, t, m, 11.0, 2.0, tb_rows=1024, engine="pallas",
                                device=dev)
    assert a[0] == b[0] == int(er) and a[3] == b[3]
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert sp.sharded_global_end_score(4, q, t, m, 11.0, 2.0, engine="band",
                                       device=dev) == a[0]


def test_lax_engine_on_the_card(dev):
    """BLOSUM62 x 20 with del 220 and ext 40 (entries -80 ... 220): the
    column-block fill equals its plain version on blocks of the pipeline,
    and the alignment is BLOSUM62's with 20 times its end score (scaling
    every score by a positive integer keeps every tie)."""
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    m = np.array(blosum62())
    for d, j, with_dirs in ((1, 1, True), (2, 0, False), (0, 1, True)):
        args = _block_case(47, 700, 300, 256, 128, d, j, dev, m=20 * m, del_=220, ext=40)
        kw = dict(del_=220, ext=40, with_dirs=with_dirs, ckpt_every=0 if with_dirs else 64)
        got = wavefront.run_block_cs(*args, **kw)
        torch.cuda.synchronize()
        want = wavefront.run_block_cs_plain(*args, **kw)
        assert _same_block(got, want, min(128, 300 - args[6]), min(256, 700 - args[5]))
    q, t = _homolog(48, 8192)
    assert sp._prep_sharded(4, q, t, 20 * m, 220, 40, None, 1024, None, dev)["engine"] == "lax"
    a = sp.sharded_global_align(4, q, t, 20 * m, 220, 40, tb_rows=1024, device=dev)
    b = sp.sharded_global_align(4, q, t, m, 11, 2, tb_rows=1024, engine="pallas", device=dev)
    assert a[0] == 20 * b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert sp.sharded_global_end_score(4, q, t, 20 * m, 220, 40, device=dev) == a[0]


def test_engine_pick_on_the_card(dev):
    """With neither ``engine`` nor ``tr`` named the card runs the engine and
    the block height ``auto_shard_config`` picks, the band height capped at
    the replay tile's rows for an alignment; the results are the row-scan
    engine's."""
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    q, t = _homolog(49, 8192)
    m = np.array(blosum62())
    for tb in (None, 1024):
        pp = sp._prep_sharded(4, q, t, m, 11, 2, None, tb, None, dev)
        cap = wavefront.BAND_ROWS if tb is None else tb
        e, tr, _ = sp.auto_shard_config(8192, 8192, 4, max_band_tr=cap)
        assert pp["engine"] == e and (e == "pallas" or pp["tr"] == tr)
    a = sp.sharded_global_align(4, q, t, m, 11.0, 2.0, tb_rows=1024, device=dev)
    b = sp.sharded_global_align(4, q, t, m, 11.0, 2.0, tb_rows=1024, engine="pallas",
                                device=dev)
    assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert sp.sharded_global_end_score(4, q, t, m, 11.0, 2.0, device=dev) == a[0]


# the walker core of both walks (csrc/walk_core.cuh) on raw codes: the cases
# of tests/test_torch_walk_host.py on the card, the paths' sizes, and walks
# forced through many refills


def _diagonal(rng, shape, p_diag=0.8):
    return rng.choice([2, 0, 1], size=shape, p=[p_diag, (1 - p_diag) / 2, (1 - p_diag) / 2])


def _replay_both(dev, words, state, steps, row_base, col_base=0, span=None,
                 monkeypatch=None):
    """The kernel on the card (a ring of rows of `span` columns when given)
    and the plain version on the host, from copies of one cursor and stream;
    returns the kernel's state and stats."""
    if span is not None:
        monkeypatch.setattr(wavefront, "REPLAY_SPAN", span)
    got = state.to(dev), steps.to(dev)
    want = state.clone(), steps.clone()
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    wavefront.replay_walk(words.to(dev), *got, row_base=row_base, col_base=col_base,
                          stats=stats)
    torch.cuda.synchronize()
    wavefront.replay_walk_plain(words, *want, row_base=row_base, col_base=col_base)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    return got[0].cpu().tolist(), stats.cpu().tolist()


def _codes_case(name, rng):
    """(codes, cy, cx, n0, stream words, span) of a named W case."""
    if name == "diagonal":
        return _diagonal(rng, (320, 400)), 320, 400, 0, 46, 512
    if name == "top-run":
        c = np.full((128, 64), 2)
        c[40:110, 50] = 0
        return c, 110, 51, 0, 13, 32
    if name == "left-run":
        c = np.full((64, 512), 2)
        c[37, 100:400] = 1
        return c, 38, 400, 0, 37, 32
    if name == "budget":
        return _diagonal(rng, (160, 160)), 160, 160, 5, 3, 64
    if name == "beginning":
        c = np.full((48, 64), 2)
        c[30, 40] = 3
        return c, 40, 50, 0, 7, 32
    raise KeyError(name)


@pytest.mark.parametrize("name", ["diagonal", "top-run", "left-run", "budget", "beginning"])
def test_replay_walk_kernel_on_raw_codes(dev, monkeypatch, name):
    rng = np.random.default_rng(len(name))
    codes, cy, cx, n0, n_words, span = _codes_case(name, rng)
    state = torch.tensor([cy, cx, n0], dtype=torch.int32)
    # a stream from new_walk, its first word holding codes of an earlier block
    steps = torch.full((n_words,), -1, dtype=torch.int32)
    steps[0] = int(rng.integers(-2**31, 2**31))
    words = device_walk.pack_codes(codes, 16)
    st, stats = _replay_both(dev, words, state, steps, 0, span=span, monkeypatch=monkeypatch)
    if name == "left-run":
        assert stats[1] >= 9 and st[:2] == [0, 62]


@pytest.mark.parametrize("span", [32, 64, 512, 4096])
def test_replay_walk_kernel_at_a_paths_width(dev, monkeypatch, span):
    """4,096 rows by 8,192 columns at a column base, a near-diagonal path:
    spans that refill and that do not, and a ring that needs the opt-in
    shared memory (rows of 4,096 columns, 64 KiB)."""
    rng = np.random.default_rng(span)
    R, C, col_base = 4096, 8192, 393_216
    words = device_walk.pack_codes(_diagonal(rng, (R, C), 0.75), 16)
    state = torch.tensor([R, col_base + C - 100, 0], dtype=torch.int32)
    steps = torch.full((-(-(R + C + 1) // 16),), -1, dtype=torch.int32)
    st, stats = _replay_both(dev, words, state, steps, 0, col_base, span=span,
                             monkeypatch=monkeypatch)
    assert st[0] == 0 or st[1] == col_base
    assert stats[0] >= (R - st[0]) // 16


def test_replay_walk_kernel_through_many_refills(dev, monkeypatch):
    """LEFT runs of 200 columns every 16 rows under a 32-column span."""
    rng = np.random.default_rng(31)
    R, C = 512, 8192
    codes = _diagonal(rng, (R, C), 0.9)
    for y in range(5, R, 16):
        codes[y, :] = np.where(np.arange(C) % 300 < 200, 1, codes[y, :])
    state = torch.tensor([R, C, 0], dtype=torch.int32)
    steps = torch.full((-(-(R + C + 1) // 16),), -1, dtype=torch.int32)
    words = device_walk.pack_codes(codes, 16)
    st, stats = _replay_both(dev, words, state, steps, 0, span=32, monkeypatch=monkeypatch)
    assert stats[1] >= 20


def _walk_both(dev, words, sy, sx, S, mode, monkeypatch, span):
    monkeypatch.setattr(device_walk, "WALK_SPAN", span)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    got = device_walk.walk(words.to(dev), sy.to(dev), sx.to(dev), S=S, mode=mode,
                           stats=stats)
    torch.cuda.synchronize()
    want = device_walk.walk_plain(words, sy, sx, S=S, mode=mode)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    return stats.cpu().tolist()


@pytest.mark.parametrize("span", [16, 128])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("B,R8,C", [(53, 48, 70), (1024, 48, 400), (7, 16, 3000)],
                         ids=["odd-starts", "many", "refills"])
def test_walk_kernel_on_raw_codes(dev, monkeypatch, mode, B, R8, C, span):
    """Any codes (Beginning too, rarely), starts on the borders, inside and
    off the plane (the index clip), B not a multiple of the warps, S not a
    multiple of 16; a thousand problems; planes wider than the span with
    long LEFT runs (refills); rows of 16 columns, which refill on every
    plane, and of 128 (C = 70 copies 4 bytes at a time, the others 16)."""
    rng = np.random.default_rng(B + C)
    codes = rng.choice([0, 1, 2, 3], size=(B, R8, C), p=[0.1, 0.1, 0.799, 0.001])
    if C > 1000:
        codes[:, :, 50:] = 1
    words = device_walk.pack_codes(codes, 8)
    sy = rng.integers(1, R8 + 1, B).astype(np.int32)
    sx = rng.integers(1, C + 1, B).astype(np.int32)
    if B > 10:
        sy[:9] = [0, 0, 0, 30, R8 + 3, R8 + 9, 20, R8 + 1, -1]
        sx[:9] = [0, 25, 1, 0, 30, C + 5, C + 17, C + 1, 5]
    S = R8 + C + 1 + (3 if C < 100 else 0)
    stats = _walk_both(dev, words, torch.from_numpy(sy), torch.from_numpy(sx), S, mode,
                       monkeypatch, span)
    if C > 1000:
        assert stats[1] >= B * 10


# --- the heuristic population ---------------------------------------------


@pytest.mark.parametrize("case", sorted(WALK_COUNT_CASES))
def test_counting_walk_matches_plain(dev, case):
    """The counting walk on the walk host test's cases (words of the plain
    fill, the population's shape among them, done, stale and off-plane
    members, V = 1, 4, 24 and 55, a plane whose ring is smaller than its
    counts, walks that take the whole step budget), exactly, one launch a
    call; its stats are the walk's."""
    args, _ = walk_count_case(case)
    words, sy, sx, q, t, alive, V, S = args
    on = [a.to(dev) for a in (words, sy, sx, q, t, alive)]
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    walk_stats = torch.zeros(3, dtype=torch.int32, device=dev)
    before = device_walk.launches.walk_count
    got = device_walk.walk_counts(*on, V, S=S, stats=stats)
    torch.cuda.synchronize()
    assert device_walk.launches.walk_count == before + 1
    assert torch.equal(got.cpu(), device_walk.walk_counts_plain(*args[:-1], S=S))
    device_walk.walk(*on[:3], S=S, mode="local", stats=walk_stats)
    assert torch.equal(stats, walk_stats)


def test_counting_walk_refuses_counts_that_do_not_fit(dev):
    """V = 250: one warp's counts (250 KB) exceed a block's shared memory,
    so the counting walk raises ValueError and launches nothing."""
    rng = np.random.default_rng(9)
    B, R8, C, V = 8, 16, 24, 250
    words = device_walk.pack_codes(rng.integers(0, 3, (B, R8, C)), 8).to(dev)
    sy = torch.full((B,), R8, dtype=torch.int32, device=dev)
    sx = torch.full((B,), C, dtype=torch.int32, device=dev)
    q = torch.as_tensor(rng.integers(0, V, (B, C)), dtype=torch.int32, device=dev)
    t = torch.as_tensor(rng.integers(0, V, (B, R8)), dtype=torch.int32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    before = device_walk.launches.walk_count
    with pytest.raises(ValueError):
        device_walk.walk_counts(words, sy, sx, q, t, alive, V, S=R8 + C + 1)
    assert device_walk.launches.walk_count == before


@pytest.mark.parametrize("V", [24, 4])
def test_transform_on_the_card_is_numpys(dev, V):
    """The batched float64 transform on the card equals numpy's member by
    member (NaN where numpy raises), on {-1, 0, 1} matrices and counts."""
    rng = np.random.default_rng(V)
    freqs = rng.random(V)
    freqs /= freqs.sum()
    mats = rng.integers(-1, 2, (200, V, V)).astype(np.float64) * rng.random((200, 1, 1))
    mats[100:] = rng.poisson(1.0, (100, V, V)) + np.eye(V)
    for kd, r2 in ((0.0, 1e5), (2.0, 1e2), (2.0, 1e4)):
        got = transform_matrix_torch(torch.as_tensor(mats, device=dev), kd, r2,
                                     freqs).cpu().numpy()
        for m in range(len(mats)):
            try:
                want = transform_matrix(mats[m], kd, r2, freqs)
            except port.WrongMatrixSpecified:
                assert np.isnan(got[m]).all()
                continue
            assert np.array_equal(got[m], want), (kd, r2, m)


def test_population_on_the_card_is_the_cpus(dev):
    """The population's loop on the kernels equals the loop on their plain
    versions, member by member, and launches the fill and the counting walk
    once an iteration."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 24, 90).astype(np.int8)
    t = q.copy()
    t[rng.integers(1, 90, 20)] = rng.integers(0, 24, 20)
    mats = rng.integers(-1, 2, (16, 24, 24)).astype(np.float64)
    freqs = rng.random(24)
    freqs /= freqs.sum()
    h = port.Heuristics(kd=0.0, r_squared=1e5, frequencies=freqs)
    port.warmup_population(q, t, 16, 11.0, 11.0)
    before = (dp_fill.launches.dirs, device_walk.launches.walk,
              device_walk.launches.walk_count)
    got = port.heuristic_align_population(q, t, mats, 11.0, 11.0, h)
    # the final batch_align fills and walks as many shards as it has
    iters = (dp_fill.launches.dirs - before[0]) - (device_walk.launches.walk - before[1])
    assert iters >= 1 and device_walk.launches.walk_count - before[2] == iters
    want = port.heuristic_align_population(q, t, mats, 11.0, 11.0, h, device="cpu")
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.alignment.f == b.alignment.f
            assert np.array_equal(a.alignment.query, b.alignment.query)
            assert np.array_equal(a.alignment.target, b.alignment.target)
            assert a.alignment.coords == b.alignment.coords
            assert np.array_equal(a.matrix, b.matrix)


def test_population_refuses_codes_outside_the_matrices_before_a_launch(dev):
    """An X (code 23) in the target against (M, 20, 20) matrices raises
    ValidationError with no fill, walk or counting walk launched."""
    rng = np.random.default_rng(20)
    q = rng.integers(0, 20, 40).astype(np.int8)
    t = q.copy()
    t[17] = port.Protein.encode("X")[0]
    mats = rng.integers(-1, 2, (4, 20, 20)).astype(np.float64)
    freqs = np.full(20, 0.05)
    h = port.Heuristics(kd=0.0, r_squared=1e5, frequencies=freqs)
    def launches():
        return (dp_fill.launches.dirs, device_walk.launches.walk,
                device_walk.launches.walk_count)

    before = launches()
    with pytest.raises(port.ValidationError):
        port.heuristic_align_population(q, t, mats, 11.0, 11.0, h)
    torch.cuda.synchronize()
    assert launches() == before


# --------------------------------------------------------------------------
# the score plane (K2/K3 with PLANE), keep_planes and the host walks
# --------------------------------------------------------------------------


def _equal_with_plane(a, b):
    _equal(a, b)
    assert a.plane.dtype == b.plane.dtype and torch.equal(a.plane, b.plane)


PLANE_KINDS = ["local", "global", "batched-local", "batched-global", "pwm-shared",
               "pwm-batched"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", PLANE_KINDS)
@pytest.mark.parametrize("dense", [False, True], ids=["ragged", "dense"])
def test_fill_kernel_plane_matches_plain(dev, dtype, kind, dense):
    """The score plane beside the words, bit for bit, in pair mode (shared
    and per-problem matrices) and PWM mode; one launch counted a plane."""
    rng = np.random.default_rng(2 * PLANE_KINDS.index(kind) + int(dense))
    planes = dp_fill.launches.planes
    if kind.startswith("pwm"):
        B, R, W = 300, 45, 37
        q = torch.as_tensor(rng.integers(0, 4, (B, R)), dtype=torch.int32, device=dev)
        ql = torch.as_tensor(np.full(B, R) if dense else rng.integers(0, R + 1, B),
                             dtype=torch.int32, device=dev)
        pwm = rng.normal(0.0, 3.0, (B, 4, W) if kind == "pwm-batched" else (4, W))
        if dtype == torch.float32:
            pwm = np.round(pwm)
        pwm = torch.as_tensor(pwm, dtype=dtype, device=dev)
        kw = dict(with_dirs=True, with_scores_plane=True)
        got = dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, **kw)
        want = fill_pwm_batch(q, ql, pwm, 6.5, 1.75, **kw)
    else:
        q, ql, t, tl = _batch(7, 300, 40, 37, dense, dev)
        if kind.startswith("batched"):
            m = rng.normal(0.0, 3.0, (300, V, V))
            if dtype == torch.float32:
                m = np.round(m)
        else:
            m = np.array(blosum62())
        m = torch.as_tensor(m, dtype=dtype, device=dev)
        kw = dict(mode=kind.split("-")[-1], with_dirs=True, with_scores_plane=True)
        got = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, **kw)
        want = fill_batch(q, ql, t, tl, m, 11.0, 2.0, **kw)
    torch.cuda.synchronize()
    assert dp_fill.launches.planes == planes + 1
    _equal_with_plane(got, want)


@pytest.mark.parametrize("where", [0, 8], ids=["at", "spilled"])
def test_fill_kernel_plane_around_the_rows_on_chip(dev, where):
    B, C = 40, 5
    rng = np.random.default_rng(12)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float64, device=dev)
    R8 = _rows_on_chip_at_most(m, B) - 1 + where
    q = torch.as_tensor(rng.integers(0, V, (B, C)), dtype=torch.int32, device=dev)
    ql = torch.as_tensor(rng.integers(0, C + 1, B), dtype=torch.int32, device=dev)
    t = torch.as_tensor(rng.integers(0, V, (B, R8)), dtype=torch.int32, device=dev)
    tl = torch.as_tensor(np.clip(R8 - rng.integers(0, 20, B), 0, R8), dtype=torch.int32,
                         device=dev)
    for mode in ("local", "global"):
        kw = dict(mode=mode, with_dirs=True, with_scores_plane=True)
        got = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, **kw)
        torch.cuda.synchronize()
        _equal_with_plane(got, fill_batch(q, ql, t, tl, m, 11.0, 2.0, **kw))


@pytest.mark.parametrize("mode", ["global", "local"])
def test_keep_planes_on_the_card_matches_the_host_engine(dev, mode):
    """A homologous pair with its planes: strings, coords, f, the score
    plane (in the fill's dtype, compared as float64) and the directions
    against native C++; one plane launch, no walk kernel."""
    rng = np.random.default_rng(21)
    q = rng.integers(0, 24, 700).astype(np.int8)
    t = np.resize(q, 650).copy()
    t[rng.random(650) < 0.25] = rng.integers(0, 24, 1)
    fn = port.align_global if mode == "global" else port.align_local
    planes, walks = dp_fill.launches.planes, device_walk.launches.walk
    replays = wavefront.launches.replay_walk
    got = fn(q, t, blosum62(), 11.0, 2.0, keep_planes=True)
    want = fn(q, t, blosum62(), 11.0, 2.0, keep_planes=True, device="host")
    assert dp_fill.launches.planes == planes + 1
    assert (device_walk.launches.walk, wavefront.launches.replay_walk) == (walks, replays)
    assert got.score.dtype == np.float32  # integral scoring on the card
    assert np.array_equal(got.score.astype(np.float64), want.score)
    assert np.array_equal(got.directions, want.directions)
    assert np.array_equal(got.alignment.query, want.alignment.query)
    assert np.array_equal(got.alignment.target, want.alignment.target)
    assert got.alignment.coords == want.alignment.coords
    assert got.alignment.f == want.alignment.f


def test_simple_aligners_on_the_card(dev):
    for cls in (port.SimpleGlobalAligner, port.SimpleLocalAligner):
        a = cls.from_str_seqs("HEAGAWGHEE", "PAWHEAE")
        got = a.perform_alignment(11.0, 2.0, blosum62())
        want = a.perform_alignment(11.0, 2.0, blosum62(), device="host")
        assert np.array_equal(got.score.astype(np.float64), want.score)
        assert np.array_equal(got.directions, want.directions)
        assert got.alignment.coords == want.alignment.coords
        assert got.alignment.f == want.alignment.f


def _counts():
    return (device_walk.launches.walk, wavefront.launches.replay_walk)


def _same_pairs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x.alignment.query, y.alignment.query)
            assert np.array_equal(x.alignment.target, y.alignment.target)
            assert x.alignment.coords == y.alignment.coords
            assert x.alignment.f == y.alignment.f


@pytest.mark.parametrize("mode", ["local", "global"])
def test_host_walk_on_the_card_matches_the_device_walk(dev, mode):
    """``walk="host"`` equals the default walk on the batch, the PWM batch,
    a chunked pair and the column-blocked pipeline, and launches neither K4
    nor W."""
    rng = np.random.default_rng(31)
    qs = [rng.integers(0, 24, rng.integers(20, 120)).astype(np.int8) for _ in range(200)]
    ts = [np.resize(q, len(q) + 5).copy() for q in qs]
    dev_walk = port.batch_align(qs, ts, blosum62(), 11.0, 2.0, mode=mode,
                                with_alignments=True)
    before = _counts()
    host = port.batch_align(qs, ts, blosum62(), 11.0, 2.0, mode=mode,
                            with_alignments=True, walk="host")
    assert _counts() == before
    _same_pairs(host, dev_walk)
    pwm = rng.normal(1.0, 3.0, (4, 30))
    q4 = [rng.integers(0, 4, rng.integers(10, 60)).astype(np.int8) for _ in range(100)]
    a = port.batch_align_pwm(q4, pwm, 3.0, 1.0, with_alignments=True)
    before = _counts()
    b = port.batch_align_pwm(q4, pwm, 3.0, 1.0, with_alignments=True, walk="host")
    assert _counts() == before
    for x, y in zip(a, b):
        assert np.array_equal(x.alignment.numbered, y.alignment.numbered)
        assert np.array_equal(x.alignment.query, y.alignment.query)
        assert x.alignment.coords == y.alignment.coords and x.alignment.f == y.alignment.f


def test_host_walk_of_the_huge_and_column_blocked_pairs_on_the_card(dev):
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    rng = np.random.default_rng(32)
    q = rng.integers(0, 24, 3000).astype(np.int8)
    t = np.resize(q, 3300).copy()
    t[rng.random(3300) < 0.25] = rng.integers(0, 24, 1)
    a = wavefront.align_single_global_chunked(q, t, blosum62(), 11.0, 2.0, tb_rows=512)
    before = _counts()
    b = wavefront.align_single_global_chunked(q, t, blosum62(), 11.0, 2.0, tb_rows=512,
                                              walk="host")
    assert _counts() == before
    assert a[0] == b[0] and a[3] == b[3]
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    c = sp.sharded_global_align(3, q, t, blosum62(), 11.0, 2.0, tb_rows=512)
    before = _counts()
    d = sp.sharded_global_align(3, q, t, blosum62(), 11.0, 2.0, tb_rows=512, walk="host")
    assert _counts() == before
    assert c[0] == d[0] == a[0]
    assert np.array_equal(c[1], d[1]) and np.array_equal(d[1], a[1])
    assert np.array_equal(c[2], d[2]) and np.array_equal(d[2], a[2])


def _shard_counts():
    return (dp_fill.launches.scores, dp_fill.launches.dirs, device_walk.launches.walk)


def _two_shards(monkeypatch):
    from aligner_tpu_torch import align

    monkeypatch.setattr(align, "_shard_devices", lambda device: [torch.device("cuda", 0)] * 2)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_two_shards_of_one_card_equal_the_unsharded_fill(dev, monkeypatch, mode):
    """The auto-shard's fills on two shards of the one card (a ragged batch
    of 301, padded to 302): scores bit for bit, alignments equal, and each
    shard one launch of the fill and one of the walk."""
    rng = np.random.default_rng(40)
    qs = [rng.integers(0, V, int(rng.integers(1, 90))) for _ in range(301)]
    ts = [rng.integers(0, V, int(rng.integers(1, 90))) for _ in range(301)]
    kw = dict(mode=mode)
    one = port.batch_align(qs, ts, blosum62(), 11.0, 2.0, **kw)
    one_aln = port.batch_align(qs, ts, blosum62(), 11.0, 2.0, with_alignments=True, **kw)
    _two_shards(monkeypatch)
    before = _shard_counts()
    two = port.batch_align(qs, ts, blosum62(), 11.0, 2.0, **kw)
    two_aln = port.batch_align(qs, ts, blosum62(), 11.0, 2.0, with_alignments=True, **kw)
    assert tuple(a - b for a, b in zip(_shard_counts(), before)) == (2, 2, 2)
    for f in ("fmax", "fy", "fx", "end"):
        assert np.array_equal(getattr(one, f), getattr(two, f))
    for x, y in zip(one_aln, two_aln):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x.alignment.query, y.alignment.query)
            assert np.array_equal(x.alignment.target, y.alignment.target)
            assert x.alignment.coords == y.alignment.coords and x.alignment.f == y.alignment.f


def test_two_shards_of_one_card_scan_and_pwm(dev, monkeypatch):
    """The repeat scan and the PWM batch with alignments on two shards of
    the one card equal the one-shard runs."""
    from aligner_tpu_torch.repeat import engine

    rng = np.random.default_rng(41)
    seq = rng.integers(0, 4, 5000).astype(np.int8)
    pwm = rng.normal(0.0, 2.0, (4, 40))
    opts = engine.SearchOptions(repeat_length=40, query_offset=10, deletions=5.0,
                                extension=2.0)
    wins = engine.windows_of(len(seq), opts, opts.query_offset)
    qs = [seq[a:b] for a, b in wins[:97]]
    one = engine._scan_scores(seq, wins, pwm, opts, chunk=128)
    one_aln = port.batch_align_pwm(qs, pwm, 5.0, 2.0, with_alignments=True)
    _two_shards(monkeypatch)
    assert np.array_equal(one, engine._scan_scores(seq, wins, pwm, opts, chunk=128))
    for x, y in zip(one_aln, port.batch_align_pwm(qs, pwm, 5.0, 2.0, with_alignments=True)):
        assert np.array_equal(x.alignment.numbered, y.alignment.numbered)
        assert np.array_equal(x.alignment.query, y.alignment.query)
        assert x.alignment.coords == y.alignment.coords and x.alignment.f == y.alignment.f


def test_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two ranks (gloo), each with the card twice as its shards: what they
    gather equals the one-process steps on the card; the statistics to a
    relative 1e-12."""
    from torch_multihost_proc import POP_B, UNEVEN, one_process, run_ranks

    ranks = run_ranks(tmp_path / "ranks.json", "cuda:0", timeout=300)
    one = one_process("cuda:0")
    for r in ranks:
        for got, want in zip(r["scores"], one["scores"]):
            assert np.array_equal(np.asarray(got), want.cpu().numpy())
        for got, want in zip(r["uneven_scores"], one["scores"]):
            assert np.array_equal(np.asarray(got), want.cpu().numpy()[:UNEVEN])
        best, win = one["population"]
        assert np.array_equal(np.asarray(r["population"][0]), best.cpu().numpy()[:POP_B])
        assert np.array_equal(np.asarray(r["population"][1]), win.cpu().numpy()[:POP_B])
    assert ranks[0]["scan"] == ranks[1]["scan"]
    scores, z, mean, std = (a.cpu().numpy() for a in one["scan"])
    assert np.array_equal(np.asarray(ranks[0]["scan"]["scores"]), scores[:UNEVEN])
    np.testing.assert_allclose(ranks[0]["scan"]["z"], z[:UNEVEN], rtol=1e-12, atol=0)
    np.testing.assert_allclose([ranks[0]["scan"]["mean"], ranks[0]["scan"]["std"]],
                               [mean, std], rtol=1e-12, atol=0)


CARD_PAIR = ((65536, 4096, None),)  # 2 column blocks of 32,768 on 2 slots


def _launch_counts():
    L = wavefront.launches
    return (L.block_cs, L.block_cs_dirs, L.band_sp, L.replay_walk)


def test_column_blocked_pipeline_on_two_slots_of_the_card(dev):
    """The pipeline on a mesh of the card twice, a (2, 1) grid (the right
    boundary copied to the second slot, which is the same card): every
    engine's end score and both walks' alignments of a 65,536 x 4,096 pair
    equal the integer form's on the same 2 blocks, with the same launches."""
    from aligner_tpu_torch.parallel import mesh as pm
    from torch_multihost_proc import wavefront_runs

    before = _launch_counts()
    one = wavefront_runs(2, CARD_PAIR, device=dev)
    mid = _launch_counts()
    two = wavefront_runs(pm.make_mesh(2, devices=[torch.device("cuda", 0)] * 2), CARD_PAIR)
    after = _launch_counts()
    assert two == one
    assert [b - a for a, b in zip(before, mid)] == [b - a for a, b in zip(mid, after)]
    assert all(b > a for a, b in zip(before, mid))


def test_column_blocked_pipeline_across_two_gloo_ranks_on_the_card(dev, tmp_path):
    """Two ranks (gloo) of one slot each, both on the card: the boundaries
    and the trace records cross the ranks through the CPU; each rank's
    results equal the other's and the integer form's on the 65,536 x 4,096
    pair."""
    from torch_multihost_proc import run_ranks, wavefront_runs

    ranks = run_ranks(tmp_path / "ranks.json", "cuda:0", shards=1, timeout=300,
                      pairs=CARD_PAIR)
    one = wavefront_runs(2, CARD_PAIR, device=dev)
    assert ranks[0]["wavefront"] == ranks[1]["wavefront"] == one
    assert "cuda/wavefront-sp-handoff" in ranks[1]["wavefront_counters"]


def test_score_pass_overlaps_the_buckets_and_waits_once(dev, monkeypatch):
    """The search's score pass on the card: the tallest bucket's fill
    (6 records of 2,400 rows) still runs when the next bucket's starts, on
    the profiler's device timeline; the host synchronises the card once for
    the pass, which the counters record as one launch; and every bucket's
    scores equal its own ``batch_align``'s, bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from aligner_tpu_torch import align, observability
    from aligner_tpu_torch.search import length_buckets

    rng = np.random.default_rng(25)
    q = rng.integers(0, 20, 1200).astype(np.int8)
    lens = [2400] * 6 + list(rng.integers(200, 260, 400)) + list(rng.integers(20, 40, 400))
    db = [rng.integers(0, 20, int(n)).astype(np.int8) for n in lens]
    order = sorted(length_buckets(lens), key=lambda b: lens[b[-1]], reverse=True)
    assert len(order) >= 3
    want = [port.batch_align([q] * len(b), [db[i] for i in b], blosum62(), 11.0, 2.0,
                             device=dev) for b in order]
    syncs = []
    real = torch.cuda.synchronize
    before = observability.counters.snapshot().get("cuda/local")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: (syncs.append(device), real(device))[1])
        with align.ScorePass(q, blosum62(), 11.0, 2.0, device=dev) as fills:
            for b in order:
                fills.enqueue(align.TargetBucket([db[i] for i in b]))
            got = fills.read()
        monkeypatch.undo()
    after = observability.counters.snapshot()["cuda/local"]
    assert len(syncs) == 1
    assert after.launches - (before.launches if before else 0) == 1
    assert fills.in_flight == len(fills.streams) == len(order)
    for res, w in zip(got, want):
        for f in ("fmax", "fy", "fx", "end"):
            assert np.array_equal(getattr(res, f), getattr(w, f)), f
    k1 = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and "dp_fill_kernel" in e.name())
    assert len(k1) == len(order)
    assert k1[1][0] < k1[0][1]  # the second launch starts before the tallest ends


def test_a_second_search_sends_the_card_its_query_row_alone(dev, monkeypatch):
    """The database kept on the card: the second search against the same
    records reads ``resident`` 1, its score pass's ``fill.upload`` spans
    send each card the query row and the matrix and nothing of the
    database, and its hits equal the first search's."""
    from torch.profiler import ProfilerActivity, profile

    from aligner_tpu_torch import observability, search

    monkeypatch.setattr(search, "_resident", search._Resident())
    rng = np.random.default_rng(26)
    lens = list(rng.integers(30, 400, 3000)) + [1500] * 4
    db = [rng.integers(0, 20, int(n)).astype(np.int8) for n in lens]
    q = rng.integers(0, 20, 700).astype(np.int8)
    db[100] = q.copy()

    def traced():
        observability.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            hits = port.search_database(q, db, blosum62(), 11.0, 2.0, k=5, device=dev)
        log = observability.spans()
        observability.clear_spans()
        return [(h.index, h.score, h.coords, h.query_aligned.tolist(),
                 h.target_aligned.tolist()) for h in hits], log

    def pass_uploads(log):
        by_id = {s.id: s for s in log}

        def in_bucket(s):
            while s.parent is not None:
                s = by_id[s.parent]
                if s.name == "search.bucket":
                    return True
            return False

        (root,) = [s for s in log if s.parent is None]
        return root.counts["resident"], [s.counts for s in log
                                         if s.name == "fill.upload" and in_bucket(s)]

    first, log1 = traced()
    second, log2 = traced()
    assert second == first and first[0][0] == 100
    resident1, up1 = pass_uploads(log1)
    resident2, up2 = pass_uploads(log2)
    assert (resident1, resident2) == (0, 1)
    # the first pass sent the database: 704 int32 codes a row at least
    assert sum(u["h2d_bytes"] for u in up1) > 3000 * 704
    # the query row (704 int32 codes) and the float32 matrix, once a card
    assert sum(u["query_bytes"] > 0 for u in up2) >= 1
    assert all(u["h2d_bytes"] == (u["query_bytes"] + 24 * 24 * 4 if u["query_bytes"] else 0)
               and u["query_bytes"] in (0, 704 * 4) for u in up2)


def test_spans_leave_no_copy_on_the_device_timeline(dev):
    """The program's spans are recorded under a profiler that traces the
    card, and none of them has a copy among the device's events (a copy
    would read as device work to whoever sums device time), while a
    user-scope ``record_function`` does get one."""
    from torch.profiler import ProfilerActivity, profile

    from aligner_tpu_torch import observability

    rng = np.random.default_rng(21)
    db = [rng.integers(0, 20, int(n)).astype(np.int8) for n in rng.integers(30, 300, 300)]
    q = rng.integers(0, 20, 120).astype(np.int8)
    port.search_database(q, db, blosum62(), 11.0, 2.0, k=3, device=dev)
    observability.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("user-scope"):
            port.search_database(q, db, blosum62(), 11.0, 2.0, k=3, device=dev)
            torch.cuda.synchronize()
    names = {s.name for s in observability.spans()}
    observability.clear_spans()
    assert {"search", "batch", "fill", "fill.upload", "fill.launch"} <= names
    on_card = {e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert "user-scope" in on_card and not names & on_card


@pytest.mark.parametrize("aligned", [True, False], ids=["align", "score"])
def test_pair_spans_leave_no_copy_on_the_device_timeline(dev, aligned, monkeypatch):
    """A DNA pair on the column-blocked pipeline (three column blocks of
    4,096, replay tiles of 1,024 rows) records its ``pair`` spans under a
    profiler that traces the card, and none of them has a copy among the
    device's events, while the pipeline's kernels do run there."""
    from torch.profiler import ProfilerActivity, profile

    from aligner_tpu_torch import observability
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")
    monkeypatch.setattr(sp, "CB_COLS", 4096)
    monkeypatch.setitem(sp.sharded_global_align.__kwdefaults__, "tb_rows", 1024)
    rng = np.random.default_rng(22)
    q = rng.integers(0, 4, 12000).astype(np.int8)
    t = q.copy()
    sub = rng.random(len(t)) < 0.05
    t[sub] = rng.integers(0, 4, int(sub.sum()))
    dna = np.where(np.eye(4, dtype=bool), 1.0, -3.0)

    def call():
        if aligned:
            return port.align_global(q, t, dna, 5.0, 2.0, alphabet=port.DNA,
                                     backend="wavefront_sp", device=dev)
        return port.global_end_score(q, t, dna, 5.0, 2.0, alphabet=port.DNA,
                                     backend="wavefront_sp", device=dev)

    call()
    observability.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {s.name for s in observability.spans()}
    observability.clear_spans()
    want = ({"pair", "pair.forward", "pair.gather", "pair.replay", "pair.walk", "pair.decode"}
            if aligned else {"pair", "pair.forward"})
    assert names == want
    on_card = {e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert any("fill_strips_kernel" in n or "band_walk_kernel" in n for n in on_card)
    assert not names & on_card


# --------------------------------------------------------------------------
# the main path through the entry points a user calls: the golden fixtures,
# the p-value, the three CLIs, the service and the full-mode batch, against
# the frozen fixtures, native C++, the host engine and the CLIs on the CPU
# --------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "fixtures" / "examples_golden.json").read_text())


def _example(name):
    """The two records of ``examples/<name>.fasta`` as protein codes (the
    DNA example too, as the golden fixtures read it)."""
    recs = read_fasta_file(str(ROOT / "examples" / f"{name}.fasta"))
    return tuple(port.Protein.encode(r.seq, strict=True) for r in recs[:2])


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _fasta(path, records):
    path.write_text("".join(f">{name}\n{seq}\n" for name, seq in records))
    return str(path)


@pytest.mark.parametrize("example,key", [(e, k) for e in sorted(GOLDEN) for k in GOLDEN[e]])
def test_golden_fixtures_on_the_card(dev, example, key):
    """Every frozen golden case through ``batch_align`` and through the
    simple aligner of its mode, both with ``device=None`` (the card): f,
    coordinates and both strings equal the fixture, and the simple
    aligner's score plane (as float64) and directions equal native C++."""
    q, t = _example(example)
    mode, d, e = key.split("_")
    d, e = float(d[1:]), float(e[1:])
    (r,) = port.batch_align([q], [t], blosum62(), d, e, mode=mode, with_alignments=True,
                            device=None)
    cls = port.SimpleGlobalAligner if mode == "global" else port.SimpleLocalAligner
    simple = cls.from_seqs(q, t).perform_alignment(d, e, blosum62(), device=None)
    want = GOLDEN[example][key]
    for a in (r.alignment, simple.alignment):
        assert a.f == want["f"]
        assert tuple(map(tuple, a.coords)) == tuple(map(tuple, want["coords"]))
        assert port.Protein.decode(a.query) == want["query"]
        assert port.Protein.decode(a.target) == want["target"]
    plane, dirs = native.fill(q, t, np.array(blosum62()), d, e, mode)
    assert np.array_equal(simple.score.astype(np.float64), plane)
    assert np.array_equal(simple.directions, dirs)


def _native_fit(q, t, f, del_, ext, m, shuffles, dev):
    """K1's scores of ``shuffles`` (scores only, as ``calculate_p_value``
    runs them) held against native C++ scores, bit for bit; returns the
    p-value of the fit on the native scores, ``f`` the initial score."""
    got = port.batch_align([q] * len(shuffles), shuffles, m, del_, ext, track_argmax=False,
                           device=dev).fmax.astype(np.float64)
    want = np.array([native.local_max_score_stream(q, s, m, del_, ext)[0] for s in shuffles])
    assert np.array_equal(got, want)
    scores = np.concatenate([[f], want])
    lengths = np.concatenate([[len(t)], [len(s) for s in shuffles]])
    return port.statistics.calculate_distribution_params(
        len(q), lengths, scores).get_p_value(len(q), len(t), f)


def test_p_value_on_the_card_is_the_native_fit(dev):
    """``calculate_p_value`` on the card, the ``examples/protein.fasta`` pair
    with 500 sequences from seed 0: its shuffles' K1 scores equal native
    C++ scores of the same draws, and the p-value equals the fit on the
    native scores, as float64 bytes (NaN included)."""
    q, t = _example("protein")
    m = np.array(blosum62())
    n = 500
    f = native.local_max_score_stream(q, t, m, 11.0, 2.0)[0]
    p = port.calculate_p_value(q, t, f, 11.0, 2.0, m, n_sequences=n,
                               rng=np.random.default_rng(0), device=dev)
    rng = np.random.default_rng(0)
    shuffles = [port.statistics.shuffle_and_randomize_sequence(t, rng) for _ in range(n - 1)]
    want = _native_fit(q, t, f, 11.0, 2.0, m, shuffles, dev)
    assert np.float64(p).tobytes() == np.float64(want).tobytes()


@pytest.mark.parametrize("mode", ["local", "global"])
def test_search_cli_on_the_card_is_the_cpus(dev, tmp_path, mode):
    """``aligner-search`` (top 10 with alignments) on a seeded database of
    2,000 records (lengths log-normal, median 100, 20-400; eight homologs of
    the 80-residue query among them): the card's stdout equals the CPU's
    byte for byte, and each hit's score equals native C++."""
    rng = np.random.default_rng(26)
    q = rng.integers(0, 20, 80).astype(np.int8)
    lens = np.clip(np.round(rng.lognormal(np.log(100.0), 0.6, 2000)), 20, 400).astype(int)
    db = [rng.integers(0, 20, n).astype(np.int8) for n in lens]
    for i in rng.choice(len(db), 8, replace=False):
        db[i] = np.concatenate([db[i][:10], _related(rng, q), db[i][10:]])
    qf = _fasta(tmp_path / "query.fasta", [("query", port.Protein.decode(q))])
    dbf = _fasta(tmp_path / "db.fasta",
                 [(f"db{i}", port.Protein.decode(s)) for i, s in enumerate(db)])
    argv = ["-q", qf, "-i", dbf, "-k", "10"] + (["--global"] if mode == "global" else [])
    got = _stdout(cli_search.main, argv + ["--device", dev.type])
    assert got == _stdout(cli_search.main, argv + ["--device", "cpu"])
    m = np.array(blosum62())
    hits = [line.split("\t") for line in got.splitlines() if not line.startswith("\t")]
    assert len(hits) == 10
    for _, name, score in hits:
        s = db[int(name[2:])]
        if mode == "local":
            want = native.local_max_score_stream(q, s, m, 11.0, 2.0)[0]
        else:
            want = native.fill(q, s, m, 11.0, 2.0, "global")[0][len(s), len(q)]
        assert float(score) == want, name


@pytest.mark.parametrize("pretty", [False, True], ids=["debug", "pretty"])
def test_align_cli_on_a_pair_wider_than_a_plane(dev, tmp_path, monkeypatch, pretty):
    """``aligner-align -g`` on a 3,000 x 2,900 pair with the width cap set
    to 1,024 columns and blocks of 1,024: the pair takes the column-blocked
    pipeline on the card and on the CPU, and the card's stdout equals the
    CPU's byte for byte."""
    from aligner_tpu_torch.cli import align as cli_align
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    monkeypatch.setattr(wavefront, "MAX_WIDTH", 1024)
    monkeypatch.setattr(sp, "CB_COLS", 1024)
    calls = []
    real = sp.sharded_global_align
    monkeypatch.setattr(sp, "sharded_global_align",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(27)
    q = rng.integers(0, 20, 3000).astype(np.int8)
    t = _related(rng, q[:2900])
    fa = _fasta(tmp_path / "pair.fasta",
                [("query", port.Protein.decode(q)), ("target", port.Protein.decode(t))])
    argv = ["-i", fa, "-g"] + (["--pretty"] if pretty else [])
    got = _stdout(cli_align.main, argv + ["--device", dev.type])
    assert calls == [1] and got.strip()
    assert got == _stdout(cli_align.main, argv + ["--device", "cpu"])
    assert calls == [1, 1]


def _chromosome(rng, bp, motif, copies):
    """Random DNA with ``copies`` mutated copies of ``motif`` (every 4th
    position redrawn, a phase a copy) at regular offsets."""
    letters = np.frombuffer(b"ATCG", np.uint8)
    seq = letters[rng.integers(0, 4, bp)]
    stride = bp // (copies + 1)
    for i in range(copies):
        copy = letters[motif].copy()
        idx = np.arange(i % 4, len(copy), 4)
        copy[idx] = letters[rng.integers(0, 4, len(idx))]
        seq[(i + 1) * stride:(i + 1) * stride + len(copy)] = copy
    return seq.tobytes().decode()


def test_repeat_search_cli_on_the_card_is_the_cpus(dev, tmp_path):
    """``aligner-repeat-search`` in exploring mode with a checkpoint on a
    seeded 200 kb chromosome with 40 planted copies of one 40-base motif
    (PWM width 30, offset 10, 3 cycles): the card's output CSV, matrices
    JSON and checkpoint equal the CPU's byte for byte."""
    from aligner_tpu_torch.cli import repeat_search as cli_repeat

    rng = np.random.default_rng(28)
    raw = _chromosome(rng, 200_000, rng.integers(0, 4, 40), 40)
    fa = _fasta(tmp_path / "chrom.fasta",
                [("chr_synthetic", "\n".join(raw[i:i + 80] for i in range(0, len(raw), 80)))])
    files = []
    for where, device in (("card", dev.type), ("cpu", "cpu")):
        out = tmp_path / where
        out.mkdir()
        argv = ["-i", fa, "-o", str(out / "output.csv"), "--checkpoint",
                str(out / "scan.ckpt"), "-r", "30", "-q", "10", "--repeats", "3",
                "--seed", "0", "--device", device]
        _stdout(cli_repeat.main, argv)
        files.append({p.name: p.read_bytes() for p in sorted(out.iterdir())})
    got, want = files
    assert sorted(got) == sorted(want) and len(got) >= 3
    assert len(got["output.csv"].splitlines()) > 1
    for name in got:
        assert got[name] == want[name], name


def test_repeat_search_on_the_card_is_the_plain_reference(dev, tmp_path):
    """``run_exploring_cmd`` on a seeded 1 Mb chromosome made as the
    benchmark's driver makes it (40 planted copies of one 330-base query),
    at the reference's defaults (W 300, offset 30, del 30, ext 7, 10
    cycles), against the benchmark's plain reference
    (``benchmark/reference/repeat.py``) run on the card: every task's left,
    right, z and f, the final PWM and the scans, bit for bit."""
    import importlib.util

    from aligner_tpu_torch.repeat import engine

    bench = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
    sys.path.insert(0, str(bench))
    try:
        spec = importlib.util.spec_from_file_location("bench_driver_repeat",
                                                      bench / "drivers" / "repeat.py")
        driver = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = driver
        spec.loader.exec_module(driver)
    finally:
        sys.path.remove(str(bench))
    raw = driver.make_chromosome(1_000_000, 7, 40, 330, 4)
    fa = tmp_path / "chromosome.fasta"
    driver.write_fasta(str(fa), raw)
    opts = engine.SearchOptions(device=dev.type)
    (res,) = engine.run_exploring_cmd(opts, str(fa), np.random.default_rng(29)).values()
    want = driver.search(raw, driver.Options(300, 30, 30.0, 7.0, 10), 29, device=dev)
    got = {"tasks": [(t.left_coord, t.right_coord, t.z, t.f) for t in res.tasks],
           "matrix": res.matrix, "scans": res.scans}
    assert res.scans >= 3 and got["tasks"]
    assert driver.wrong(got, want) == (0, 0, 0)
    assert [t[:2] for t in got["tasks"]] == [t[:2] for t in want.tasks]


def test_full_mode_batch_on_the_card_is_native(dev):
    """512 seeded pairs of 400 residues (each target its query with a quarter
    of its positions substituted) through ``batch_align`` with alignments,
    local and global: every score equals native C++, and every 8th
    alignment (strings and coordinates) the host engine's."""
    rng = np.random.default_rng(29)
    qs = [rng.integers(0, 20, 400).astype(np.int8) for _ in range(512)]
    ts = [_related(rng, q) for q in qs]
    m = np.array(blosum62())
    for mode in ("local", "global"):
        res = port.batch_align(qs, ts, m, 11.0, 2.0, mode=mode, with_alignments=True,
                               device=dev)
        if mode == "local":
            got = np.array([r.alignment.f for r in res])
            want = np.array([native.local_max_score_stream(q, t, m, 11.0, 2.0)[0]
                             for q, t in zip(qs, ts)])
        else:
            got = port.batch_align(qs, ts, m, 11.0, 2.0, mode="global",
                                   device=dev).end.astype(np.float64)
            want = np.array([native.fill(q, t, m, 11.0, 2.0, "global")[0][-1, -1]
                             for q, t in zip(qs, ts)])
        assert np.array_equal(got, want), mode
        walk = host.align_local if mode == "local" else host.align_global
        for i in range(0, len(qs), 8):
            ref = walk(qs[i], ts[i], m, 11.0, 2.0)
            a = res[i].alignment
            assert np.array_equal(a.query, ref.query_aligned), (mode, i)
            assert np.array_equal(a.target, ref.target_aligned), (mode, i)
            assert tuple(map(tuple, a.coords)) == tuple(map(tuple, ref.coords)), (mode, i)


def _host_heuristic(q, t, matrix, h, del_, max_iters=1000):
    """``heuristic_align``'s loop on the host engine (native C++ fill, Python
    walk) with numpy's transforms, for at most ``max_iters`` iterations (the
    population's default): (alignment, matrix), or None for a member with no
    positive-scoring cell."""
    r2 = h.r_squared if abs(h.r_squared) >= np.finfo(np.float64).eps \
        else float(matrix.shape[0] * matrix.shape[1])
    trans = port.transform_matrix(matrix, h.kd, r2, h.frequencies)
    max_f = 0.0
    for _ in range(max_iters):
        cur = trans
        try:
            r = host.align_local(q, t, cur, del_, del_)
        except port.ResultIsEmpty:
            return None
        aln = port.Alignment(r.query_aligned, r.target_aligned, r.coords, r.f, port.Protein)
        if r.f <= max_f:
            return aln, cur
        max_f = r.f
        trans = port.transform_matrix(aln.frequency_matrix(), h.kd, r2, h.frequencies)
    return aln, cur


def _sql(db, sql, args=()):
    with contextlib.closing(sqlite3.connect(db, timeout=30.0)) as c:
        return c.execute(sql, args).fetchall()


def test_service_request_on_the_card(dev, tmp_path):
    """One request (kd 0, r² 1e5, del 11, V 24, 4 matrices a task) posted to
    the port's dispatcher over HTTP, on the two ``examples/protein.fasta``
    records cut to 50 residues and a seeded homolog of each (6 tasks, 24
    jobs), drained by one worker process on the card (``--warmup``, batches
    of 4): every stored subtask equals ``heuristic_align``'s loop on the
    host engine for its pair and starting matrix, ``/progress`` promotes
    each task's best subtask, and every p-value that ``aligner-torch-calc``
    stores on the card (64 sequences, seed 0) equals the fit on native C++
    scores of the same shuffles (NaN stored as NULL)."""
    from aligner_tpu_torch.cli import calc
    from aligner_tpu_torch.service import models, updater
    from aligner_tpu_torch.service.dispatcher import TOPIC_JOBS, Dispatcher, serve
    from aligner_tpu_torch.service.queue import JobQueue
    from aligner_tpu_torch.service.store import Store

    per_task, n_seq = 4, 64
    rng = np.random.default_rng(23)
    recs = read_fasta_file(str(ROOT / "examples" / "protein.fasta"))
    seqs = [(r.id, r.seq.decode()[:50]) for r in recs]
    seqs += [(f"{name}_homolog", port.Protein.decode(_related(rng, port.Protein.encode(s))))
             for name, s in seqs]
    db = str(tmp_path / "service.db")
    store, queue = Store(db), JobQueue(db)
    server = serve("127.0.0.1", 0, Dispatcher(store, queue, rng=np.random.default_rng(21)),
                   sse_ticks=1)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    worker = None
    try:
        body = json.dumps({"sequences": "".join(f">{n}\n{s}\n" for n, s in seqs),
                           "kdValue": 0.0, "rSquaredValue": 1e5, "delValue": 11.0,
                           "dimValue": 24, "matricesVolumeValue": per_task}).encode()
        req = urllib.request.Request(f"{base}/validate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            hashes = json.loads(r.read())["hashes"]
        n_jobs = queue.pending(TOPIC_JOBS)
        assert (len(hashes), n_jobs) == (6, 6 * per_task)
        log = tmp_path / "worker.log"
        env = dict(os.environ, ALIGNER_DB=db,
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("ALIGNER_QUEUE", None)
        with open(log, "w") as out:
            worker = subprocess.Popen(
                [sys.executable, "-m", "aligner_tpu_torch.service.worker", "--device",
                 dev.type, "--warmup", "--batch", str(per_task), "--poll-interval", "0.2",
                 "--max-batches", str(n_jobs // per_task + 10)],
                cwd=str(ROOT), env=env, stdout=out, stderr=subprocess.STDOUT)
        assert worker.wait(timeout=600) == 0, log.read_text()[-4000:]
        assert queue.pending(TOPIC_JOBS) == 0, log.read_text()[-4000:]

        jobs = {int(i): models.AlignJob.from_json(p)
                for i, p in _sql(db, "select id, payload from jobs")}
        stored, by_task = {}, {}
        for h, key, f, mj, rq, rt in _sql(db, """
                select t.hash, s.source_key, s.f_value, s.matrix_json,
                       s.result_query_sequence, s.result_target_sequence
                from align_subtasks s join align_tasks t on t.id = s.task_id"""):
            assert jobs[int(key)].hash == h
            stored[int(key)] = (np.float64(f).tobytes(), mj, rq, rt)
            by_task.setdefault(h, []).append((f, mj, rq, rt))
        for job_id, job in sorted(jobs.items()):
            h = port.Heuristics(kd=job.kd_value, r_squared=job.r_squared_value,
                                frequencies=job.frequences)
            res = _host_heuristic(port.Protein.encode(job.sequence_1, strict=False),
                                  port.Protein.encode(job.sequence_2, strict=False),
                                  job.matrix, h, job.del_value)
            if res is None:
                assert job_id not in stored, job_id
                continue
            aln, matrix = res
            assert stored.get(job_id) == (np.float64(aln.f).tobytes(),
                                          models.matrix_to_json(matrix),
                                          *aln.render()), job_id
        with urllib.request.urlopen(f"{base}/progress?hashes={','.join(hashes)}",
                                    timeout=120) as r:
            line = r.readline().decode()
        assert line.startswith("data: ")
        assert set(json.loads(line[6:])["progress"].values()) == {100.0}
        assert updater.run_once(store) == 0
        results = _sql(db, """select t.hash, r.f_value, r.matrix_json,
                                     r.result_query_sequence, r.result_target_sequence
                              from result_matrices r join align_tasks t on t.id = r.task_id""")
        assert sorted(h for h, *_ in results) == sorted(hashes)
        for h, *best in results:
            assert best[0] == max(f for f, *_ in by_task[h]) and tuple(best) in by_task[h]

        ids = store.get_ids_with_null_p_value()
        assert len(ids) == len(hashes)
        assert _stdout(calc.main, ["--db", db, "--seed", "0", "--device", dev.type,
                                   "--sequences", str(n_seq)]).strip() == \
            f"backfilled {len(ids)} p-value(s)"
        # calc's one generator, replayed over the tasks in the order it took them
        rng = np.random.default_rng(0)
        for task_id in ids:
            query, target, f, del_, matrix = store.get_result_matrix_by_task_id(task_id)
            q = port.Protein.encode(query, strict=False)
            t = port.Protein.encode(target, strict=False)
            shuffles = [port.statistics.shuffle_and_randomize_sequence(t, rng)
                        for _ in range(n_seq - 1)]
            want = _native_fit(q, t, f, del_, del_, matrix, shuffles, dev)
            (got,), = _sql(db, "select p_value from align_tasks where id = ?", (task_id,))
            if got is None:
                assert np.isnan(want), task_id
            else:
                assert np.float64(got).tobytes() == np.float64(want).tobytes(), task_id
    finally:
        server.shutdown()
        if worker is not None and worker.poll() is None:
            worker.kill()
            worker.wait(timeout=60)
