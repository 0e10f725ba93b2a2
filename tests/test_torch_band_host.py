"""The band walk's own body (``csrc/wavefront_band.cu``) on the CPU: the
kernel compiled with g++ beside ``tests/band_walk_host.cpp``, which runs
every lane as a thread and emulates the warp intrinsics
(``tests/warp_host.h``), so that the steps, the chunks read ahead, the
waits between row groups and the tagged row handed down run as the card
runs them, with real concurrency between warps.  Held against the plain
version (``run_block_band_plain``) on every output, on the slots the
card's check compares (``rb`` where cells of the block's columns feed it,
``rc``, ``end``), in the grids ``plan_band`` gives for a small card (so
that there are more groups than warps) and in grids forced to one warp or
several blocks: one group, every rows-a-lane and read-ahead the kernel
takes, band heights at, below and one past the rows, widths at and around
chunk seams, band 0 with cell (1,1)'s correction and later bands, a
streamed left boundary at x0 > 0, the end cell inside and outside the call,
the right column on and off, and every count of score-table copies a block
can keep (32 for BLOSUM62, fewer for larger alphabets).  A wait is bounded
(the kernel traps after WAIT_LIMIT_CYCLES, here ticks of 16 ns: about
69 s), so a fault aborts the test and cannot hang the suite.  The memory
ordering of the card itself is the card tests' part
(``tests/test_torch_cuda.py``)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aligner_tpu_torch.matrices import blosum62
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.parallel import wavefront_sp as sp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "aligner_tpu_torch", "csrc")
B62 = np.array(blosum62())


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("band_walk") / "band_walk_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-I", CSRC,
                    "-o", so, os.path.join(HERE, "band_walk_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.band_walk_host.argtypes = [*[p] * 7, *[i] * 11, *[p] * 5, i, i, i]
    lib.band_walk_host.restype = i
    return lib


def host_band(lib, t_band, q, f, c1, c2, fd, matrix, scal, *, Cb, ext, with_rc=True,
              rows_per_lane=wf.BAND_ROWS_PER_LANE, read_ahead=wf.BAND_READ_AHEAD,
              grid=None, check_codes=True, copies=32):
    """``run_block_band``'s outputs from the host build of the kernel, in
    the grid ``plan_band`` gives for a card of 2 SMs holding one block of 2
    warps each, or in ``grid`` = (warps, blocks), each block keeping
    ``copies`` of the score table."""
    j_end, d_end, owned = wf._check_band(t_band, q, f, c1, c2, fd, matrix, scal, Cb,
                                         check_codes)
    TB, D, V = t_band.numel(), q.numel(), matrix.shape[0]
    K, P = rows_per_lane, read_ahead
    # the host build sizes its blocks' shared memory itself
    plan = wf.plan_band(TB, Cb, D, K, P, sms=2, blocks_per_sm=1, warps=2, copies=copies,
                        smem_bytes=0)
    warps, blocks = grid or (plan.warps, plan.blocks)
    i32 = dict(dtype=torch.int32)
    hand = torch.zeros(plan.hand_words, dtype=torch.int64)
    sync = torch.zeros(plan.sync_ints, **i32)
    rb = torch.full((D,), wf.NEG_I32, **i32)
    rc, end = torch.zeros(TB, **i32), torch.zeros(1, **i32)
    m = matrix.contiguous()
    err = lib.band_walk_host(
        t_band.data_ptr(), q.data_ptr(), f.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        fd.data_ptr(), m.data_ptr(), V, TB, D, int(Cb), int(ext), K, P, j_end, d_end, owned,
        int(bool(with_rc)), hand.data_ptr(), sync.data_ptr(), rb.data_ptr(), rc.data_ptr(),
        end.data_ptr(), warps, blocks, copies)
    assert err == 0
    # every warp took tickets until none was left; the last group handed
    # nothing down, so no word carries a tag past it
    assert int(sync[0]) == plan.n_g + warps * blocks
    assert int((hand >> 32).max()) <= plan.n_g - 1
    return rb, rc, end


def same_band(got, want, TB, Cb, with_rc):
    """rb on the slots that cells of the block's columns feed, rc and end."""
    ok = torch.equal(got[0][TB - 1:TB - 1 + Cb], want[0][TB - 1:TB - 1 + Cb])
    if with_rc:
        ok = ok and torch.equal(got[1], want[1])
    return ok and torch.equal(got[2], want[2])


def _check(lib, args, kw, with_rc, **host_kw):
    got = host_band(lib, *args, **kw, with_rc=with_rc, **host_kw)
    want = wf.run_block_band_plain(*args, **kw, with_rc=with_rc)
    assert same_band(got, want, args[0].numel(), kw["Cb"], with_rc)


# (C, R, band rows, rows a lane, slots read ahead): the bands of a seeded
# pair as end_score_single_global_diag builds them, band 0 carrying cell
# (1,1)'s correction: one group, band heights at, below and one past the
# rows, every K and read-ahead
PAIR_CASES = [
    (1, 1, 128, 4, 32),        # one group, one real cell
    (100, 128, 128, 4, 16),    # one group, the band as tall as the rows
    (200, 256, 256, 2, 32),    # 4 groups at the rows
    (150, 300, 256, 1, 64),    # a band below the rows: 2 bands, 8 groups each
    (300, 257, 256, 2, 16),    # one row past: the second band holds it alone
    (60, 520, 256, 8, 32),     # a narrow block under tall groups, 3 bands
]


@pytest.mark.parametrize("with_rc", [True, False], ids=["rc", "norc"])
@pytest.mark.parametrize("C,R,tb,K,P", PAIR_CASES,
                         ids=[f"{c}x{r}-tb{tb}-k{k}-p{p}" for c, r, tb, k, p in PAIR_CASES])
def test_host_band_matches_plain_on_a_pairs_bands(host, C, R, tb, K, P, with_rc):
    rng = np.random.default_rng(C + R + K)
    pp = wf._prep(rng.integers(0, 24, C), rng.integers(0, 24, R), B62, 11, 2, "cpu")
    bands = []
    wf._band_end_score(pp, tb, P, K, block=wf.run_block_band_plain, trace=bands)
    for args, kw, _ in bands:
        _check(host, args, kw, with_rc, rows_per_lane=K, read_ahead=P)


def _raw_streams(rng, TB, Cb, pad, V=24):
    """Streams of any int32 values a neighbour could hand over: the row
    above and the column left in hat coordinates, random codes with the
    padding code past Cb."""
    D = Cb + TB - 1 + pad
    q = np.full(D, V, np.int32)
    q[:Cb] = rng.integers(0, V, Cb)
    f, fd, c1, c2 = (rng.integers(-3000, 3000, D).astype(np.int32) for _ in range(4))
    t = rng.integers(0, V, TB).astype(np.int32)
    return [torch.from_numpy(a) for a in (t, q, f, c1, c2, fd)]


# (TB, Cb, rows a lane, slots read ahead, padding slots, grid, end cell):
# a group's steps RW - 1 + Cb ending one before, at and one past a chunk
# seam, a block narrower than a chunk, more groups than warps in grids of
# one warp and of several blocks; the end cell in the first group, the
# last, a middle one, on the block's first and last column, or not in the
# call
RAW_CASES = [
    (64, 32, 1, 32, 0, None, (0, 1)),          # RW - 1 + Cb = 63: one short of 2 chunks
    (64, 33, 1, 32, 3, None, (63, 96)),        # 64 steps: on the seam
    (64, 34, 2, 32, 1, (1, 1), (None, None)),  # 97 steps: one past; one warp
    (128, 15, 4, 16, 0, (3, 1), (70, 80)),     # narrower than a chunk
    (256, 100, 2, 64, 5, (2, 2), (200, 300)),  # 4 groups, 4 warps, 2 blocks
    (256, 257, 1, 16, 0, (2, 1), (255, 512)),  # 8 groups, 2 warps; end on the last column
    (512, 40, 4, 32, 2, (1, 2), (300, 320)),   # 4 groups over 2 one-warp blocks
    (256, 300, 8, 64, 0, None, (0, 300)),      # one group of 256 rows
]


@pytest.mark.parametrize("with_rc", [True, False], ids=["rc", "norc"])
@pytest.mark.parametrize("TB,Cb,K,P,pad,grid,end", RAW_CASES,
                         ids=[f"tb{c[0]}-cb{c[1]}-k{c[2]}-p{c[3]}" for c in RAW_CASES])
def test_host_band_matches_plain_on_raw_streams(host, TB, Cb, K, P, pad, grid, end,
                                                with_rc):
    rng = np.random.default_rng(TB + Cb + K + P)
    streams = _raw_streams(rng, TB, Cb, pad)
    m = torch.from_numpy(B62.astype(np.int32))
    j_end, d_end = end
    scal = (0, 1, 0) if j_end is None else (j_end, d_end, 1)
    _check(host, (*streams, m, scal), dict(Cb=Cb, ext=2), with_rc, rows_per_lane=K,
           read_ahead=P, grid=grid)


# (V, copies of the table): what a block keeps on an H100 with 4 warps read
# 32 slots ahead (the most copies with which two blocks share an SM: 32 up to
# V = 41, 8 at 48, 4 at 64), and every other count at BLOSUM62's 24
COPY_CASES = [(4, 32), (24, 1), (24, 2), (24, 4), (24, 16), (48, 8), (64, 4)]


@pytest.mark.parametrize("V,copies", COPY_CASES, ids=[f"v{v}-c{c}" for v, c in COPY_CASES])
def test_host_band_every_count_of_table_copies(host, V, copies):
    """An integral matrix over V symbols, held in ``copies`` copies: lane l
    reads copy l % copies, more groups than warps, the end cell and the
    right column in the call."""
    rng = np.random.default_rng(V + copies)
    TB, Cb = 256, 150
    streams = _raw_streams(rng, TB, Cb, 3, V=V)
    m = torch.from_numpy(rng.integers(-30, 30, (V, V)).astype(np.int32))
    _check(host, (*streams, m, (200, 260, 1)), dict(Cb=Cb, ext=3), True, rows_per_lane=2,
           read_ahead=32, grid=(2, 2), copies=copies)


GRID_CASES = [(600, 300, 128, 256, 2, 32), (300, 200, 64, 100, 1, 16),
              (257, 129, 128, 100, 4, 64)]


@pytest.mark.parametrize("C,R,tb,cb,K,P", GRID_CASES,
                         ids=[f"{c}x{r}-{a}x{b}-k{k}-p{p}" for c, r, a, b, k, p in GRID_CASES])
def test_host_band_grid_streamed_left_boundary(host, C, R, tb, cb, K, P):
    """Column blocks at x0 > 0 fed their left neighbour's right column:
    the host build's grid against the plain version's, output by output."""
    rng = np.random.default_rng(C + R + cb)
    q = rng.integers(0, 24, C).astype(np.int8)
    t = rng.integers(0, 24, R).astype(np.int8)

    def block(*args, **kw):
        return host_band(host, *args, **kw, rows_per_lane=K, read_ahead=P)

    end, rights, bottoms = sp.band_grid(q, t, B62, 11.0, 2.0, tb=tb, cb=cb, device="cpu",
                                        block=block)
    end_p, rights_p, bottoms_p = sp.band_grid(q, t, B62, 11.0, 2.0, tb=tb, cb=cb,
                                              device="cpu", block=wf.run_block_band_plain)
    assert len(rights) >= 2 and int(end) == int(end_p)
    for col, col_p in zip(rights, rights_p):
        assert torch.equal(col[:R], col_p[:R])
    for row, row_p in zip(bottoms, bottoms_p):
        for ci, (b, b_p) in enumerate(zip(row, row_p)):
            n = min(cb, C - ci * cb)
            assert torch.equal(b[:n], b_p[:n])
