"""The strip walk's own body (``csrc/wavefront_tile.cuh``) on the CPU: the
kernel compiled with g++ beside ``tests/strip_walk_host.cpp``, which runs
every lane as a thread and emulates the warp intrinsics, so that the lane
pipeline, the ring between chunks, the chunk loads ahead of the lanes and
the tagged row handed between strips run as the card runs them, with real
concurrency between warps.  Held against the plain versions
(``row_scan_plain``, ``run_block_cs_plain``) on every output, in the grids
``plan_strips`` gives for a small card (so that there are more strips than
warps) and in grids forced to one warp or several blocks: one strip, one
chunk, 16-, 32- and 64-row strips, 2, 4 and 8 columns a lane, x0 > 0 and
y_offset > 0, the pair's cell (1,1), the end cell inside and outside the
call, checkpoints and directions.  The memory ordering of the card itself
is the card tests' part (``tests/test_torch_cuda.py``)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aligner_tpu_torch.matrices import blosum62
from aligner_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "aligner_tpu_torch", "csrc")
V = 24


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("strip_walk") / "strip_walk_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-I", CSRC,
                    "-o", so, os.path.join(HERE, "strip_walk_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.strip_walk_host.argtypes = [i, p, p, p, i, p, p, p, p, p, p, *[i] * 10, p, p, p, i,
                                    i, i]
    lib.strip_walk_host.restype = i
    return lib


def _ptr(a):
    return None if a is None else a.data_ptr()


def _grid(rows, width, TR, K, grid):
    """(warps, blocks): the plan for a card of 2 SMs holding one block
    each, or a grid forced."""
    if grid is not None:
        return grid
    p = wf.plan_strips(rows, width, TR, K, V, sms=2, blocks_per_sm=1, warps=2)
    return p.warps, p.blocks


def host_row_scan(lib, q, t, m, h0, y_offset, C_real, R_real, *, with_dirs, ckpt_every,
                  TR, K, grid=None):
    """``row_scan``'s outputs from the host build of the kernel."""
    C_pad, R_pad = q.numel(), t.numel()
    warps, blocks = _grid(R_pad, C_pad, TR, K, grid)
    i32 = dict(dtype=torch.int32)
    end = torch.zeros(1, **i32)
    hand, sync = torch.zeros(C_pad, dtype=torch.int64), torch.zeros(1, **i32)
    words = torch.empty((R_pad // 16, C_pad), **i32) if with_dirs else None
    ckpts = torch.empty((R_pad // ckpt_every, C_pad), **i32) if ckpt_every else None
    err = lib.strip_walk_host(
        0, _ptr(q), _ptr(t), _ptr(m), V, _ptr(h0) if y_offset else None, None, None,
        _ptr(hand), _ptr(sync), None, 0, y_offset, C_real, R_real, 11, 2, K, TR,
        R_pad // TR, C_pad // (32 * K), _ptr(end), _ptr(words), _ptr(ckpts), ckpt_every,
        warps, blocks)
    assert err == 0
    _handed_down(hand, sync, R_pad // TR, warps * blocks)
    return end, words, ckpts


def _handed_down(hand, sync, n_tr, warps):
    """Every warp took tickets until none was left, and every word of the
    row handed down was last written for the last strip (or never, with
    one strip)."""
    assert sync[0] == n_tr + warps
    assert torch.all(hand >> 32 == (n_tr - 1))


def host_block_cs(lib, q, t, m, h_prev, lbound, x0, y_base, C_real, R_real, *, with_dirs,
                  ckpt_every, TR, K, grid=None, del_=11, ext=2):
    """``run_block_cs``'s outputs from the host build of the kernel."""
    Cb, rows = q.numel(), t.numel()
    warps, blocks = _grid(rows, Cb, TR, K, grid)
    i32 = dict(dtype=torch.int32)
    end, h_new, rights = torch.zeros(1, **i32), torch.empty(Cb, **i32), torch.empty(rows, **i32)
    hand, sync = torch.zeros(Cb, dtype=torch.int64), torch.zeros(1, **i32)
    words = torch.empty((rows // 16, Cb), **i32) if with_dirs else None
    ckpts = torch.empty((rows // ckpt_every, Cb), **i32) if ckpt_every else None
    err = lib.strip_walk_host(
        1, _ptr(q), _ptr(t), _ptr(m), V, _ptr(h_prev), _ptr(lbound), _ptr(h_new),
        _ptr(hand), _ptr(sync), _ptr(rights), x0, y_base, C_real, R_real, del_, ext, K, TR,
        rows // TR, Cb // (32 * K), _ptr(end), _ptr(words), _ptr(ckpts), ckpt_every, warps,
        blocks)
    assert err == 0
    _handed_down(hand, sync, rows // TR, warps * blocks)
    return h_new, rights, end, words, ckpts


def _codes(rng, n, n_pad):
    return torch.from_numpy(np.pad(rng.integers(0, V, n), (0, n_pad - n)).astype(np.int32))


def _same_words(got, want, rows, cols):
    d, d_p = (wf._unpack_dir_words(w.numpy())[:rows, :cols] for w in (got, want))
    return np.array_equal(d, d_p)


M = torch.from_numpy(np.array(blosum62()).astype(np.int32))

# (C, R, strip rows, columns a lane, y_offset, R_real past the call, grid):
# one strip, one chunk, more strips than the grid's warps, 16/32/64-row
# strips, K 2/4/8, a call from a row in the middle of the pair, the end
# cell past the call, grids of one warp and of several blocks
SCAN_CASES = [
    (1, 1, 16, 4, 0, 0, None),
    (300, 60, 64, 4, 0, 0, None),          # one strip, 3 chunks
    (100, 300, 32, 4, 0, 0, None),         # one chunk, 10 strips, 2 warps
    (600, 100, 16, 2, 0, 0, None),         # 16-row strips: a chunk waits for lane 31
    (257, 70, 32, 8, 48, 0, None),         # from row 48
    (700, 200, 64, 2, 16, 0, (3, 1)),
    (513, 130, 16, 4, 0, 40, (1, 1)),      # the end cell lies past the call; one warp
    (256, 256, 32, 8, 0, 0, (2, 3)),       # more warps than strips take tickets too
]


@pytest.mark.parametrize("with_dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("C,R,TR,K,y_offset,past,grid", SCAN_CASES,
                         ids=[f"{c[0]}x{c[1]}-tr{c[2]}-k{c[3]}-y{c[4]}-p{c[5]}"
                              for c in SCAN_CASES])
def test_host_row_scan_matches_plain(host, C, R, TR, K, y_offset, past, grid, with_dirs):
    rng = np.random.default_rng(C + R + TR)
    C_pad = -(-C // wf.COL_PAD) * wf.COL_PAD
    R_pad = -(-R // TR) * TR
    q, t = _codes(rng, C, C_pad), _codes(rng, R, R_pad)
    h0 = torch.from_numpy(rng.integers(-500, 500, C_pad).astype(np.int32)) if y_offset else None
    R_real = R + y_offset + past
    ck = 0 if with_dirs else TR
    got = host_row_scan(host, q, t, M, h0, y_offset, C, R_real, with_dirs=with_dirs,
                        ckpt_every=ck, TR=TR, K=K, grid=grid)
    want = wf.row_scan_plain(q, t, M, 11, 2, h0, y_offset, C, R_real, with_dirs, ck)
    assert torch.equal(got[0], want[0])
    if with_dirs:
        assert _same_words(got[1], want[1], R, C)
    else:
        assert torch.equal(got[2][:, :C], want[2][:, :C])


# (C, R, column block, column block d, y_base, rows, strip rows, columns a
# lane, grid): the block with cell (1,1), x0 > 0 and y_base > 0, the end
# cell in the block (C_real on its last column and on its first) and
# outside it (by column and by row)
BLOCK_CASES = [
    (512, 128, 256, 0, 0, 128, 64, 4, None),     # cell (1,1), 2 strips
    (512, 128, 256, 1, 64, 64, 32, 4, None),     # the end cell on its last column
    (513, 100, 256, 2, 64, 48, 16, 2, None),     # the end cell on its first column
    (513, 100, 256, 1, 0, 64, 32, 8, (1, 1)),    # no end cell; one warp
    (700, 300, 512, 1, 128, 128, 64, 8, None),   # the end cell below the block
    (2000, 500, 256, 3, 192, 64, 16, 2, (2, 2)),
]


@pytest.mark.parametrize("with_dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("C,R,cb,d,y_base,rows,TR,K,grid", BLOCK_CASES,
                         ids=[f"{c[0]}x{c[1]}-d{c[3]}-y{c[4]}-tr{c[6]}-k{c[7]}"
                              for c in BLOCK_CASES])
def test_host_block_cs_matches_plain(host, C, R, cb, d, y_base, rows, TR, K, grid,
                                     with_dirs):
    rng = np.random.default_rng(C + R + d)
    q, t = _codes(rng, cb, cb), _codes(rng, rows, rows)
    # the edges as a neighbour would hand them (any int32 values, which the
    # plain version reads the same way), or the borders for a block on them
    x0 = d * cb
    if y_base == 0:
        x = x0 + torch.arange(1, cb + 1, dtype=torch.int32)
        h_prev = torch.where(x == C, -(C + 1) * 11, -x * 11).to(torch.int32)
    else:
        h_prev = torch.from_numpy(rng.integers(-3000, 3000, cb).astype(np.int32))
    if x0 == 0:
        y = y_base + torch.arange(0, rows + 1, dtype=torch.int32)
        lbound = torch.where(y == R, -(R + 1) * 11, -y * 11).to(torch.int32)
    else:
        lbound = torch.from_numpy(rng.integers(-3000, 3000, rows + 1).astype(np.int32))
    ck = 0 if with_dirs else TR
    args = (q, t, M, h_prev, lbound, x0, y_base, C, R)
    got = host_block_cs(host, *args, with_dirs=with_dirs, ckpt_every=ck, TR=TR, K=K,
                        grid=grid)
    want = wf.run_block_cs_plain(*args, del_=11, ext=2, with_dirs=with_dirs,
                                 ckpt_every=ck)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    if with_dirs:
        assert _same_words(got[3], want[3], rows, cb)
    else:
        assert torch.equal(got[4], want[4])


# (C, R, column block, column block d, y_base, rows, strip rows, columns a
# lane, grid): the block with cell (1,1) and a block inside the pair
WIDE_CASES = [(512, 128, 256, 0, 0, 128, 32, 4, None),
              (768, 256, 256, 1, 128, 128, 64, 8, (2, 2))]


@pytest.mark.parametrize("with_dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("C,R,cb,d,y_base,rows,TR,K,grid", WIDE_CASES,
                         ids=[f"{c[0]}x{c[1]}-d{c[3]}-y{c[4]}" for c in WIDE_CASES])
def test_host_block_cs_wide_entries_near_the_guard(host, C, R, cb, d, y_base, rows, TR, K,
                                                   grid, with_dirs):
    """The column-block fill with a matrix beyond int8 (the "lax" engine's
    table), its entries up to the largest the range guard admits for the
    pair, and edges as large as such a pair's rows reach: a narrowing of an
    entry or of a value anywhere in the body (the cell, the -ext chain,
    the end cell, the tagged words handed down) shows against the plain
    version."""
    rng = np.random.default_rng(C + R + d + 7)
    del_, ext = 220, 40
    top = (2**30 - 1) // min(C, R)
    peak = max(e for e in range(top - 4096, top + 1)
               if wf.range_ok(C, R, del_, ext, e))
    assert not wf.range_ok(C, R, del_, ext, peak + 1)
    m = torch.from_numpy(rng.integers(-peak, peak + 1, (V, V)).astype(np.int32))
    m[0, 0] = peak
    q, t = _codes(rng, cb, cb), _codes(rng, rows, rows)
    q[:8] = t[:8] = 0  # the diagonal of the largest entry starts the block
    x0 = d * cb
    reach = y_base * peak  # as high as the rows above can climb
    if y_base == 0:
        x = x0 + torch.arange(1, cb + 1, dtype=torch.int32)
        h_prev = torch.where(x == C, -(C + 1) * del_, -x * del_).to(torch.int32)
    else:
        h_prev = torch.from_numpy(rng.integers(-reach, reach, cb).astype(np.int32))
        h_prev[:8] = reach
    if x0 == 0:
        y = y_base + torch.arange(0, rows + 1, dtype=torch.int32)
        lbound = torch.where(y == R, -(R + 1) * del_, -y * del_).to(torch.int32)
    else:
        lbound = torch.from_numpy(rng.integers(-reach, reach, rows + 1).astype(np.int32))
    ck = 0 if with_dirs else TR
    args = (q, t, m, h_prev, lbound, x0, y_base, C, R)
    got = host_block_cs(host, *args, with_dirs=with_dirs, ckpt_every=ck, TR=TR, K=K,
                        grid=grid, del_=del_, ext=ext)
    want = wf.run_block_cs_plain(*args, del_=del_, ext=ext, with_dirs=with_dirs,
                                 ckpt_every=ck)
    assert int(want[0].abs().max()) > 2**29  # the values climb past int16 and beyond
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    if with_dirs:
        assert _same_words(got[3], want[3], rows, cb)
    else:
        assert torch.equal(got[4], want[4])
