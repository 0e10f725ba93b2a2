"""The two traceback walks' own bodies (``csrc/walk_core.cuh``: the replay
walk W and the batched walk K4) on the CPU: the kernels compiled with g++
beside ``tests/walk_host.cpp``, which runs every lane as a thread and
emulates the warp intrinsics and cp.async (a lane's copies land only at its
wait, ``tests/warp_host.h``), so that the ring of staged word rows, the
refills, the register window, the runs of TOP codes and the packed stream
run as the card runs them.  Held against the plain versions
(``replay_walk_plain``, ``walk_plain``) on every output: a near-diagonal
path, a TOP run across word rows, a LEFT run longer than the staged span
(the refill, counted), a column base and a foreign block, the budget cut
and a cursor on an edge, a Beginning code inside, blocks walked one after
another with a partial word carried over, words from the plain fills; for
K4 the global borders at y = 0 and x = 0, local walks that stop at
Beginning, starts off the plane (the index clip), B not a multiple of the
warps and S not a multiple of 16; for the counting walk (K4 with the
population's count as its epilogue, ``csrc/count_core.cuh``) its counts
against ``walk_counts_plain`` on words of the plain fill, done, stale and
off-plane members, V = 1, 4, 24 and 55, a plane whose ring is smaller than
its counts, walks that take the whole step budget in one round of words and
in two, and each of its ``COUNT_MUTATIONS`` caught.  Also the batched
walk's launch plan, pure arithmetic (``plan_walk``), and the anchors of
``ops/walk_probe.py``'s variants in the core.  The card's own cp.async and memory are the card
tests' part (``tests/test_torch_cuda.py``)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aligner_tpu_torch.matrices import blosum62
from aligner_tpu_torch.ops import device_walk as dw
from aligner_tpu_torch.ops import walk_probe
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.ops.scan_engine import fill_batch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "aligner_tpu_torch", "csrc")
TOP, LEFT, DIAG, BEG = 0, 1, 2, 3


def build(out_dir, kernel_dir=CSRC) -> ctypes.CDLL:
    """The host build of the walks whose headers lie in ``kernel_dir`` (the
    rest from ``csrc/``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(out_dir / "walk_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-I",
                    str(kernel_dir), "-I", CSRC, "-o", so, os.path.join(HERE, "walk_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.replay_walk_host.argtypes = [p, i64, i, i, i, p, p, i, i, p]
    lib.replay_walk_host.restype = i
    lib.device_walk_host.argtypes = [p, i, i, p, p, i, i, i, p, p, p, p, i, i, i, p]
    lib.device_walk_host.restype = i
    lib.device_walk_count_host.argtypes = [p, i, i, p, p, i, i, p, p, p, p, p, i, p, i, p, i,
                                           p, i, i, i, p]
    lib.device_walk_count_host.restype = i
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build(tmp_path_factory.mktemp("walk"))


# --------------------------------------------------------------------------
# W, the replay walk
# --------------------------------------------------------------------------


def host_replay(lib, words, state, steps, *, row_base, col_base=0, span=512):
    stats = torch.zeros(3, dtype=torch.int32)
    err = lib.replay_walk_host(words.data_ptr(), words.shape[1], row_base, col_base,
                               words.shape[0] * 16, state.data_ptr(), steps.data_ptr(),
                               steps.numel() * 16, span, stats.data_ptr())
    assert err == 0
    return stats


def same_replay(lib, words, state, steps, **kw):
    """The host kernel and the plain version from copies of one cursor and
    stream; returns the kernel's (state, steps, stats)."""
    got = state.clone(), steps.clone()
    want = state.clone(), steps.clone()
    stats = host_replay(lib, words, *got, **kw)
    kw = {k: v for k, v in kw.items() if k in ("row_base", "col_base")}
    wf.replay_walk_plain(words, *want, **kw)
    assert torch.equal(got[0], want[0]), (got[0].tolist(), want[0].tolist())
    assert torch.equal(got[1], want[1])
    return got[0], got[1], stats


def diagonal_codes(rng, R, C, p_diag=0.8):
    """Codes of a near-diagonal path: DIAG mostly, TOP and LEFT the rest."""
    return rng.choice([DIAG, TOP, LEFT], size=(R, C), p=[p_diag, (1 - p_diag) / 2,
                                                         (1 - p_diag) / 2])


def replay_case(codes, cy, cx, n_steps, *, n=0):
    words = dw.pack_codes(codes, 16)
    state, steps = wf.new_walk(cy, cx, n_steps, "cpu")
    state[2] = n
    return words, state, steps


@pytest.mark.parametrize("span", [32, 64, 128, 512], ids=["s32", "s64", "s128", "s512"])
def test_replay_walk_on_a_near_diagonal_path(host, span):
    rng = np.random.default_rng(span)
    R, C = 320, 400
    words, state, steps = replay_case(diagonal_codes(rng, R, C), R, C, R + C + 1)
    st, _, stats = same_replay(host, words, state, steps, row_base=0, span=span)
    cy, cx, n = st.tolist()
    assert (cy == 0 or cx == 0) and n >= min(R, C)
    assert int(stats[0]) >= R // 16 - cy // 16


def test_replay_walk_takes_a_top_run_across_word_rows(host):
    """A column of TOP codes 70 rows tall (across five word rows, starting
    mid-word), then a diagonal to the top."""
    R, C = 128, 64
    codes = np.full((R, C), DIAG)
    codes[40:110, 50] = TOP
    words, state, steps = replay_case(codes, 110, 51, R + C + 1)
    st, steps_k, _ = same_replay(host, words, state, steps, row_base=0, span=32)
    codes_k = wf._unpack_step_words(steps_k.numpy(), int(st[2]))
    assert (codes_k[:70] == TOP).all() and codes_k[70] == DIAG


def test_replay_walk_refills_a_left_run_longer_than_the_span(host):
    """A LEFT run of 300 columns under a 32-column span: the cursor runs left
    of its row's staged span again and again, and refills each time."""
    R, C = 64, 512
    codes = np.full((R, C), DIAG)
    codes[37, 100:400] = LEFT
    words, state, steps = replay_case(codes, 38, 400, R + C + 1)
    st, _, stats = same_replay(host, words, state, steps, row_base=0, span=32)
    assert int(stats[1]) >= 300 // 32
    assert st.tolist()[:2] == [0, 99 - 37]


def test_replay_walk_with_a_column_base_and_a_foreign_block(host):
    rng = np.random.default_rng(5)
    R, C, col_base, row_base = 96, 256, 1000, 64
    words = dw.pack_codes(diagonal_codes(rng, R, C), 16)
    state, steps = wf.new_walk(row_base + 90, col_base + 200, 2000, "cpu")
    st, _, _ = same_replay(host, words, state, steps, row_base=row_base, col_base=col_base,
                           span=64)
    cy, cx, _ = st.tolist()
    assert cy == row_base or cx == col_base
    # the cursor in the block to the left, above, below or right: left alone
    for cy, cx in ((row_base + 50, col_base), (row_base, col_base + 50),
                   (row_base + R + 1, col_base + 50), (row_base + 50, col_base + C + 1)):
        state = torch.tensor([cy, cx, 7], dtype=torch.int32)
        st, steps_k, _ = same_replay(host, words, state, steps, row_base=row_base,
                                     col_base=col_base)
        assert st.tolist() == [cy, cx, 7] and torch.equal(steps_k, steps)


@pytest.mark.parametrize("n0,words_out", [(0, 3), (5, 3), (17, 4), (48, 3)],
                         ids=["n0", "n5", "n17", "full"])
def test_replay_walk_budget_cut(host, n0, words_out):
    """A stream of words_out words cuts the walk at 16 * words_out codes,
    from a count that starts mid-word (the earlier codes kept) or at the
    budget already."""
    rng = np.random.default_rng(n0)
    R, C = 160, 160
    codes = diagonal_codes(rng, R, C)
    words, state, steps = replay_case(codes, R, C, 16 * words_out, n=n0)
    steps[:] = torch.from_numpy(rng.integers(-2**31, 2**31, words_out).astype(np.int32))
    st, _, _ = same_replay(host, words, state, steps, row_base=0, span=64)
    assert int(st[2]) == 16 * words_out


def test_replay_walk_leaves_a_cursor_on_an_edge(host):
    rng = np.random.default_rng(9)
    words = dw.pack_codes(diagonal_codes(rng, 32, 64), 16)
    for cy, cx in ((0, 40), (20, 0), (0, 0)):
        state = torch.tensor([cy, cx, 3], dtype=torch.int32)
        steps = torch.full((8,), -1, dtype=torch.int32)
        st, _, stats = same_replay(host, words, state, steps, row_base=0)
        assert st.tolist() == [cy, cx, 3] and int(stats[0]) == 0


def test_replay_walk_repeats_a_beginning_code_to_the_budget(host):
    codes = np.full((48, 64), DIAG)
    codes[30, 40] = BEG
    words, state, steps = replay_case(codes, 40, 50, 100)
    st, _, _ = same_replay(host, words, state, steps, row_base=0, span=32)
    assert st.tolist() == [31, 41, 112]


def test_replay_walk_over_blocks_one_after_another(host):
    """Blocks of 32 rows from the bottom, as the chunked walk calls them:
    the cursor and a partial word carried from block to block."""
    rng = np.random.default_rng(12)
    R, C, TB = 200, 230, 32
    R_pad = -(-R // TB) * TB
    codes = np.full((R_pad, C), DIAG)
    codes[:R] = diagonal_codes(rng, R, C, p_diag=0.6)
    got = wf.new_walk(R, C, R_pad + C + 1, "cpu")
    want = wf.new_walk(R, C, R_pad + C + 1, "cpu")
    for j in range(R_pad // TB - 1, -1, -1):
        words = dw.pack_codes(codes[j * TB:(j + 1) * TB], 16)
        host_replay(host, words, *got, row_base=j * TB, span=64)
        wf.replay_walk_plain(words, *want, row_base=j * TB)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0][0]) == 0 or int(got[0][1]) == 0


@pytest.mark.parametrize("C,R,span", [(300, 200, 512), (130, 250, 32)],
                         ids=["300x200-s512", "130x250-s32"])
def test_replay_walk_on_words_from_the_plain_fill(host, C, R, span):
    rng = np.random.default_rng(C + R)
    qn = rng.integers(0, 20, C)
    tn = np.resize(qn, R).copy()
    mask = rng.random(R) < 0.25
    tn[mask] = rng.integers(0, 20, int(mask.sum()))
    C_pad, R_pad = -(-C // wf.COL_PAD) * wf.COL_PAD, -(-R // 16) * 16
    q = torch.from_numpy(np.pad(qn, (0, C_pad - C)).astype(np.int32))
    t = torch.from_numpy(np.pad(tn, (0, R_pad - R)).astype(np.int32))
    m = torch.from_numpy(np.array(blosum62()).astype(np.int32))
    _, words, _ = wf.row_scan_plain(q, t, m, 11, 2, None, 0, C, R, True)
    state, steps = wf.new_walk(R, C, R_pad + C_pad + 1, "cpu")
    st, _, _ = same_replay(host, words.contiguous(), state, steps, row_base=0, span=span)
    assert int(st[0]) == 0 or int(st[1]) == 0


# --------------------------------------------------------------------------
# K4, the batched walk
# --------------------------------------------------------------------------


def host_walk(lib, words, sy, sx, S, mode, *, plan=None, sms=2):
    B, word_rows, C = words.shape
    p = plan or dw.plan_walk(B, max(C, 1), sms=sms)
    steps = torch.zeros((-(-S // 16), B), dtype=torch.int32)
    n, ey, ex = (torch.zeros(B, dtype=torch.int32) for _ in range(3))
    stats = torch.zeros(3, dtype=torch.int32)
    err = lib.device_walk_host(words.data_ptr(), word_rows, C, sy.data_ptr(), sx.data_ptr(),
                               B, S, int(mode == "global"), steps.data_ptr(), n.data_ptr(),
                               ey.data_ptr(), ex.data_ptr(), p.warps, p.blocks, p.span,
                               stats.data_ptr())
    assert err == 0
    return (steps, n, ey, ex), stats


def same_walk(lib, words, sy, sx, S, mode, **kw):
    got, stats = host_walk(lib, words, sy, sx, S, mode, **kw)
    want = dw.walk_plain(words, sy, sx, S=S, mode=mode)
    for name, a, b in zip(("steps", "n", "ey", "ex"), got, want):
        assert torch.equal(a, b), name
    return got, stats


def _i32(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in arrays]


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("sms,span", [(2, 128), (2, 16), (64, 128)],
                         ids=["4a-block", "4a-block-s16", "1a-block"])
def test_batched_walk_on_words_from_the_plain_fill(host, mode, sms, span):
    """37 ragged problems (not a multiple of the warps a block), S = 45 + 40
    + 1 (not a multiple of 16); rows of 16 columns refill."""
    rng = np.random.default_rng(4)
    B, C, R = 37, 40, 45
    q, t = rng.integers(0, 24, (B, C)), rng.integers(0, 24, (B, R))
    ql, tl = rng.integers(0, C + 1, B), rng.integers(0, R + 1, B)
    q, ql, t, tl = _i32(q, ql, t, tl)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float64)
    r = fill_batch(q, ql, t, tl, m, 11.0, 2.0, mode=mode, with_dirs=True)
    sy, sx = (tl, ql) if mode == "global" else (r.fy, r.fx)
    S = R + C + 1
    plan = dw.plan_walk(B, C, sms=sms, span=span)
    same_walk(host, r.words.contiguous(), sy.contiguous(), sx.contiguous(), S, mode,
              plan=plan)


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("span,warps", [(4, 1), (32, 2), (13, 1), (4, 3), (32, 4), (128, 8)],
                         ids=["s4-w1", "s32-w2", "s13-w1", "s4-w3", "s32-w4", "s128-w8"])
def test_batched_walk_on_raw_words_and_odd_starts(host, mode, span, warps):
    """Any codes, Beginning too; starts on the borders (y = 0, x = 0, both),
    inside, and off the plane below and right (the index clip); copies of 4
    bytes (a span not a multiple of 4) and of 16."""
    rng = np.random.default_rng(span + warps)
    B, R8, C = 53, 48, 72
    codes = rng.choice([TOP, LEFT, DIAG, BEG], size=(B, R8, C), p=[0.3, 0.3, 0.38, 0.02])
    words = dw.pack_codes(codes, 8)
    sy = rng.integers(1, R8 + 1, B)
    sx = rng.integers(1, C + 1, B)
    sy[:4], sx[:4] = [0, 0, 0, 30], [0, 25, 1, 0]
    sy[4:8], sx[4:8] = [R8 + 3, R8 + 9, 20, R8 + 1], [30, C + 5, C + 17, C + 1]
    sy[8], sx[8] = -1, 5  # above the plane: the clip to word 0
    sy, sx = _i32(sy, sx)
    S = R8 + C + 1 + 10
    plan = dw.plan_walk(B, C, sms=1, warps=warps, span=span)
    same_walk(host, words, sy, sx, S, mode, plan=plan)


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("span", [16, 32])
def test_batched_walk_refills_long_left_runs(host, mode, span):
    """Rows of LEFT codes far wider than the span: every walk runs left of
    its staged span and refills, and the global ones finish on the top
    border's LEFT run."""
    rng = np.random.default_rng(8)
    B, R8, C = 9, 16, 300
    codes = np.full((B, R8, C), LEFT)
    codes[:, :, :10] = DIAG
    codes[:, 5, 150] = TOP
    words = dw.pack_codes(codes, 8)
    sy, sx = _i32(rng.integers(8, R8 + 1, B), np.full(B, C))
    plan = dw.plan_walk(B, C, sms=1, warps=2, span=span)
    (_, n, _, _), stats = same_walk(host, words, sy, sx, R8 + C + 1, mode, plan=plan)
    assert int(stats[1]) >= B * (C - span) // span
    assert (n > 250).all()


@pytest.mark.parametrize("span", [16, 128])
def test_batched_walk_stops_at_the_step_count(host, span):
    """S shorter than the walks: the stream ends at S codes, Beginning after."""
    rng = np.random.default_rng(3)
    B, R8, C = 6, 64, 64
    words = dw.pack_codes(np.full((B, R8, C), DIAG), 8)
    sy, sx = _i32(rng.integers(40, 65, B), rng.integers(40, 65, B))
    for S in (1, 15, 16, 17, 33):
        (_, n, _, _), _ = same_walk(host, words, sy, sx, S, "global",
                                    plan=dw.plan_walk(B, C, sms=2, span=span))
        assert (n == S).all()


# --------------------------------------------------------------------------
# the counting walk: K4 with the population's count as its epilogue
# --------------------------------------------------------------------------


def host_walk_counts(lib, words, sy, sx, q, t, alive, V, S, plan):
    B, word_rows, C = words.shape
    steps = torch.zeros((-(-S // 16), B), dtype=torch.int32)
    n, ey, ex = (torch.zeros(B, dtype=torch.int32) for _ in range(3))
    counts = torch.full((B, V, V), -1, dtype=torch.int32)
    err = lib.device_walk_count_host(
        words.data_ptr(), word_rows, C, sy.data_ptr(), sx.data_ptr(), B, S, steps.data_ptr(),
        n.data_ptr(), ey.data_ptr(), ex.data_ptr(), q.data_ptr(), q.shape[1], t.data_ptr(),
        t.shape[1], alive.data_ptr(), V, counts.data_ptr(), plan.warps, plan.blocks,
        plan.span, None)
    return err, counts, (steps, n, ey, ex)


# name -> (B, R, C, V, words, done share, stale share, sms, span): words of
# the plain fill from the argmax cells (local, per-problem f64 matrices),
# raw codes from random starts, some off the plane, or raw codes with no
# Beginning walked from the plane's corner for S = min(R8, C) - 1 steps, so
# that every live walk takes the whole budget ("budget"); B not a multiple
# of the warps, S = R + C + 1 not a multiple of 16; V = 1, 4, 24, 55; a
# plane 16 columns wide, whose ring (200 ints) is smaller than its counts
# (576); the population's shape (64 members of 344 x 344, one warp a block
# on 132 SMs); no member alive; whole warps of done members; a stream of
# exactly one round of 32 words, and one of two rounds ending in a partial
# word.  The seed is the case's place in sorted order.
COUNT_CASES = {
    "fill-v24": (37, 45, 40, 24, "fill", 0.25, 0.2, 2, None),
    "fill-v1": (9, 30, 21, 1, "fill", 0.2, 0.2, 2, None),
    "fill-v55": (13, 40, 48, 55, "fill", 0.2, 0.3, 2, None),
    "fill-narrow": (21, 64, 16, 24, "fill", 0.2, 0.2, 64, None),
    "raw-off-plane": (53, 48, 72, 24, "raw", 0.2, 0.2, 1, 32),
    "raw-v55-s13": (11, 24, 40, 55, "raw", 0.0, 0.4, 1, 13),
    "fill-population": (64, 344, 344, 24, "fill", 0.3, 0.1, 132, None),
    "stale-all": (19, 50, 44, 24, "fill", 0.0, 1.0, 2, None),
    "v4-fill": (29, 60, 52, 4, "fill", 0.2, 0.2, 2, None),
    "v4-whole-budget": (33, 600, 600, 4, "budget", 0.2, 0.2, 2, None),
    "warps-mostly-done": (45, 40, 48, 24, "raw", 0.9, 0.0, 2, None),
    "whole-budget-one-round": (5, 513, 513, 24, "budget", 0.0, 0.0, 2, None),
}


def count_case(name):
    """The counting walk's arguments (without the plan) for case ``name``,
    as CPU tensors, and its plan."""
    B, R, C, V, kind, done_frac, stale_frac, sms, span = COUNT_CASES[name]
    rng = np.random.default_rng(sorted(COUNT_CASES).index(name) + 100)
    q, t = rng.integers(0, V, (B, C)), rng.integers(0, V, (B, R))
    done = rng.random(B) < done_frac
    alive = ~done & ~(rng.random(B) < stale_frac)
    if kind == "fill":
        t[: B // 2, : min(R, C)] = q[: B // 2, : min(R, C)]  # homologous halves
        ql = np.where(done, 0, C)
        tl = np.where(done, 0, R)
        mats = torch.as_tensor(rng.normal(0.0, 2.0, (B, V, V)) + 3.0 * np.eye(V))
        qi, qli, ti, tli = _i32(q, ql, t, tl)
        r = fill_batch(qi, qli, ti, tli, mats, 5.0, 2.0, mode="local", with_dirs=True)
        words, sy, sx = r.words.contiguous(), r.fy.contiguous(), r.fx.contiguous()
        R8 = words.shape[1] * 8
    elif kind == "raw":
        R8 = -(-R // 8) * 8
        codes = rng.choice([TOP, LEFT, DIAG, BEG], size=(B, R8, C), p=[0.3, 0.3, 0.38, 0.02])
        words = dw.pack_codes(codes, 8)
        sy = rng.integers(1, R8 + 1, B)
        sx = rng.integers(1, C + 1, B)
        sy[:4], sx[:4] = [R8 + 3, R8 + 9, 20, -1], [30, C + 5, C + 17, 5]
        sy[done], sx[done] = 0, 0
        sy, sx = _i32(sy, sx)
    else:
        R8 = -(-R // 8) * 8
        codes = rng.choice([TOP, LEFT, DIAG], size=(B, R8, C), p=[0.3, 0.3, 0.4])
        words = dw.pack_codes(codes, 8)
        sy, sx = _i32(np.where(done, 0, R8), np.where(done, 0, C))
    S = min(R8, C) - 1 if kind == "budget" else R8 + C + 1
    qi, ti = _i32(q, t)
    plan = dw.plan_walk(B, C, sms=sms, **({} if span is None else dict(span=span)))
    return (words, sy, sx, qi, ti, torch.as_tensor(alive), V, S), plan


def counts_agree(lib, args, plan) -> bool:
    words, sy, sx, q, t, alive, V, S = args
    err, got, walked = host_walk_counts(lib, words, sy, sx, q, t, alive, V, S, plan)
    if err != 0:
        return False
    want = dw.walk_counts_plain(words, sy, sx, q, t, alive, V, S=S)
    return torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(walked, dw.walk_plain(words, sy, sx, S=S,
                                                                mode="local")))


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_counting_walk_equals_plain(host, case):
    """The counting walk's counts equal ``walk_counts_plain`` (and its
    stream, lengths and end cells the plain walk's); done members count
    nothing, stale ones no seed pair."""
    args, plan = count_case(case)
    words, sy, sx, q, t, alive, V, S = args
    err, got, _ = host_walk_counts(host, words, sy, sx, q, t, alive, V, S, plan)
    assert err == 0
    assert counts_agree(host, args, plan)
    assert int(got.sum()) > 0
    assert not got[(sy == 0) & (sx == 0)].any()
    if case == "fill-narrow":
        assert 8 * (plan.span + 8) + 8 < V * V  # walk::ring_ints(WALK_DEPTH, span)


@pytest.mark.parametrize("bad", ["alive-int32", "q-rows", "t-device", "V-0", "meta"])
def test_walk_counts_refusals(bad):
    """``walk_counts`` refuses what its kernel does not take before any
    launch, on any device, and a device that is neither the CPU nor a card."""
    args, _ = count_case("fill-v1")
    words, sy, sx, q, t, alive, V, S = args
    if bad == "alive-int32":
        alive = alive.to(torch.int32)
    elif bad == "q-rows":
        q = q[1:]
    elif bad == "t-device":
        t = t.to("meta")
    elif bad == "V-0":
        V = 0
    else:
        words, sy, sx, q, t, alive = (a.to("meta") for a in (words, sy, sx, q, t, alive))
    with pytest.raises((ValueError, TypeError)):
        dw.walk_counts(words, sy, sx, q, t, alive, V, S=S)


# name -> (header, [(its text, the replacement)], the cases run or None
# for all): faults of the count (csrc/count_core.cuh) and of the counting
# walk around it (csrc/walk_core.cuh) that the counting walk's cases must
# catch; a build that writes past its shared memory fails its launch (-3),
# as the card's does
COUNT_MUTATIONS = {
    # the seed pair left out
    "no-seed-pair": ("count_core.cuh", [
        ("    if (lane == 0 && alive && sy > 0 && sx > 0)\n"
         "        atomicAdd(&counts[tm[clip(sy - 1, R - 1)] * V + "
         "qm[clip(sx - 1, C - 1)]], 1);\n", "")], None),
    # TOP steps counted as pairs
    "top-counted": ("count_core.cuh", [
        ("            if (d == DIAG)\n", "            if (d == DIAG || d == TOP)\n")], None),
    # a warp's shared memory sized for its ring alone, though V * V counts
    # can be larger: the 16-column plane's (one warp a block) writes past
    # its block's; with several warps a block the counts overwrite the next
    # warp's ring, whose walk then stalls until the emulation's wait bound
    "ring-only-smem": ("walk_core.cuh", [
        ("    return ring_ints(WALK_DEPTH, span) > counts ? "
         "ring_ints(WALK_DEPTH, span) : counts;\n", "    return ring_ints(WALK_DEPTH, span);\n")],
        ("fill-narrow",)),
    # the last partial word stored after the count has read the stream
    "partial-word-late": ("walk_core.cuh", [
        ("    if (lane == 0 && (n & 15) != 0) *st.wp = int(st.partial(~0u));\n", ""),
        ("    if (lane == 0) {\n        n_out[b] = n;\n",
         "    if (lane == 0 && (n & 15) != 0) *st.wp = int(st.partial(~0u));\n"
         "    if (lane == 0) {\n        n_out[b] = n;\n")], None),
    # the cursor from the inclusive scan, not the exclusive one
    "inclusive-cursor": ("count_core.cuh", [
        ("int cy = y - (su - up), cx = x - (sl - lf);", "int cy = y - su, cx = x - sl;")],
        None),
    # the round's moves not carried to the next round
    "no-carry": ("count_core.cuh", [
        ("        y -= __shfl_sync(FULL, su, 31);\n"
         "        x -= __shfl_sync(FULL, sl, 31);", "")], None),
    # the last round of words left out
    "short-rounds": ("count_core.cuh", [
        ("w0 < words && 16 * w0 < nm", "w0 + 32 < words && 16 * w0 < nm")], None),
    # the target char of the row below the cursor's
    "row-off-by-one": ("count_core.cuh", [
        ("tm[clip(cy - 1, R - 1)]", "tm[clip(cy, R - 1)]")], None),
    # the seed pair of a member that is not alive
    "stale-seed": ("count_core.cuh", [("alive && sy > 0", "sy > 0")], None),
    # (query char, target char) for (target char, query char)
    "swapped-pair": ("count_core.cuh", [
        ("&counts[tm[clip(cy - 1, R - 1)] * V + qm[clip(cx - 1, C - 1)]]",
         "&counts[qm[clip(cx - 1, C - 1)] * V + tm[clip(cy - 1, R - 1)]]")], None),
}


@pytest.mark.parametrize("name", sorted(COUNT_MUTATIONS))
def test_counting_walk_mutation_is_caught(tmp_path, name):
    """The counting walk built with one deliberate fault disagrees with the
    plain version, or fails its launch, on at least one of the cases."""
    header, edits, cases = COUNT_MUTATIONS[name]
    for h in ("walk_core.cuh", "count_core.cuh"):
        shutil.copy(os.path.join(CSRC, h), tmp_path)
    src = (tmp_path / header).read_text()
    for old, new in edits:
        assert src.count(old) == 1, f"{name}: anchor {old[:60]!r} occurs {src.count(old)} times"
        src = src.replace(old, new)
    (tmp_path / header).write_text(src)
    lib = build(tmp_path, tmp_path)
    for case in cases or sorted(COUNT_CASES):
        if not counts_agree(lib, *count_case(case)):
            return
    pytest.fail(f"mutation {name} agrees with the plain version on every case")


# --------------------------------------------------------------------------
# K4's launch plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,C,sms,kw,want", [
    # (warps, blocks, span): four warps a block while every SM gets a block
    # (the full batch, the PWM survivors), fewer for 300 problems and the
    # search's top ten; a plane narrower than the span; one cell; forced
    (4096, 400, 132, {}, (4, 1024, 128)),
    (1024, 300, 132, {}, (4, 256, 128)),
    (300, 400, 132, {}, (2, 150, 128)),
    (10, 344, 132, {}, (1, 10, 128)),
    (37, 13, 2, {}, (4, 10, 16)),
    (1, 1, 2, {}, (1, 1, 4)),
    (4096, 400, 132, dict(warps=8, span=64), (8, 512, 64)),
])
def test_walk_plan(B, C, sms, kw, want):
    p = dw.plan_walk(B, C, sms=sms, **kw)
    assert (p.warps, p.blocks, p.span) == want
    assert p.blocks * p.warps >= B > (p.blocks - 1) * p.warps


@pytest.mark.parametrize("kw", [dict(B=0, C=4, sms=1), dict(B=4, C=0, sms=1),
                                dict(B=4, C=4, sms=0),
                                dict(B=4, C=4, sms=1, warps=9),
                                dict(B=4, C=4, sms=1, span=2)],
                         ids=["no-problem", "no-column", "no-sm", "9-warps", "span-2"])
def test_walk_plan_refuses(kw):
    with pytest.raises(ValueError):
        dw.plan_walk(**kw)


def test_walk_plan_spreads_over_the_sms():
    """Warps a block halve until every SM has a block, never below one."""
    for B in (1, 7, 131, 132, 263, 264, 528, 529, 4096, 10_000, 100_000):
        p = dw.plan_walk(B, 100, sms=132)
        assert p.blocks >= min(B, 132) or p.warps == 1
        assert p.warps == 4 or -(-B // (2 * p.warps)) < 132


@pytest.mark.parametrize("name", sorted(walk_probe.VARIANTS))
def test_walk_probe_variant_anchors_are_in_the_core(name):
    """Each variant's text occurs once in ``csrc/walk_core.cuh``, so an edit
    of the core shows here which variants it retired."""
    with open(os.path.join(CSRC, "walk_core.cuh")) as fh:
        assert walk_probe.variant_source(name) != fh.read()
