"""The batched fill kernel's own body (``csrc/dp_fill_core.cuh``) on the CPU:
compiled with g++ beside ``tests/dp_fill_host.cpp``, which runs every
thread of a block as a std::thread on the warp emulation of
``tests/warp_host.h`` (the block's shared memory a vector, its
``__syncthreads`` a barrier), on the instances the library builds.  Held
against the plain version (``fill_batch``, ``fill_pwm_batch``) on every
output, the score plane included: ragged pair batches in local and global
mode, f32 and f64, every instance of argmax tracking, directions and the
plane; columns spilled past the rows held on chip (S < R8 + 1, a small
card's plan); per-problem matrices; blocks of several warps with the
matrix in shared memory; PWM mode with shared and per-problem PWMs.  A
fault written into the plane's store (``MUTATIONS``) must be caught.  The
lone design (``dp_fill_kernel_lone``) as the kernel runs it and with its
chain and companion steps in turn, column by column, against the same
plain version: local and global, f32 and f64, ragged lengths, ties, an
all-zero local column, shared and per-problem matrices, and its faults
(``LONE_MUTATIONS``).  The card's own launch is the card tests' part
(``tests/test_torch_cuda.py``)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aligner_tpu_torch.matrices import blosum62
from aligner_tpu_torch.ops.dp_fill import CardLimits, plan_fill
from aligner_tpu_torch.ops.scan_engine import fill_batch, fill_pwm_batch, round8

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "aligner_tpu_torch", "csrc")
H100 = CardLimits(sms=132, smem_per_block=232_448, smem_per_sm=233_472, smem_reserved=1_024)
# a card whose blocks hold two 8-row blocks of a column on chip: the rest spill
SMALL = CardLimits(sms=4, smem_per_block=2_800, smem_per_sm=8_192, smem_reserved=0)

# faults written into the kernel body's text (an anchor occurs once)
MUTATIONS = {
    "plane rows reversed": ("for (int j = 0; j < 8; ++j) p[j] = out[j];",
                            "for (int j = 0; j < 8; ++j) p[j] = out[7 - j];"),
}
# faults in the lone design's companion
LONE_MUTATIONS = {
    "a tie in a column goes to the higher row": (
        "if (v > best || (v == best && r < brow)) {",
        "if (v > best || (v == best && r > brow)) {"),
    "row 1 reads the penalty of (1, 1) in every column": (
        "                p = (x == 1) ? del\n",
        "                p = (x >= 1) ? del\n"),
    "the end value one row short": ("ev = nb[tl - 1];", "ev = nb[tl > 1 ? tl - 2 : 0];"),
}


def _compile(out_dir, core=None):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    inc = CSRC
    if core is not None:
        inc = str(out_dir)
        with open(os.path.join(inc, "dp_fill_core.cuh"), "w") as fh:
            fh.write(core)
    so = os.path.join(str(out_dir), "dp_fill_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-I", inc,
                    "-o", so, os.path.join(HERE, "dp_fill_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.dp_fill_host.argtypes = [p, p, p, p, p, i64, i, i, i, i, f64, f64, i, i, i, i, i,
                                 p, p, p, p, p, p, p, i, i, i, i]
    lib.dp_fill_host.restype = i
    lib.dp_fill_lone_host.argtypes = [p, p, p, p, p, i64, i, i, i, i, f64, f64, i, i,
                                      p, p, p, p, p, i, i, i]
    lib.dp_fill_lone_host.restype = i
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("fill"))


def host_fill(lib, q, qlen, t, tlen, mat, del_, ext, *, mode, track=True, dirs=False,
              plane=False, card=H100, warps=None, smem_mat=True):
    """One run of the host build, laid out as ``ops/dp_fill._launch`` lays
    out a launch; returns (fmax, fy, fx, end, words, plane)."""
    is_pwm = mode == "pwm"
    B, R = t.shape
    C = mat.shape[-1] if is_pwm else q.shape[1]
    R8 = round8(R)
    V = mat.shape[-2]
    dtype = mat.dtype
    track = track or mode == "global" or plane
    mat_bytes = mat.numel() * mat.element_size() if smem_mat and mat.dim() == 2 else 0
    p = plan_fill(R8, mat.element_size(), B, card, mat_bytes, warps=warps)
    S = p.rows_on_chip
    tT = torch.zeros((R8, B), dtype=torch.int32)
    tT[:R] = t.T
    qT = None if is_pwm else q.T.contiguous()
    spill = torch.full((R8 + 1 - S, B), 7.0, dtype=dtype) if S <= R8 else None
    out = [torch.full((B,), -1.0, dtype=dtype), torch.full((B,), -1, dtype=torch.int32),
           torch.full((B,), -1, dtype=torch.int32), torch.full((B,), -1.0, dtype=dtype)]
    words = torch.full((B, R8 // 8, C), -1, dtype=torch.int32) if dirs else None
    pl = torch.full((B, C, R8), 5.0, dtype=dtype) if dirs and plane else None

    def ptr(a):
        return None if a is None else a.data_ptr()

    err = lib.dp_fill_host(
        ptr(qT), tT.data_ptr(), None if is_pwm else qlen.data_ptr(), tlen.data_ptr(),
        mat.data_ptr(), mat[0].numel() if mat.dim() == 3 else 0, V, B, C, R8,
        float(del_), float(ext), int(dtype == torch.float64), int(is_pwm),
        int(mode == "global"), int(track), int(dirs), ptr(spill), *(o.data_ptr() for o in out),
        ptr(words), ptr(pl), p.threads, S, int(p.mat_bytes > 0), p.smem_bytes)
    assert err == 0
    return (*out, words, pl), S


def host_lone(lib, q, qlen, t, tlen, mat, del_, ext, *, mode, in_turn, smem_mat=True):
    """One run of the host build of the lone design, laid out as
    ``ops/dp_fill._launch`` lays out its launch: the kernel (``in_turn``
    False) or its steps in turn; returns (fmax, fy, fx, end, words)."""
    B, R = t.shape
    C = q.shape[1]
    R8 = round8(R)
    V = mat.shape[-1]
    own = (mat[0].numel() if mat.dim() == 3 else mat.numel()) * mat.element_size()
    p = plan_fill(R8, mat.element_size(), B, H100, 0, own_mat_bytes=own if smem_mat else 0,
                  lone=True)
    assert p.lone and p.threads == 64 and p.mat_bytes == (own if smem_mat else 0)
    tT = torch.zeros((R8, B), dtype=torch.int32)
    tT[:R] = t.T
    qT = q.T.contiguous()
    out = [torch.full((B,), -1.0, dtype=mat.dtype), torch.full((B,), -1, dtype=torch.int32),
           torch.full((B,), -1, dtype=torch.int32), torch.full((B,), -1.0, dtype=mat.dtype)]
    words = torch.full((B, R8 // 8, C), -1, dtype=torch.int32)
    err = lib.dp_fill_lone_host(
        qT.data_ptr(), tT.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), mat.data_ptr(),
        mat[0].numel() if mat.dim() == 3 else 0, V, B, C, R8, float(del_), float(ext),
        int(mat.dtype == torch.float64), int(mode == "global"), *(o.data_ptr() for o in out),
        words.data_ptr(), int(p.mat_bytes > 0), p.smem_bytes, int(in_turn))
    assert err == 0
    return (*out, words)


def plain_fill(q, qlen, t, tlen, mat, del_, ext, *, mode, track=True, dirs=False,
               plane=False):
    kw = dict(track_argmax=track, with_dirs=dirs, with_scores_plane=plane)
    if mode == "pwm":
        r = fill_pwm_batch(t, tlen, mat, del_, ext, **kw)
    else:
        r = fill_batch(q, qlen, t, tlen, mat, del_, ext, mode=mode, **kw)
    return r.fmax, r.fy, r.fx, r.end, r.words, r.plane


def assert_same(got, want):
    names = ("fmax", "fy", "fx", "end", "words", "plane")
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def ragged(rng, B, C, R, V=24):
    q = rng.integers(0, V, (B, C))
    t = rng.integers(0, V, (B, R))
    ql = rng.integers(1, C + 1, B)
    tl = rng.integers(1, R + 1, B)
    ql[0], tl[1] = 0, 0  # empty problems are inert
    ql[2], tl[2] = C, R  # and one that fills the whole plane
    for b in range(B):
        q[b, ql[b]:] = 0
        t[b, tl[b]:] = 0
    return [torch.as_tensor(a, dtype=torch.int32) for a in (q, ql, t, tl)]


def pwm_batch(rng, B, R, W, batched, dtype):
    q = rng.integers(0, 4, (B, R))
    ql = rng.integers(0, R + 1, B)
    ql[1] = R
    for b in range(B):
        q[b, ql[b]:] = 0
    shape = (B, 4, W) if batched else (4, W)
    pwm = rng.normal(0.0, 3.0, shape)
    if dtype == torch.float32:
        pwm = np.round(pwm)
    return (torch.as_tensor(q, dtype=torch.int32), torch.as_tensor(ql, dtype=torch.int32),
            torch.as_tensor(pwm, dtype=dtype))


# every instance the library builds: (track, dirs, plane)
LOCAL = [(False, False, False), (True, False, False), (False, True, False),
         (True, True, False), (True, True, True)]
GLOBAL = [(True, False, False), (True, True, False), (True, True, True)]
CASES = ([("local", *c) for c in LOCAL] + [("global", *c) for c in GLOBAL])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode,track,dirs,plane", CASES,
                         ids=[f"{m}-t{int(a)}d{int(b)}p{int(c)}" for m, a, b, c in CASES])
def test_fill_body_on_a_ragged_batch(host, mode, track, dirs, plane, dtype):
    rng = np.random.default_rng(len(CASES) * int(dtype == torch.float64) + CASES.index(
        (mode, track, dirs, plane)))
    q, ql, t, tl = ragged(rng, 40, 21, 27)
    m = torch.as_tensor(np.array(blosum62()), dtype=dtype)
    kw = dict(mode=mode, track=track, dirs=dirs, plane=plane)
    got, S = host_fill(host, q, ql, t, tl, m, 11.0, 1.0, **kw)
    assert S == 33  # the whole column on chip
    assert_same(got, plain_fill(q, ql, t, tl, m, 11.0, 1.0, **kw))


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fill_body_with_spilled_columns(host, mode, dtype):
    """A card with room for S = 9 or 17 rows a column: the rest of each
    column lives in the device buffer, the plane is still whole."""
    rng = np.random.default_rng(7 + int(dtype == torch.float64))
    q, ql, t, tl = ragged(rng, 37, 19, 45)
    m = torch.as_tensor(np.array(blosum62()), dtype=dtype)
    kw = dict(mode=mode, dirs=True, plane=True)
    got, S = host_fill(host, q, ql, t, tl, m, 10.0, 1.0, card=SMALL, smem_mat=False, **kw)
    assert S < round8(45) + 1
    assert_same(got, plain_fill(q, ql, t, tl, m, 10.0, 1.0, **kw))


@pytest.mark.parametrize("warps", [2, 4])
def test_fill_body_in_blocks_of_several_warps(host, warps):
    """Blocks of 64 and 128 threads: the shared matrix copied by all of them
    before the barrier, each warp's columns and codes at their offsets."""
    rng = np.random.default_rng(warps)
    q, ql, t, tl = ragged(rng, 150, 17, 23)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32)
    for mode in ("local", "global"):
        kw = dict(mode=mode, dirs=True, plane=True)
        got, _ = host_fill(host, q, ql, t, tl, m, 11.0, 2.0, warps=warps, **kw)
        assert_same(got, plain_fill(q, ql, t, tl, m, 11.0, 2.0, **kw))


def test_fill_body_with_per_problem_matrices(host):
    rng = np.random.default_rng(11)
    q, ql, t, tl = ragged(rng, 35, 16, 30)
    mats = torch.as_tensor(rng.normal(0.0, 3.0, (35, 24, 24)))
    for mode in ("local", "global"):
        kw = dict(mode=mode, dirs=True, plane=True)
        got, _ = host_fill(host, q, ql, t, tl, mats, 3.5, 1.25, **kw)
        assert_same(got, plain_fill(q, ql, t, tl, mats, 3.5, 1.25, **kw))


PWM_CASES = [(False, False, False), (True, False, False), (False, True, False),
             (True, True, False), (True, True, True)]


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per-problem"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("track,dirs,plane", PWM_CASES,
                         ids=[f"t{int(a)}d{int(b)}p{int(c)}" for a, b, c in PWM_CASES])
def test_fill_body_in_pwm_mode(host, batched, dtype, track, dirs, plane):
    rng = np.random.default_rng(PWM_CASES.index((track, dirs, plane)) + 10 * int(batched))
    q, ql, pwm = pwm_batch(rng, 45, 29, 13, batched, dtype)
    kw = dict(mode="pwm", track=track, dirs=dirs, plane=plane)
    got, _ = host_fill(host, None, None, q, ql, pwm, 3.0, 1.0, **kw)
    assert_same(got, plain_fill(None, None, q, ql, pwm, 3.0, 1.0, **kw))


def test_fill_body_in_pwm_mode_with_spilled_columns(host):
    rng = np.random.default_rng(5)
    q, ql, pwm = pwm_batch(rng, 33, 50, 11, False, torch.float64)
    kw = dict(mode="pwm", dirs=True, plane=True)
    got, S = host_fill(host, None, None, q, ql, pwm, 3.0, 1.0, card=SMALL, smem_mat=False,
                       **kw)
    assert S < round8(50) + 1
    assert_same(got, plain_fill(None, None, q, ql, pwm, 3.0, 1.0, **kw))


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_a_fault_in_the_plane_store_is_caught(tmp_path, name):
    with open(os.path.join(CSRC, "dp_fill_core.cuh")) as fh:
        core = fh.read()
    old, new = MUTATIONS[name]
    assert core.count(old) == 1, f"the anchor of {name!r} is not in the body once"
    lib = _compile(tmp_path, core.replace(old, new))
    rng = np.random.default_rng(3)
    q, ql, t, tl = ragged(rng, 33, 12, 16)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float64)
    kw = dict(mode="local", dirs=True, plane=True)
    got, _ = host_fill(lib, q, ql, t, tl, m, 11.0, 1.0, **kw)
    want = plain_fill(q, ql, t, tl, m, 11.0, 1.0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))
    assert not torch.equal(got[5], want[5])


def tie_batch(rng, B, C, R):
    """Ragged problems on a matrix of -1, 0 and 1 whose symbol 0 scores 0
    against every symbol, and queries that start with three 0s: with
    penalties 1 and 1 many cells tie in their directions and many columns
    in their maxima, and a local fill's first three columns hold 0 alone."""
    q, ql, t, tl = ragged(rng, B, C, R, V=5)
    q[:, :3] = 0
    m = rng.integers(-1, 2, (5, 5)).astype(np.float64)
    m[:, 0] = 0.0
    return q, ql, t, tl, m


SCHEDULES = ["kernel", "in-turn"]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_lone_body_on_a_ragged_batch(host, dtype, mode, schedule):
    """tl < R8 and ql < C, rows not a multiple of 8 (R = 37), empty
    problems, the shared matrix in shared memory."""
    rng = np.random.default_rng(31 + int(dtype == torch.float64) + 2 * (mode == "global"))
    q, ql, t, tl = ragged(rng, 19, 21, 37)
    m = torch.as_tensor(np.array(blosum62()), dtype=dtype)
    got = host_lone(host, q, ql, t, tl, m, 11.0, 1.0, mode=mode,
                    in_turn=schedule == "in-turn")
    assert_same(got, plain_fill(q, ql, t, tl, m, 11.0, 1.0, mode=mode, dirs=True)[:5])


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_lone_body_with_ties_and_a_zero_column(host, dtype, mode, schedule):
    rng = np.random.default_rng(41 + int(dtype == torch.float64) + 2 * (mode == "global"))
    q, ql, t, tl, m = tie_batch(rng, 23, 17, 30)
    m = torch.as_tensor(m, dtype=dtype)
    want = plain_fill(q, ql, t, tl, m, 1.0, 1.0, mode=mode, dirs=True)[:5]
    if mode == "local":
        # column 1 of the problem that fills its plane holds 0 alone: every word BEG
        assert torch.all(want[4][2, :, 0] == 0xFFFF)
    got = host_lone(host, q, ql, t, tl, m, 1.0, 1.0, mode=mode, in_turn=schedule == "in-turn")
    assert_same(got, want)


@pytest.mark.parametrize("smem_mat", [True, False], ids=["smem", "l1"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode", ["local", "global"])
def test_lone_body_with_per_problem_matrices(host, mode, schedule, smem_mat):
    """The population's case: each problem's own f64 (V, V) matrix, copied
    to shared memory or read where it lies."""
    rng = np.random.default_rng(51 + 2 * (mode == "global") + int(smem_mat))
    q, ql, t, tl = ragged(rng, 13, 16, 29)
    mats = torch.as_tensor(rng.normal(0.0, 3.0, (13, 24, 24)))
    got = host_lone(host, q, ql, t, tl, mats, 3.5, 1.25, mode=mode,
                    in_turn=schedule == "in-turn", smem_mat=smem_mat)
    assert_same(got, plain_fill(q, ql, t, tl, mats, 3.5, 1.25, mode=mode, dirs=True)[:5])


def test_lone_body_with_a_shared_matrix_read_where_it_lies(host):
    rng = np.random.default_rng(61)
    q, ql, t, tl = ragged(rng, 9, 12, 43)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32)
    got = host_lone(host, q, ql, t, tl, m, 10.0, 1.0, mode="local", in_turn=False,
                    smem_mat=False)
    assert_same(got, plain_fill(q, ql, t, tl, m, 10.0, 1.0, mode="local", dirs=True)[:5])


@pytest.mark.parametrize("name", list(LONE_MUTATIONS))
def test_a_fault_in_the_lone_companion_is_caught(tmp_path, name):
    with open(os.path.join(CSRC, "dp_fill_core.cuh")) as fh:
        core = fh.read()
    old, new = LONE_MUTATIONS[name]
    assert core.count(old) == 1, f"the anchor of {name!r} is not in the body once"
    lib = _compile(tmp_path, core.replace(old, new))
    rng = np.random.default_rng(71)
    q, ql, t, tl, m = tie_batch(rng, 11, 14, 20)
    m = torch.as_tensor(m, dtype=torch.float64)
    got = host_lone(lib, q, ql, t, tl, m, 2.0, 1.0, mode="local", in_turn=False)
    want = plain_fill(q, ql, t, tl, m, 2.0, 1.0, mode="local", dirs=True)[:5]
    assert not all(torch.equal(a, b) for a, b in zip(got, want))
