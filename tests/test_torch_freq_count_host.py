"""The population's frequency count kernel's own body
(``csrc/freq_count.cu`` on ``csrc/count_core.cuh``, the body it shares
with the counting walk) on the CPU: the kernel compiled with g++ beside
``tests/freq_count_host.cpp``, which runs every lane as a thread and
emulates the warp shuffles and the shared-memory atomics
(``tests/warp_host.h``), so that the rounds of 32 words, the warp scan of
the cursor, each lane's replay of its codes and the seed pair run as the
card runs them.  Held against the plain version (``count_pairs_plain``),
exactly, on the cases ``chip_smoke.py`` holds the card to: the
population's shape (64 members, V = 24, 689 steps), done members, walks
of the full S, walks that stay on the plane into their second round,
members not alive, M not a multiple of a block's warps, V = 4, and
streams on real walks of the plain fill.  Each of ``MUTATIONS``, a
deliberate fault in the kernel's text, must make it disagree on one of
those cases, so that the cases are shown to see such faults."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aligner_tpu_torch.ops import device_walk as dw
from aligner_tpu_torch.ops import freq_count as fc
from aligner_tpu_torch.ops.scan_engine import fill_batch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "aligner_tpu_torch", "csrc")


# name -> [(text of csrc/count_core.cuh, its replacement)]: faults the cases
# must catch
MUTATIONS = {
    # the cursor from the inclusive scan, not the exclusive one
    "inclusive-cursor": [("int cy = y - (su - up), cx = x - (sl - lf);",
                          "int cy = y - su, cx = x - sl;")],
    # the round's moves not carried to the next round
    "no-carry": [("        y -= __shfl_sync(FULL, su, 31);\n"
                  "        x -= __shfl_sync(FULL, sl, 31);", "")],
    # the last round of words left out
    "short-rounds": [("w0 < words && 16 * w0 < nm", "w0 + 32 < words && 16 * w0 < nm")],
    # the target char of the row below the cursor's
    "row-off-by-one": [("tm[clip(cy - 1, R - 1)]", "tm[clip(cy, R - 1)]")],
    # the seed pair of a member that is not alive
    "stale-seed": [("alive && sy > 0", "sy > 0")],
    # (query char, target char) for (target char, query char)
    "swapped-pair": [("&counts[tm[clip(cy - 1, R - 1)] * V + qm[clip(cx - 1, C - 1)]]",
                      "&counts[qm[clip(cx - 1, C - 1)] * V + tm[clip(cy - 1, R - 1)]]")],
}


def mutated_source(name: str) -> str:
    """``count_core.cuh`` with mutation ``name``'s replacements; each anchor
    must occur in it exactly once."""
    with open(os.path.join(CSRC, "count_core.cuh")) as fh:
        src = fh.read()
    for old, new in MUTATIONS[name]:
        assert src.count(old) == 1, f"{name}: anchor {old[:60]!r} occurs {src.count(old)} times"
        src = src.replace(old, new)
    return src


def build(out_dir, kernel_dir=CSRC) -> ctypes.CDLL:
    """The host build of the kernel in ``kernel_dir/freq_count.cu`` (the
    body it includes from the same directory, the other headers from
    ``csrc/``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(out_dir / "freq_count_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-I",
                    str(kernel_dir), "-I", CSRC, "-o", so,
                    os.path.join(HERE, "freq_count_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.freq_count_host.argtypes = [p, i, p, p, p, p, i, p, i, p, i, i, p]
    lib.freq_count_host.restype = i
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build(tmp_path_factory.mktemp("freq"))


def host_count(lib, steps, n, sy, sx, q, t, alive, V):
    M = steps.shape[1]
    out = torch.full((M, V, V), -1, dtype=torch.int32)
    err = lib.freq_count_host(steps.data_ptr(), steps.shape[0], n.data_ptr(), sy.data_ptr(),
                              sx.data_ptr(), q.data_ptr(), q.shape[1], t.data_ptr(),
                              t.shape[1], alive.data_ptr(), M, V, out.data_ptr())
    assert err == 0
    return out


def same_counts(lib, case, V):
    got = host_count(lib, *case, V)
    want = fc.count_pairs_plain(*case, V)
    assert torch.equal(got, want)
    return want


def ragged_case(name):
    M, R, C, V, kind, done, stale = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return fc.ragged_streams(rng, M, R, C, V, kind=kind, done_frac=done,
                             stale_frac=stale), V


CASES = {
    # (M, R, C, V, kind, done share, stale share): the population (64
    # members of 344 x 344 padded codes, S = 689: two rounds of 32 words),
    # done members, full walks, walks that stay on the plane into their
    # second round, members not alive with a stream, M not a multiple of 4,
    # 4 symbols, one round exactly
    "population": (64, 344, 344, 24, "random", 0.0, 0.0),
    "population-done": (64, 344, 344, 24, "random", 0.4, 0.0),
    "full-S": (64, 344, 344, 24, "full", 0.0, 0.0),
    "in-plane": (64, 344, 344, 24, "in-plane", 0.2, 0.0),
    "stale": (40, 120, 96, 24, "in-plane", 0.0, 0.5),
    "M-ragged": (7, 40, 56, 24, "full", 0.3, 0.0),
    "V4": (33, 120, 100, 4, "random", 0.2, 0.0),
    "one-round": (5, 255, 256, 24, "full", 0.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_kernel_equals_plain(host, case):
    want = same_counts(host, *ragged_case(case))
    assert int(want.sum()) > 0


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_count_kernel_mutation_is_caught(tmp_path, name):
    """The kernel with one deliberate fault disagrees with the plain version
    on at least one of the cases."""
    shutil.copy(os.path.join(CSRC, "freq_count.cu"), tmp_path)
    (tmp_path / "count_core.cuh").write_text(mutated_source(name))
    lib = build(tmp_path, tmp_path)
    for case in sorted(CASES):
        args, V = ragged_case(case)
        if not torch.equal(host_count(lib, *args, V), fc.count_pairs_plain(*args, V)):
            return
    pytest.fail(f"mutation {name} agrees with the plain version on every case")


def test_count_kernel_on_walks_of_the_plain_fill(host):
    """Streams of real local walks: the plain fill's words and argmax cells
    and the plain walk, some members done (zero length), as one population
    iteration gives them."""
    rng = np.random.default_rng(7)
    M, L, V = 12, 40, 24
    base = rng.integers(0, V, L)
    t = np.tile(base, (M, 1))
    flip = rng.random((M, L)) < 0.3
    t[flip] = rng.integers(0, V, int(flip.sum()))
    q = np.tile(base, (M, 1))
    done = np.arange(M) % 4 == 3
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)
    ql = i32(np.where(done, 0, L))
    mats = torch.as_tensor(rng.normal(0.0, 3.0, (M, V, V)) + 4.0 * np.eye(V))
    r = fill_batch(i32(q), ql, i32(t), ql, mats, 5.0, 2.0, mode="local", with_dirs=True)
    S = 2 * L + 1
    steps, n, _, _ = dw.walk_plain(r.words, r.fy, r.fx, S=S, mode="local")
    case = (steps, n, r.fy, r.fx, i32(q), i32(t), torch.as_tensor(~done))
    want = same_counts(host, case, V)
    assert int(want[torch.as_tensor(done)].abs().sum()) == 0
    assert int(want[torch.as_tensor(~done)].sum()) > 0
