"""The port's C++ host runtime (``aligner_tpu_torch/native.py``) on the
inputs of the reference's ``tests/test_native.py``: bit-identity with
``aligner_tpu/oracle.py``, the batched traceback, the codecs, the host
route of a large pair and the padded batch's host walk, each also against
the JAX package where it has the same entry point.  Every test runs twice:
on the library the package loads, and on one built into the port's own
cache directory (``~/.cache/aligner-tpu-torch/``), where the library goes
when the package directory cannot take it."""

import time

import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu import oracle
from aligner_tpu.alphabet import DNA, Protein
from aligner_tpu.matrices import blosum62, random_pwm
from aligner_tpu_torch import native

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["package", "cache"], autouse=True)
def library(request, tmp_path_factory):
    """The native library the module's tests run on: the package's, or one
    built into the cache of a fresh HOME (the package directory refusing
    the build)."""
    if request.param == "package":
        if not native.available():
            pytest.skip("native library unavailable (no g++?)")
        yield request.param
        return
    root = tmp_path_factory.mktemp("native_cache")
    home, pkg = root / "home", root / "pkg"
    home.mkdir()
    pkg.mkdir()
    real_build = native._build
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(home))
        mp.delenv("ALIGNER_NO_NATIVE", raising=False)
        mp.setattr(native, "_PKG_DIR", str(pkg))
        mp.setattr(native, "_build", lambda so: not so.startswith(str(pkg)) and real_build(so))
        mp.setattr(native, "_TRIED", False)
        mp.setattr(native, "_LIB", None)
        if not native.available():
            pytest.skip("native library unavailable (no g++?)")
        assert (home / ".cache" / "aligner-tpu-torch" / "_aligner_native.so").exists()
        assert not (pkg / "_aligner_native.so").exists()
        yield request.param


def test_fill_bit_identity_fuzz(rng):
    M = np.asarray(blosum62())
    for _ in range(15):
        ql, tl = rng.integers(1, 50, 2)
        q = rng.integers(0, 24, ql).astype(np.int8)
        t = rng.integers(0, 24, tl).astype(np.int8)
        d, e = float(rng.integers(1, 15)), float(rng.integers(1, 5))
        mx = M + rng.normal(size=(24, 24))
        for mode, fn in [("local", oracle.fill_local), ("global", oracle.fill_global)]:
            p_n, d_n = native.fill(q, t, mx, d, e, mode)
            p_o, d_o = fn(q, t, mx, d, e)
            assert np.array_equal(p_n, p_o)
            assert np.array_equal(d_n, d_o)


def test_pwm_fill_and_argmax(rng):
    pwm = random_pwm(11, rng)
    q = rng.integers(0, 4, 30).astype(np.int8)
    p_n, d_n = native.fill(q, None, pwm, 3.0, 1.0, "pwm")
    p_o, d_o = oracle.fill_pwm(q, pwm, 3.0, 1.0)
    assert np.array_equal(p_n, p_o)
    assert np.array_equal(d_n, d_o)
    assert native.argmax_first_rowmajor(p_n) == oracle.argmax_first_rowmajor(p_o)


def test_traceback_batch_matches_python(rng):
    M = np.asarray(blosum62())
    B, L = 6, 20
    q = rng.integers(0, 24, (B, L)).astype(np.int8)
    t = rng.integers(0, 24, (B, L)).astype(np.int8)
    dirs = np.zeros((B, L + 1, L + 1), np.uint8)
    sy = np.zeros(B, np.int64)
    sx = np.zeros(B, np.int64)
    expected = []
    for b in range(B):
        plane, d = oracle.fill_local(q[b], t[b], M, 11.0, 2.0)
        dirs[b] = d
        my, mx = oracle.argmax_first_rowmajor(plane)
        sy[b], sx[b] = my, mx
        qa = [int(q[b][mx - 1])]
        ta = [int(t[b][my - 1])]
        cy, cx = oracle._walk(d, my, mx, q[b], t[b], qa, ta, pwm_mode=False)
        qa.reverse()
        ta.reverse()
        expected.append((qa, ta, cy, cx))
    wq, wt, ey, ex = native.traceback_batch(dirs, sy, sx, q, t, pwm_mode=False)
    for b in range(B):
        qa, ta, cy, cx = expected[b]
        got_q = list(wq[b]) + [int(q[b][sx[b] - 1])]
        got_t = list(wt[b]) + [int(t[b][sy[b] - 1])]
        assert got_q == qa
        assert got_t == ta
        assert (int(ey[b]), int(ex[b])) == (cy, cx)


def test_encode_matches_python():
    raw = b"ATCGNNATXXCGQQQA"
    codes, counts, idx = native.encode(raw, DNA._enc_lut, 4)
    c2, f2, idx2 = DNA.encode_with_freqs_and_indices(raw)
    assert np.array_equal(codes, c2)
    assert np.array_equal(counts / max(len(codes), 1), f2)
    # native emits ascending coords; the engine consumes descending
    assert [(c, o, l) for (c, o, l) in reversed(idx)] == [
        (i.coord, i.offset, i.local_offset) for i in idx2
    ]
    pcodes = Protein.encode("ARND", strict=True)
    ncodes, _, _ = native.encode(b"ARND", Protein._enc_lut, 24)
    assert np.array_equal(pcodes, ncodes)
    from aligner_tpu import native as ref_native

    if ref_native.available():
        for got, want in zip(native.encode(raw, DNA._enc_lut, 4),
                             ref_native.encode(raw, DNA._enc_lut, 4)):
            assert np.array_equal(np.asarray(got), np.asarray(want))


def test_host_align_large_pair_fast():
    """A chromosome-ish single pair on the host route (the port's native
    engine, asked for by name: ``device=None`` means the card)."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 24, 700).astype(np.int8)
    t = rng.integers(0, 24, 700).astype(np.int8)
    t0 = time.time()
    res = port.align_local(q, t, port.blosum62(), 11.0, 2.0, device="host")
    assert time.time() - t0 < 2.0
    want = ref.align_local(q, t, ref.blosum62(), 11.0, 2.0, backend="xla")
    assert res.alignment.f == want.alignment.f
    assert np.array_equal(res.alignment.query, want.alignment.query)
    assert np.array_equal(res.alignment.target, want.alignment.target)
    assert res.alignment.coords == want.alignment.coords


def test_batch_align_pad_to_with_alignments(rng):
    """pad_to padding (ql=tl=0, fy=fx=0) must not trip the native
    traceback's empty-result check: the padded slots are internal and only
    the n_real alignments come back (the host walk, ``walk="host"``, runs
    ``native.traceback_batch``)."""
    qs = [rng.integers(0, 24, 30).astype(np.int8) for _ in range(2)]
    ts = [rng.integers(0, 24, 30).astype(np.int8) for _ in range(2)]
    for mode in ("local", "global"):
        kw = dict(mode=mode, device="cpu", with_alignments=True, walk="host")
        out = port.batch_align(qs, ts, port.blosum62(), 11.0, 2.0, pad_to=8, **kw)
        assert len(out) == 2
        unpadded = port.batch_align(qs, ts, port.blosum62(), 11.0, 2.0, **kw)
        want = ref.batch_align(qs, ts, ref.blosum62(), 11.0, 2.0, mode=mode, backend="xla",
                               with_alignments=True, pad_to=8)
        for a, b, c in zip(out, unpadded, want):
            for other in (b, c):
                assert a.alignment.f == other.alignment.f
                assert np.array_equal(a.alignment.query, other.alignment.query)
                assert np.array_equal(a.alignment.target, other.alignment.target)
                assert a.alignment.coords == other.alignment.coords
