"""The port's end-score path against the JAX package, on the CPU: the plain
version of the band fill stream by stream against the Pallas band kernel in
interpret mode, ``end_score_single_global_diag`` against the JAX one and
the oracle on the cases of ``tests/test_wavefront_diag.py``, a grid of
blocks with a streamed left boundary against the host engine's plane, the
lane-0 diagonal regression, and ``global_end_score``/``local_max_score``
with their routing and errors.  Tolerance: none.  Every compared value is
an int32 score or an exactly representable float; slots of the streams
that no cell of a real column feeds are unspecified on both sides and not
compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.ops import wavefront as ref_wf
from aligner_tpu.ops.pallas_dp import lut_params
from aligner_tpu_torch import host, native, oracle
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.parallel import wavefront_sp as sp

torch.set_num_threads(1)

B62 = np.asarray(port.blosum62())
TB = TD = 128


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the JAX side would otherwise see conftest's 8 devices and shard
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def _pair(seed, C, R, V=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, C).astype(np.int8), rng.integers(0, V, R).astype(np.int8)


def _wide_matrix(seed, V=4, lo=-30, hi=30):
    m = np.random.default_rng(seed).integers(lo, hi, (V, V)).astype(np.float64)
    assert m.max() - m.min() > 15  # past the nibble table: the byte table
    return m


def _jax_band(args, Cb, ext, matrix, with_rc):
    """The Pallas band kernel in interpret mode on the port's flat streams:
    (rb, rc, end) as flat numpy arrays."""
    t_band, qs, f, c1, c2, fd, _, scal = args
    V = matrix.shape[0]
    if lut_params(matrix)[1] == 4:
        pmat, bias = ref_wf.pack_matrix_nibbles(matrix.T)
        lut_bits, bias2 = 4, bias + 2 * ext
    else:
        pmat, lut_bits, bias2 = np.asarray(ref_wf.pack_matrix_words(matrix.T)), 8, 2 * ext - 128
    D = qs.numel()
    chunks = lambda a: jnp.asarray(a.numpy().reshape(D // TD, 1, TD))  # noqa: E731
    rb, rc, end = ref_wf.run_block_band(
        jnp.asarray(t_band.numpy().reshape(-1, ref_wf.LANES)), chunks(qs), chunks(f),
        chunks(c1), chunks(c2), chunks(fd), jnp.asarray(pmat),
        jnp.asarray([[int(v) for v in scal]], jnp.int32),
        S=t_band.numel() // ref_wf.LANES, TD=TD, V=V, Cb=Cb, ext=ext, lut_bits=lut_bits,
        bias2=bias2, interpret=True, with_rc=with_rc)
    return np.asarray(rb).reshape(-1), np.asarray(rc).reshape(-1), int(np.asarray(end)[0, 0])


BAND_CASES = {
    "blosum62-band0": (B62, 11, 2, 140, 100, 0),
    "blosum62-band1": (B62, 11, 2, 140, 200, 1),
    "blosum62-last-band-short": (B62, 7, 3, 129, 257, 2),
    "byte-range-band0": (_wide_matrix(1), 5, 2, 150, 170, 0),
    "byte-range-band1": (_wide_matrix(1), 5, 2, 150, 170, 1),
    "byte-range-protein": (_wide_matrix(2, 24, -100, 100), 11, 2, 100, 130, 1),
}


@pytest.mark.parametrize("with_rc", [True, False], ids=["rc", "norc"])
@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_plain_matches_pallas_kernel_stream_by_stream(case, with_rc):
    m, d, e, C, R, jb = BAND_CASES[case]
    q, t = _pair(C + R, C, R, m.shape[0])
    pp = wf._prep(q, t, m, d, e, "cpu")
    bands = []
    wf._band_end_score(pp, TB, TD, 1, trace=bands)
    args, kw, _ = bands[jb]
    rb, rc, end = wf.run_block_band_plain(*args, **kw, with_rc=with_rc)
    rb_r, rc_r, end_r = _jax_band(args, kw["Cb"], e, m, with_rc)
    # slot k >= TB - 1 is the last row on column k + 2 - TB: real up to C
    real = slice(TB - 1, TB - 1 + C)
    assert np.array_equal(rb.numpy()[real], rb_r[real])
    assert int(end) == end_r
    if with_rc:
        # the right column is column Cb: real only when the query fills it
        assert rc.dtype == torch.int32 and rc.shape == (TB,)
        if C == kw["Cb"]:
            assert np.array_equal(rc.numpy(), rc_r)
    else:
        assert not rc.any() and not rc_r.any()
    # the last row, out of its hat, is the oracle's row
    y = min((jb + 1) * TB, R)
    if y == (jb + 1) * TB:
        H = oracle.align_global(q, t, m, float(d), float(e)).score
        k = np.arange(TB - 1, TB - 1 + C)
        assert np.array_equal(rb.numpy()[k] - (k + 1) * e, H[y, 1:])


def test_band_plain_right_column_matches_pallas_kernel():
    """A query that fills its padded width: every row's right-column cell is
    real, in both packages and in the oracle."""
    q, t = _pair(7, 256, 200)
    pp = wf._prep(q, t, B62, 11, 2, "cpu")
    assert pp["C_pad"] == 256
    bands = []
    wf._band_end_score(pp, TB, TD, 1, trace=bands)
    H = oracle.align_global(q, t, B62, 11.0, 2.0).score
    for jb, (args, kw, _) in enumerate(bands):
        _, rc, _ = wf.run_block_band_plain(*args, **kw, with_rc=True)
        assert np.array_equal(rc.numpy(), _jax_band(args, 256, 2, B62, True)[1])
        n = min(TB, 200 - jb * TB)
        assert np.array_equal(rc.numpy()[:n], H[jb * TB + 1 : jb * TB + 1 + n, 256])


def _end_scores(q, t, m, d, e, tb=TB, td=TD):
    got = wf.end_score_single_global_diag(q, t, m, d, e, tb=tb, td=td, device="cpu")
    want = ref_wf.end_score_single_global_diag(q, t, m, d, e, tb=tb, td=td, interpret=True)
    assert isinstance(got, float) and got == want
    return got


FUZZ = [tuple(int(v) for v in np.random.default_rng(100 + i).integers(1, 300, 2))
        for i in range(8)]


@pytest.mark.parametrize("C,R", FUZZ, ids=[f"{c}x{r}" for c, r in FUZZ])
def test_end_score_fuzz_parity(C, R):
    q, t = _pair(C * 1000 + R, C, R)
    assert _end_scores(q, t, B62, 11.0, 2.0) == host.align_global(
        q, t, B62, 11.0, 2.0).score[R, C]


@pytest.mark.parametrize("C", [127, 128, 129])
@pytest.mark.parametrize("R", [127, 128, 129, 256, 257])
def test_end_score_band_and_chunk_seams(R, C):
    """Row counts at and one past the band height, widths at and one past
    the chunk length: the hand-off of the last row and the stream seams."""
    q, t = _pair(R * 1000 + C, C, R)
    assert _end_scores(q, t, B62, 7.0, 3.0) == host.align_global(
        q, t, B62, 7.0, 3.0).score[R, C]


@pytest.mark.parametrize("R,C", [(1, 1), (1, 200), (200, 1), (129, 1), (1, 129)])
def test_end_score_single_cell_and_degenerate(R, C):
    q, t = _pair(R * 1000 + C, C, R)
    assert _end_scores(q, t, B62, 11.0, 2.0) == oracle.align_global(
        q, t, B62, 11.0, 2.0).score[R, C]


def test_end_score_wide_range_matrix():
    m = _wide_matrix(3)
    q, t = _pair(8, 150, 170, 4)
    assert _end_scores(q, t, m, 5.0, 2.0) == host.align_global(
        q, t, m, 5.0, 2.0).score[170, 150]


@pytest.mark.parametrize("C,R", [(150, 200), (140, 190)])
def test_end_score_two_lengths_in_one_bucket(C, R):
    """Two pairs of one padded size (TB 256, the same stream length): the
    real lengths alone place the borders' far corners and the end cell."""
    q, t = _pair(C + R, C, R)
    assert _end_scores(q, t, B62, 11.0, 2.0, tb=256, td=512) == host.align_global(
        q, t, B62, 11.0, 2.0).score[R, C]


def test_end_score_refusals():
    z = np.zeros(5, np.int8)
    for q, t in ((z[:0], z), (z, z[:0])):
        with pytest.raises(ValueError):
            wf.end_score_single_global_diag(q, t, B62, 11.0, 2.0, device="cpu")
    with pytest.raises(ValueError):  # tb no multiple of 128, as in the JAX package
        wf.end_score_single_global_diag(z, z, B62, 11.0, 2.0, tb=100, device="cpu")
    with pytest.raises(ValueError):
        ref_wf.end_score_single_global_diag(z, z, B62, 11.0, 2.0, tb=100, interpret=True)
    with pytest.raises(ValueError):  # non-integral: the int32 engine does not take it
        wf.end_score_single_global_diag(z, z, B62 * 0.5, 11.0, 2.0, device="cpu")
    assert wf.NEG_I32 == ref_wf.NEG_I32 and wf.LANES == ref_wf.LANES


def test_band_wrapper_refuses_what_the_kernel_does_not_take():
    pp = wf._prep(*_pair(9, 40, 30), B62, 11, 2, "cpu")
    bands = []
    wf._band_end_score(pp, TB, TD, 1, trace=bands)
    (args, kw, _), = bands
    t_band, qs, f, c1, c2, fd, m, scal = args
    wf.run_block_band(*args, **kw)
    with pytest.raises(TypeError):
        wf.run_block_band(t_band.long(), *args[1:], **kw)
    with pytest.raises(ValueError):  # a stream shorter than the others
        wf.run_block_band(t_band, qs, f[:-1], *args[3:], **kw)
    with pytest.raises(ValueError):  # fewer slots than Cb + TB - 1 steps
        wf.run_block_band(t_band, *(a[:200] for a in args[1:6]), m, scal, **kw)
    with pytest.raises(ValueError):  # a target code outside the matrix
        wf.run_block_band(t_band + 24, *args[1:], **kw)
    with pytest.raises(ValueError):  # an owned end cell outside the band
        wf.run_block_band(*args[:7], (TB, 5, 1), **kw)


GRID_CASES = [(300, 200, 64, 128), (256, 130, 32, 128), (257, 129, 128, 100),
              (200, 200, 64, 100)]


@pytest.mark.parametrize("C,R,tb,cb", GRID_CASES, ids=[f"{c}x{r}-{a}x{b}"
                                                       for c, r, a, b in GRID_CASES])
def test_band_grid_streamed_left_boundary_matches_host_plane(C, R, tb, cb):
    """Column blocks at x0 > 0 take their left neighbour's right column as a
    streamed boundary: right columns, last rows and the end cell against the
    host engine's plane."""
    q, t = _pair(C + R + tb, C, R)
    H = host.align_global(q, t, B62, 11.0, 2.0).score
    end, rights, bottoms = sp.band_grid(q, t, B62, 11.0, 2.0, tb=tb, cb=cb, device="cpu",
                                        block=wf.run_block_band_plain)
    assert len(rights) == -(-C // cb) >= 2 and len(bottoms) == -(-R // tb) >= 2
    assert int(end) == H[R, C]
    for ci, col in enumerate(rights):
        x = (ci + 1) * cb
        if x <= C:
            assert np.array_equal(col.numpy()[:R], H[1 : R + 1, x])
    for jb, row in enumerate(bottoms):
        y = (jb + 1) * tb
        for ci, b in enumerate(row):
            n = min(cb, C - ci * cb)
            if y <= R:
                assert np.array_equal(b.numpy()[:n], H[y, ci * cb + 1 : ci * cb + 1 + n])


def test_band_grid_takes_a_pair_wider_than_one_plane(monkeypatch):
    """The width cap is one plane's: a grid of column blocks no wider than
    the cap holds a wider pair, and the single-plane prep still refuses it."""
    monkeypatch.setattr(wf, "MAX_WIDTH", 128)
    q, t = _pair(77, 300, 150)
    H = host.align_global(q, t, B62, 11.0, 2.0).score
    end, _, _ = sp.band_grid(q, t, B62, 11.0, 2.0, tb=128, cb=wf.MAX_WIDTH, device="cpu")
    assert int(end) == H[150, 300]
    with pytest.raises(ValueError):
        wf._prep(q, t, B62, 11.0, 2.0, "cpu")


LANE0 = [(2, 1), (2, 2), (3, 2), (4, 1), (1, 2), (5, 4)]


@pytest.mark.parametrize("C,R", LANE0, ids=[f"{c}x{r}" for c, r in LANE0])
def test_band_plain_lane0_diagonal_regression(C, R):
    """The correction for cell (1,1) in the ``f`` stream must not reach cell
    (1,2)'s diagonal: row 0 reads its diagonal from ``fd``.  Minimal shapes
    where the border terms compete with the first scores (del far above
    ext, a byte-range matrix)."""
    m = _wide_matrix(4, 4, -100, 100)
    rng = np.random.default_rng(C * 10 + R)
    for _ in range(4):
        q, t = rng.integers(0, 4, C).astype(np.int8), rng.integers(0, 4, R).astype(np.int8)
        H = host.align_global(q, t, m, 11.0, 2.0).score
        assert _end_scores(q, t, m, 11.0, 2.0) == H[R, C]
        pp = wf._prep(q, t, m, 11, 2, "cpu")
        bands = []
        wf._band_end_score(pp, TB, TD, 1, trace=bands)
        args, kw, _ = bands[0]
        if C >= 2:
            # H[1, 2] itself: the end cell of the one-row prefix of the pair
            scal = (0, 2, 1)
            _, _, end = wf.run_block_band_plain(*args[:7], scal, **kw, with_rc=False)
            assert int(end) == H[1, 2]
        # feeding the corrected stream to the diagonal is the fault this pins
        leaky = torch.cat([args[2].new_zeros(1), args[2][:-1]])
        assert not torch.equal(leaky, args[5])


# --- the entry points ---------------------------------------------------------


def test_global_end_score_auto_diag_host_match_reference():
    q, t = _pair(20, 150, 170)
    want = host.align_global(q, t, B62, 11.0, 2.0).score[170, 150]
    assert ref.global_end_score(q, t, ref.blosum62(), 11.0, 2.0) == want
    assert ref.global_end_score(q, t, ref.blosum62(), 11.0, 2.0, backend="diag") == want
    for backend in (None, "auto", "diag", "host"):
        got = port.global_end_score(q, t, port.blosum62(), 11.0, 2.0, backend=backend,
                                    device="cpu")
        assert isinstance(got, float) and got == want
    s = port.Protein.decode(q), port.Protein.decode(t)
    assert port.global_end_score(*s, port.blosum62(), 11.0, 2.0, device="cpu") == want


def test_global_end_score_auto_takes_the_band_engine_at_any_size(monkeypatch):
    """No size picks the host silently: a small supported pair runs on the
    band engine, the host engine only by name."""
    from aligner_tpu_torch import align as port_align

    assert not hasattr(port_align, "SMALL_PROBLEM_CELLS_NATIVE")
    calls = []
    real = wf.end_score_single_global_diag
    monkeypatch.setattr(wf, "end_score_single_global_diag",
                        lambda *a, **k: calls.append("diag") or real(*a, **k))
    real_host = host.align_global
    monkeypatch.setattr(host, "align_global",
                        lambda *a: calls.append("host") or real_host(*a))
    q, t = _pair(21, 6, 7)
    a = port.global_end_score(q, t, B62, 11.0, 2.0, device="cpu")
    b = port.global_end_score(q, t, B62, 11.0, 2.0, backend="host")  # needs no device
    assert calls == ["diag", "host"] and a == b


def test_global_end_score_errors_match_reference(monkeypatch):
    z5 = np.zeros(5, np.int8)
    half = np.full((24, 24), 0.5)
    for mod, kw in ((ref, {}), (port, dict(device="cpu"))):
        with pytest.raises(mod.ResultIsEmpty):
            mod.global_end_score(z5[:0], z5, B62, 11.0, 2.0, **kw)
        with pytest.raises(mod.ResultIsEmpty):
            mod.global_end_score(z5, z5[:0], B62, 11.0, 2.0, **kw)
        with pytest.raises(mod.ValidationError, match="unknown backend 'pallas'"):
            mod.global_end_score(z5, z5, B62, 11.0, 2.0, backend="pallas", **kw)
        with pytest.raises(mod.ValidationError, match="diag backend requires"):
            mod.global_end_score(z5, z5, half, 11.0, 2.0, backend="diag", **kw)
    with pytest.raises(ref.ValidationError) as want:
        ref.global_end_score(z5, z5, B62, 11.0, 2.0, backend="nope")
    with pytest.raises(port.ValidationError) as got:
        port.global_end_score(z5, z5, B62, 11.0, 2.0, backend="nope", device="cpu")
    assert str(got.value) == str(want.value)
    # the column-blocked route takes a narrow pair by name and a wide one by
    # its width, and refuses what its block engine does not take
    want = port.global_end_score(z5, z5, B62, 11.0, 2.0, device="cpu")
    assert port.global_end_score(z5, z5, B62, 11.0, 2.0, backend="wavefront_sp",
                                 device="cpu") == want
    with pytest.raises(port.ValidationError, match="wavefront_sp requires"):
        port.global_end_score(z5, z5, B62 * 0.5, 11.0, 2.0, backend="wavefront_sp",
                              device="cpu")
    monkeypatch.setattr(wf, "MAX_WIDTH", 3)
    assert port.global_end_score(z5, z5, B62, 11.0, 2.0, device="cpu") == want
    with pytest.raises(port.ValidationError, match="diag backend requires"):
        port.global_end_score(z5, z5, B62, 11.0, 2.0, backend="diag", device="cpu")


def test_global_end_score_non_integral_small_and_huge(monkeypatch):
    """A matrix the int32 engine does not take: a batch of one on the
    batched fill in float64 while a plane is affordable, refused above."""
    m = B62 * 0.37 - 0.11
    q, t = _pair(22, 33, 41)
    assert not wf.supported(len(q), m, 11.0, 2.0, tlen=len(t))
    got = port.global_end_score(q, t, m, 11.0, 2.0, device="cpu")
    assert got == ref.global_end_score(q, t, m, 11.0, 2.0)
    assert got == oracle.align_global(q, t, m, 11.0, 2.0).score[41, 33]
    assert port.global_end_score(q, t, B62, 11.5, 2.0, device="cpu") == \
        ref.global_end_score(q, t, B62, 11.5, 2.0)
    monkeypatch.setattr(ref_wf, "DIRECT_PLANE_CELLS", 1000)
    monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 1000)
    with pytest.raises(ref.ValidationError) as want:
        ref.global_end_score(q, t, m, 11.0, 2.0)
    with pytest.raises(port.ValidationError) as got_err:
        port.global_end_score(q, t, m, 11.0, 2.0, device="cpu")
    assert str(got_err.value).split(" (")[0] == str(want.value).split(" (")[0]
    # a supported pair past the budget still runs, on the band engine
    q, t = _pair(23, 80, 90)
    assert port.global_end_score(q, t, B62, 11.0, 2.0, device="cpu") == \
        ref.global_end_score(q, t, B62, 11.0, 2.0, backend="diag") == \
        host.align_global(q, t, B62, 11.0, 2.0).score[90, 80]


@pytest.mark.parametrize("budget", [None, 1000], ids=["batched", "streamed"])
def test_local_max_score_matches_reference(monkeypatch, budget):
    if budget:
        monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", budget)
    rng = np.random.default_rng(24)
    q = rng.integers(0, 24, 60).astype(np.int8)
    t = np.resize(q, 75).copy()
    t[rng.random(75) < 0.25] = 3
    want = ref.local_max_score(q, t, ref.blosum62(), 11.0, 2.0)
    got = port.local_max_score(q, t, port.blosum62(), 11.0, 2.0, device="cpu")
    assert got == want and isinstance(got[0], float)
    assert all(isinstance(v, int) for v in got[1])
    assert port.local_max_score(q, t, B62, 11.0, 2.0, device="host") == want
    o = oracle.align_local(q, t, B62, 11.0, 2.0)
    assert got[0] == o.f and o.score[got[1]] == o.f


def test_local_max_score_without_the_native_runtime(monkeypatch):
    """Without the native runtime a huge pair takes the batched fill, as in
    the JAX package; asking for the host by name is then refused."""
    q, t = _pair(25, 50, 60)
    want = port.local_max_score(q, t, B62, 11.0, 2.0, device="host")
    monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 1000)
    monkeypatch.setattr(native, "available", lambda: False)
    from aligner_tpu import native as ref_native

    monkeypatch.setattr(ref_native, "available", lambda: False)
    assert port.local_max_score(q, t, B62, 11.0, 2.0, device="cpu") == want
    assert ref.local_max_score(q, t, B62, 11.0, 2.0) == want
    with pytest.raises(port.ValidationError, match="native runtime"):
        port.local_max_score(q, t, B62, 11.0, 2.0, device="host")
    for fn in (port.local_max_score, port.global_end_score):
        with pytest.raises(port.ResultIsEmpty):
            fn(q[:0], t, B62, 11.0, 2.0, device="cpu")
