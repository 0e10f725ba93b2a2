"""The column-blocked pipeline's three block engines against the JAX package,
on the CPU: ``sharded_global_end_score`` and ``sharded_global_align`` with
``engine`` ``"lax"``, ``"pallas"`` and ``"band"`` against the JAX functions
on conftest's 8 virtual devices and the reference's host engine (end score,
strings, coordinates, the host walk); the routing of a matrix beyond int8
to ``"lax"`` and the band engine's height; the band engine's records
against the row-scan engine's; the range guard with the matrix's largest
entry, and the reference's wrap that it refuses; the engine pick
(``auto_shard_config``) against the port's own fit; the band engine under
fuzzed shapes, penalties and matrices; and ``aligner-align -g -m FILE``
with a matrix beyond int8 on a pair wider than a monkeypatched width cap.
Tolerance: none.  Every value is an int32, a direction code or a string
and is compared for equality; cells of padded rows and columns are
unspecified and not compared."""

import contextlib
import io
import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import aligner_tpu_torch as port
from aligner_tpu import host as ref_host
from aligner_tpu.cli import align as ref_cli
from aligner_tpu.parallel import wavefront_sp as ref_sp
from aligner_tpu_torch.cli import align as port_cli
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.parallel import wavefront_sp as sp

torch.set_num_threads(1)

B62 = np.asarray(port.blosum62())
ENGINES = ["lax", "pallas", "band"]


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # align_global of the JAX package would otherwise shard over conftest's
    # 8 devices by itself; the sharded entry points get their mesh by hand
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()).reshape(-1), ("data",))


def _pair(seed, C, R, V=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, C).astype(np.int8), rng.integers(0, V, R).astype(np.int8)


def _host(q, t, m, d, e):
    """The reference's host engine (native C++ fill, reference walk)."""
    return ref_host.align_global(q, t, m, float(d), float(e))


# (C, R): more virtual devices than 128-column blocks, a ragged last row
# block, a path that crosses column blocks
SHAPES = [(300, 190), (257, 129)]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("C,R", SHAPES, ids=[f"{c}x{r}" for c, r in SHAPES])
def test_parity_vs_oracle(mesh, engine, C, R):
    q, t = _pair(C + R, C, R)
    got = sp.sharded_global_end_score(8, q, t, B62, 11, 2, tr=128, engine=engine,
                                      device="cpu")
    want = ref_sp.sharded_global_end_score(mesh, q, t, B62, 11.0, 2.0, tr=128,
                                           engine=engine)
    assert got == want == _host(q, t, B62, 11, 2).score[R, C]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("C,R", SHAPES, ids=[f"{c}x{r}" for c, r in SHAPES])
def test_sharded_align_matches_oracle(mesh, engine, C, R):
    """Strings, coordinates and end score against the JAX pipeline and the
    host engine, with replay tiles of 128 rows."""
    q, t = _pair(5 * C + R, C, R)
    got = sp.sharded_global_align(8, q, t, B62, 11, 2, tr=128, tb_rows=128, engine=engine,
                                  device="cpu")
    want = ref_sp.sharded_global_align(mesh, q, t, B62, 11.0, 2.0, tr=128, tb_rows=128,
                                       engine=engine)
    o = _host(q, t, B62, 11, 2)
    assert got[0] == want[0] == o.score[R, C]
    assert got[3] == want[3] == ((1, C), (1, R))
    for x, y, z in zip(got[1:3], want[1:3], (o.query_aligned, o.target_aligned)):
        assert x.dtype == y.dtype and np.array_equal(x, y) and np.array_equal(x, z)


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_align_device_walk_matches_host_walk(mesh, engine, monkeypatch):
    """``walk="host"`` against the default walk and against the JAX
    package's host walk (``ALIGNER_DEVICE_WALK=0``), with tile crossings in
    both axes."""
    C, R = 300, 150
    q, t = _pair(7, C, R)
    dev = sp.sharded_global_align(2, q, t, B62, 11, 2, tr=128, tb_rows=128, engine=engine,
                                  device="cpu")
    hst = sp.sharded_global_align(2, q, t, B62, 11, 2, tr=128, tb_rows=128, engine=engine,
                                  device="cpu", walk="host")
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "0")
    want = ref_sp.sharded_global_align(mesh, q, t, B62, 11.0, 2.0, tr=128, tb_rows=128,
                                       engine=engine)
    for a in (dev, hst):
        assert a[0] == want[0] and a[3] == want[3]
        assert np.array_equal(a[1], want[1]) and np.array_equal(a[2], want[2])


def test_pallas_engine_wide_entry_matrix_falls_back(mesh):
    """An integral matrix beyond int8 turns "pallas" into "lax", which
    aligns it exactly."""
    rng = np.random.default_rng(0)
    M = rng.integers(-200, 200, (24, 24)).astype(np.float64)
    q, t = _pair(8, 300, 200)
    pp = sp._prep_sharded(2, q, t, M, 11, 2, None, None, "pallas", "cpu")
    assert pp["engine"] == "lax"
    got = sp.sharded_global_end_score(2, q, t, M, 11, 2, engine="pallas", device="cpu")
    want = ref_sp.sharded_global_end_score(mesh, q, t, M, 11.0, 2.0, engine="pallas")
    assert got == want == _host(q, t, M, 11, 2).score[200, 300]
    a = sp.sharded_global_align(2, q, t, M, 11, 2, tb_rows=64, engine="pallas",
                                device="cpu")
    o = _host(q, t, M, 11, 2)
    assert a[0] == got and np.array_equal(a[1], o.query_aligned)
    assert np.array_equal(a[2], o.target_aligned)


def test_band_engine_wide_entry_matrix_byte_lut(mesh, caplog):
    """Entries within int8 but past a nibble's range stay on the band
    engine (the reference's byte table; the port's table is int32 either
    way); entries past int8 route to "lax", reported in the log."""
    rng = np.random.default_rng(1)
    q, t = _pair(9, 300, 220)
    Mw = rng.integers(-100, 100, (24, 24)).astype(np.float64)
    assert sp._prep_sharded(2, q, t, Mw, 11, 2, 128, None, "band", "cpu")["engine"] == "band"
    got = sp.sharded_global_end_score(2, q, t, Mw, 11, 2, tr=128, engine="band",
                                      device="cpu")
    want = ref_sp.sharded_global_end_score(mesh, q, t, Mw, 11.0, 2.0, tr=128, engine="band")
    assert got == want == _host(q, t, Mw, 11, 2).score[220, 300]
    Mx = rng.integers(-200, 200, (24, 24)).astype(np.float64)
    with caplog.at_level(logging.INFO, logger="aligner_tpu_torch"):
        pp = sp._prep_sharded(2, q, t, Mx, 11, 2, 128, None, "band", "cpu")
    assert pp["engine"] == "lax" and "beyond int8" in caplog.text
    got = sp.sharded_global_end_score(2, q, t, Mx, 11, 2, engine="band", device="cpu")
    want = ref_sp.sharded_global_end_score(mesh, q, t, Mx, 11.0, 2.0, engine="band")
    assert got == want == _host(q, t, Mx, 11, 2).score[220, 300]


def test_band_engine_tr_rounding_and_clamp():
    """The band engine rounds ``tr`` up to a multiple of 128 and clamps it
    to the padded target; with a traceback a band is at most a replay tile
    and divides it (a tile below 128 rows grows to one band)."""
    q, t = _pair(10, 500, 100)
    want = _host(q, t, B62, 11, 2).score[100, 500]
    for tr in (77, 4096, None):
        pp = sp._prep_sharded(2, q, t, B62, 11, 2, tr, None, "band", "cpu")
        assert pp["tr"] == 128 and pp["R_pad"] == 128
        assert sp.sharded_global_end_score(2, q, t, B62, 11, 2, tr=tr, engine="band",
                                           device="cpu") == want
    q, t = _pair(11, 300, 1000)
    # (tr, tb_rows) -> (band rows, replay tile rows)
    for tr, tb, want_tr, want_tb in ((512, 256, 256, 256), (128, 384, 128, 384),
                                     (256, 384, 256, 256), (None, 64, 128, 128),
                                     (300, 1024, 384, 768)):
        pp = sp._prep_sharded(2, q, t, B62, 11, 2, tr, tb, "band", "cpu")
        assert (pp["tr"], pp["tb"]) == (want_tr, want_tb), (tr, tb)
        assert pp["tb"] % pp["tr"] == 0 and pp["R_pad"] % pp["tb"] == 0


def test_band_engine_lane0_diag_regression():
    """The (1,1) del-up correction in the fill stream must not leak into
    cell (1,2)'s diagonal: minimal shapes whose border terms compete with
    the first scores, against the reference's host engine."""
    rng = np.random.default_rng(12)
    Mw = rng.integers(-100, 100, (4, 4)).astype(np.float64)
    for C, R in [(2, 1), (2, 2), (3, 2), (4, 1), (1, 2), (5, 4)]:
        for _ in range(4):
            q = rng.integers(0, 4, C).astype(np.int8)
            t = rng.integers(0, 4, R).astype(np.int8)
            got = sp.sharded_global_end_score(8, q, t, Mw, 11, 2, tr=128, engine="band",
                                              device="cpu")
            assert got == _host(q, t, Mw, 11, 2).score[R, C], (C, R, q, t)


# (C, R, column blocks, tr, tb_rows): replay tiles of one band and of three,
# the pair's last row and column inside and on a block's edge
RECORDS = [(600, 300, 3, 128, 128), (512, 384, 2, 128, 384), (700, 260, 3, 256, 256)]


@pytest.mark.parametrize("C,R,n,tr,tb", RECORDS,
                         ids=[f"{c}x{r}-n{n}-tr{tr}-tb{tb}" for c, r, n, tr, tb in RECORDS])
def test_band_engine_records_equal_the_row_scan_engines(C, R, n, tr, tb):
    """The band engine's boundary history, checkpoint rows and step stream
    equal the row-scan engine's, and its bands are what a trace shows."""
    q, t = _pair(C * R, C, R)
    band = sp._prep_sharded(n, q, t, B62, 11, 2, tr, tb, "band", "cpu")
    rows = sp._prep_sharded(n, q, t, B62, 11, 2, None, band["tb"], "pallas", "cpu")
    assert band["tb"] == rows["tb"] == tb and band["R_pad"] == rows["R_pad"]
    eb, lb_b, ck_b, state_b, steps_b, info = sp._sharded_walk(band)
    er, lb_r, ck_r, state_r, steps_r, _ = sp._sharded_walk(rows)
    assert int(eb) == int(er) == _host(q, t, B62, 11, 2).score[R, C]
    assert info["engine"] == "band" and info["tr"] == tr
    assert torch.equal(lb_b, lb_r) and torch.equal(ck_b[:, :C], ck_r[:, :C])
    assert torch.equal(state_b, state_r) and torch.equal(steps_b, steps_r)
    trace = []
    sp._forward(band, False, trace=trace)
    assert len(trace) == band["J"] * band["n"]
    args, kw, out = trace[-1]
    again = wf.run_block_band_plain(*args, Cb=kw["Cb"], ext=kw["ext"])
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_range_guard_rejects_overflow():
    """int32-exactness guard: absurdly long pairs are refused, and the
    match ramp takes the matrix's largest entry."""
    assert wf.range_ok(1000, 1000, 11.0, 2.0)
    assert not wf.range_ok(1000, 2**30 // 11, 11.0, 2.0)
    assert wf.supported(1000, B62, 11.0, 2.0, tlen=1000)
    assert not wf.supported(1000, B62, 11.0, 2.0, tlen=2**30 // 11)
    # an int8 matrix keeps the reference's verdict; a wider one tightens it
    for qlen, tlen in ((1000, 1000), (3_000_000, 3_000_000), (8_000_000, 8_000_000)):
        assert wf.range_ok(qlen, tlen, 11, 2, 5) == wf.range_ok(qlen, tlen, 11, 2)
    assert wf.range_ok(1000, 1000, 11, 2, 2**20)
    assert not wf.range_ok(1000, 1000, 11, 2, 2**21)
    assert not wf.range_ok(1000, 1000, 11, 2, wf.max_entry(np.full((4, 4), np.inf)))
    assert wf.max_entry(np.array([[-300.4, 2.0], [1.0, 0.0]])) == 300.0
    z8 = np.zeros(8, np.int8)
    t_huge = np.broadcast_to(np.int8(0), (2**30 // 11,))
    for engine in (None, *ENGINES):
        with pytest.raises(port.ValidationError, match="int32"):
            sp.sharded_global_align(2, z8, t_huge, B62, 11, 2, engine=engine, device="cpu")


def test_the_references_wrap_is_refused(mesh):
    """A 16 x 16 pair of one symbol under a matrix with M[0,0] = 2^27: the
    JAX package's "lax" engine (and its default, which takes "lax" for such
    a matrix) returns a wrapped score, 2013265916, where its host engine
    gives 2^31; the port refuses the pair on the column-blocked route."""
    q = t = np.zeros(16, np.int8)
    M = np.full((24, 24), -1.0)
    M[0, 0] = 2.0**27
    assert _host(q, t, M, 11, 2).score[16, 16] == 2147483648.0
    for engine in ("lax", None):
        assert ref_sp.sharded_global_end_score(mesh, q, t, M, 11.0, 2.0,
                                               engine=engine) == 2013265916.0
        with pytest.raises(port.ValidationError, match="int32"):
            sp.sharded_global_end_score(2, q, t, M, 11, 2, engine=engine, device="cpu")
        with pytest.raises(port.ValidationError, match="int32"):
            sp.sharded_global_align(2, q, t, M, 11, 2, engine=engine, device="cpu")
    for fn in (port.align_global, port.global_end_score):
        with pytest.raises(port.ValidationError, match="int32"):
            fn(q, t, M, 11.0, 2.0, backend="wavefront_sp", device="cpu")


def test_auto_shard_config_choices():
    """The pick on the port's own fit: the engine with the higher modelled
    rate, the tallest band the fit prefers for an end score, the traceback's
    cap on the band height honoured, and the pick made only on the card
    with neither ``engine`` nor ``tr`` named (the CPU keeps the row-scan
    engine's plain version)."""
    for qlen, tlen, n in ((524288, 524288, 4), (262144, 262144, 2), (65536, 65536, 4),
                          (8192, 8192, 4), (524288, 16384, 4), (524288, 1000, 4)):
        cb = -(-qlen // n)
        r128 = -(-tlen // 128) * 128
        rowscan = sp.rowscan_rate_model(cb, min(sp.FORWARD_ROWS, r128))
        for cap in (wf.BAND_ROWS, sp.TB_ROWS, 2048):
            e, tr, g = sp.auto_shard_config(qlen, tlen, n, max_band_tr=cap)
            bands = {h: sp.band_rate_model(h, cb) for h in (512 << k for k in range(10))
                     if h <= min(cap, r128)}
            best = max(bands.values(), default=0.0)
            if e == "band":
                assert tr <= cap and g == bands[tr] == best >= rowscan
            else:
                assert (e, tr) == ("pallas", sp.FORWARD_ROWS)
                assert g == rowscan >= best
    # an end score at the widest pair takes tall bands; the models rise with
    # the block's width, and a band rises with its height at a fixed width
    assert sp.auto_shard_config(524288, 524288, 4)[:2] == ("band", wf.BAND_ROWS)
    assert sp.rowscan_rate_model(32768) < sp.rowscan_rate_model(262144)
    # a short target: the row-scan engine is rated at the rows it runs, far
    # below its rate at a forward block of FORWARD_ROWS rows
    assert sp.rowscan_rate_model(131072, 16384) < sp.rowscan_rate_model(131072) / 2
    assert sp.auto_shard_config(524288, 16384, 4)[0] == "band"
    assert sp.band_rate_model(4096, 131072) < sp.band_rate_model(262144, 131072)
    wide = (524288, 524288, 4)
    for on_card, engine, tr, tb, want in (
            (False, None, None, None, ("pallas", None)),
            (True, None, None, None, sp.auto_shard_config(*wide)[:2]),
            (True, None, None, sp.TB_ROWS,
             sp.auto_shard_config(*wide, max_band_tr=sp.TB_ROWS)[:2]),
            (True, "pallas", None, None, ("pallas", None)),
            (True, "band", None, None, ("band", None)),
            (True, None, 256, None, ("pallas", 256))):
        assert sp._pick_engine(engine, tr, on_card, *wide, tb, 11) == want
    for engine in (None, "pallas", "band", "lax"):
        assert sp._pick_engine(engine, None, True, *wide, None, 128)[0] == "lax"
    q, t = _pair(13, 300, 200)
    assert sp._prep_sharded(2, q, t, B62, 11, 2, None, None, None, "cpu")["engine"] == "pallas"


def test_differential_band_engine():
    """The band engine against the reference's fill over randomized shapes,
    penalties, alphabets and matrix ranges (``tests/test_fuzz_differential.py``)."""
    rng = np.random.default_rng(0)
    for trial in range(10):
        vol = 24 if trial % 2 == 0 else 4
        if trial % 3 == 0:
            mat = B62 if vol == 24 else rng.integers(-4, 9, (4, 4)).astype(np.float64)
        else:
            mat = rng.integers(-90, 90, (vol, vol)).astype(np.float64)
        d = int(rng.integers(1, 25))
        e = int(rng.integers(1, max(d, 2)))
        C, R = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        q = rng.integers(0, vol, C).astype(np.int8)
        t = rng.integers(0, vol, R).astype(np.int8)
        got = sp.sharded_global_end_score(2, q, t, mat, d, e, tr=128, engine="band",
                                          device="cpu")
        assert got == _host(q, t, mat, d, e).score[R, C], (trial, C, R, d, e)


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("pretty", [False, True], ids=["debug", "pretty"])
def test_cli_align_wide_entry_matrix_on_a_wide_pair(monkeypatch, tmp_path, pretty):
    """``aligner-align -g -m FILE`` with BLOSUM62 x 20 (entries -80 ... 220)
    on a pair wider than the width cap (set to 256 here): the port takes
    the column-blocked route on its "lax" engine, and its stdout equals the
    JAX CLI's."""
    monkeypatch.setattr(wf, "MAX_WIDTH", 256)
    calls = []
    real = sp.sharded_global_align
    monkeypatch.setattr(sp, "sharded_global_align",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = tmp_path / "b62x20.txt"
    m.write_text("\n".join(" ".join(str(int(v)) for v in row) for row in 20 * B62) + "\n")
    rng = np.random.default_rng(14)
    q = rng.integers(0, 20, 300)
    t = np.resize(q, 280).copy()
    mask = rng.random(280) < 0.25
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    fa = tmp_path / "pair.fasta"
    fa.write_text(f">q\n{port.Protein.decode(q)}\n>t\n{port.Protein.decode(t)}\n")
    argv = ["-i", str(fa), "-g", "-m", str(m), "-d", "220", "-e", "40"]
    argv += ["--pretty"] if pretty else []
    got = _stdout(port_cli.main, argv + ["--device", "cpu"])
    assert calls and got.strip()
    assert got == _stdout(ref_cli.main, argv)
