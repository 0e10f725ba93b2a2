"""The score plane and the single-pair API with planes, on the CPU, against
the JAX package, bit for bit.

* The plain fill's score plane (``with_scores_plane``, assembled by
  ``planes_from_interior``) against ``pallas_dp.fill_batch_pallas`` /
  ``fill_pwm_batch_pallas`` with ``scores_plane=True`` in interpret mode and
  the XLA engine's plane, over the whole (B, R+1, C+1) plane, in pair
  (local, global) and PWM mode, f32 and f64.
* ``align_global``/``align_local(keep_planes=True)`` and both
  ``Simple*Aligner``s on ``device="cpu"`` (the plain versions) and
  ``device="host"`` (native C++) against the JAX package's ``backend="xla"``
  and ``backend="oracle"``: ``score``, ``directions``, strings, coordinates
  and ``f``; the refusals, each a ``ValidationError`` naming ``keep_planes``;
  ``backend="wavefront"`` with ``keep_planes`` and ``align_local``'s
  ``backend="stream"``.

Mirrors ``tests/test_align_api.py`` (the fuzz, the wrappers and their
errors, the huge-pair and ``wavefront_sp`` refusals, the global end score
with argmax tracking off), ``tests/test_examples_parity.py`` (the planes of
an example pair), ``tests/test_wavefront.py`` (``backend="wavefront"`` with
``keep_planes``) and ``tests/test_stream_local.py`` (the explicit stream
backend).  Tolerance: none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.io import read_fasta_file
from aligner_tpu.ops import pallas_dp
from aligner_tpu.ops.scan_engine import fill_batch as xla_fill_batch
from aligner_tpu.ops.scan_engine import fill_pwm_batch as xla_fill_pwm_batch
from aligner_tpu_torch.ops import dp_fill
from aligner_tpu_torch.ops.dp_fill import dirs_from_packed, planes_from_interior

torch.set_num_threads(1)

EXAMPLES = "examples"
B62 = np.asarray(ref.blosum62())
DTYPES = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # align_global of the JAX package would otherwise shard over conftest's
    # 8 devices by itself
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def _ragged(rng, B, C, R, V=24):
    q = rng.integers(0, V, (B, C)).astype(np.int32)
    t = rng.integers(0, V, (B, R)).astype(np.int32)
    ql = rng.integers(1, C + 1, B).astype(np.int32)
    tl = rng.integers(1, R + 1, B).astype(np.int32)
    ql[0], tl[1] = 0, 0  # empty problems are inert
    ql[2], tl[2] = C, R
    for b in range(B):
        q[b, ql[b]:] = 0
        t[b, tl[b]:] = 0
    return q, ql, t, tl


def _matrix(rng, name, batched, B):
    if name == "f32":  # integral: exact in f32 (BLOSUM62 and a shifted copy per problem)
        return (np.stack([B62 + rng.integers(-2, 3, B62.shape) for _ in range(B)])
                if batched else B62).astype(np.float64)
    shape = (B, 24, 24) if batched else (24, 24)
    return rng.normal(0.0, 3.0, shape)


def _port_plane(q, ql, t, tl, m, del_, ext, mode, dtype):
    r = dp_fill.fill(*(torch.from_numpy(a) for a in (q, ql, t, tl)),
                     torch.as_tensor(m, dtype=dtype), del_, ext, mode=mode,
                     with_dirs=True, with_scores_plane=True)
    R = t.shape[1]
    plane = planes_from_interior(r.plane.numpy(), ql, tl, mode, del_, rows=R)
    dirs = dirs_from_packed(r.words.numpy(), ql, tl, mode)[:, : R + 1]
    return r, plane, dirs


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per-problem"])
def test_plane_matches_pallas_and_xla(mode, dt, batched):
    """The whole (B, R+1, C+1) plane, borders and the inactive cells of
    ragged problems included; R = 13 is not a multiple of 8."""
    rng = np.random.default_rng(["local", "global"].index(mode) * 4
                                + list(DTYPES).index(dt) * 2 + int(batched))
    B, C, R = 9, 12, 13
    q, ql, t, tl = _ragged(rng, B, C, R)
    m = _matrix(rng, dt, batched, B)
    tdt, jdt = DTYPES[dt]
    del_, ext = (11.0, 2.0) if dt == "f32" else (3.5, 1.25)
    r, plane, dirs = _port_plane(q, ql, t, tl, m, del_, ext, mode, tdt)
    want = pallas_dp.fill_batch_pallas(q, ql, t, tl, m, del_, ext, mode=mode,
                                       with_planes=True, dtype=jdt, scores_plane=True)
    x = xla_fill_batch(q, ql, t, tl, m, del_, ext, mode=mode, with_planes=True,
                       dtype=jdt)
    for w in (want, x):
        p = np.asarray(w.plane)
        assert plane.dtype == p.dtype and plane.shape == p.shape == (B, R + 1, C + 1)
        assert np.array_equal(plane, p)
        assert np.array_equal(dirs, np.asarray(w.dirs))
        for a, b in zip((r.fmax, r.fy, r.fx, r.end), (w.fmax, w.fy, w.fx, w.end)):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per-problem"])
def test_pwm_plane_matches_pallas_and_xla(dt, batched):
    rng = np.random.default_rng(20 + list(DTYPES).index(dt) * 2 + int(batched))
    B, R, W = 11, 21, 13
    q = rng.integers(0, 4, (B, R)).astype(np.int32)
    ql = rng.integers(0, R + 1, B).astype(np.int32)
    ql[1] = R
    for b in range(B):
        q[b, ql[b]:] = 0
    pwm = rng.normal(0.0, 3.0, (B, 4, W) if batched else (4, W))
    if dt == "f32":
        pwm = np.round(pwm)
    tdt, jdt = DTYPES[dt]
    r = dp_fill.fill_pwm(torch.from_numpy(q), torch.from_numpy(ql),
                         torch.as_tensor(pwm, dtype=tdt), 3.0, 1.0, with_dirs=True,
                         with_scores_plane=True)
    full = np.full(B, W)
    plane = planes_from_interior(r.plane.numpy(), full, ql, "local", 3.0, rows=R)
    dirs = dirs_from_packed(r.words.numpy(), full, ql, "local")[:, : R + 1]
    want = pallas_dp.fill_pwm_batch_pallas(q, ql, pwm, 3.0, 1.0, with_planes=True,
                                           dtype=jdt, scores_plane=True)
    x = xla_fill_pwm_batch(q, ql, jnp.asarray(pwm, jdt), 3.0, 1.0, with_planes=True,
                           dtype=jdt)
    for w in (want, x):
        p = np.asarray(w.plane)
        assert plane.dtype == p.dtype and plane.shape == p.shape == (B, R + 1, W + 1)
        assert np.array_equal(plane, p)
        assert np.array_equal(dirs, np.asarray(w.dirs))


def test_plane_comes_only_with_directions():
    """As in the reference (``scores_plane and with_planes``): no plane
    without direction words, and the plane forces argmax tracking."""
    rng = np.random.default_rng(3)
    q, ql, t, tl = (torch.from_numpy(a) for a in _ragged(rng, 5, 8, 9))
    m = torch.as_tensor(np.array(B62))
    assert dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, with_scores_plane=True).plane is None
    r = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, track_argmax=False, with_dirs=True,
                     with_scores_plane=True)
    s = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, with_dirs=True)
    assert r.plane.shape == (5, 8, 16) and r.plane.dtype == torch.float64
    for a, b in zip((r.fmax, r.fy, r.fx, r.end, r.words), (s.fmax, s.fy, s.fx, s.end,
                                                           s.words)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the single-pair API with planes
# ---------------------------------------------------------------------------


def _pairs_equal(a, b):
    assert np.array_equal(a.alignment.query, b.alignment.query)
    assert np.array_equal(a.alignment.target, b.alignment.target)
    assert a.alignment.query.dtype == b.alignment.query.dtype
    assert a.alignment.coords == b.alignment.coords
    assert a.alignment.f == b.alignment.f


def _planes_equal(a, b):
    assert a.score.dtype == b.score.dtype and a.score.shape == b.score.shape
    assert np.array_equal(a.score, b.score)
    assert a.directions.dtype == b.directions.dtype
    assert np.array_equal(a.directions, b.directions)


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_fuzz_simple_vs_xla_and_oracle(device):
    """``tests/test_align_api.py::test_fuzz_simple_xla_vs_oracle``: random
    pairs and penalties, both modes, both planes; an empty local result
    raises in every package."""
    rng = np.random.default_rng(0)
    m = ref.blosum62()
    for _ in range(10):
        ql, tl = rng.integers(1, 40, size=2)
        q = rng.integers(0, 24, ql).astype(np.int8)
        t = rng.integers(0, 24, tl).astype(np.int8)
        del_, ext = float(rng.integers(1, 15)), float(rng.integers(1, 5))
        for name in ("align_local", "align_global"):
            fn = getattr(port, name)
            try:
                a = getattr(ref, name)(q, t, m, del_, ext, backend="xla", keep_planes=True)
            except ref.ResultIsEmpty:
                with pytest.raises(port.ResultIsEmpty):
                    fn(q, t, m, del_, ext, device=device, keep_planes=True)
                continue
            b = getattr(ref, name)(q, t, m, del_, ext, backend="oracle", keep_planes=True)
            got = fn(q, t, m, del_, ext, device=device, keep_planes=True)
            for want in (a, b):
                _pairs_equal(got, want)
                _planes_equal(got, want)
            # without keep_planes: no planes, the same alignment
            plain = fn(q, t, m, del_, ext, device=device)
            assert plain.score is None and plain.directions is None
            _pairs_equal(plain, a)


def test_non_integral_scoring_keeps_f64_planes():
    """A transformed matrix and fractional penalties: the batched fill runs
    in f64 on the CPU, as the JAX package's x64 engine and native C++."""
    rng = np.random.default_rng(5)
    q = rng.integers(0, 24, 33).astype(np.int8)
    t = rng.integers(0, 24, 29).astype(np.int8)
    m = B62 * 0.37 - 0.11
    for name in ("align_local", "align_global"):
        want = getattr(ref, name)(q, t, m, 3.5, 1.25, backend="xla", keep_planes=True)
        for device in ("cpu", "host"):
            got = getattr(port, name)(q, t, m, 3.5, 1.25, device=device, keep_planes=True)
            assert got.score.dtype == np.float64
            _pairs_equal(got, want)
            _planes_equal(got, want)


def test_class_wrappers_and_errors():
    """``tests/test_align_api.py::test_class_wrappers_and_errors``, with the
    port's ``device="host"`` for the reference's ``backend="oracle"``."""
    al = port.SimpleLocalAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE")
    want = ref.SimpleLocalAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE").perform_alignment(
        11.0, 2.0, ref.blosum62(), backend="oracle")
    for device in ("host", "cpu"):
        res = al.perform_alignment(11.0, 2.0, port.blosum62(), device=device)
        assert res.alignment.f > 0
        _pairs_equal(res, want)
        _planes_equal(res, want)  # keep_planes defaults to true
    with pytest.raises(port.UnnecessaryArgument):
        al.perform_alignment(11.0, 2.0, port.blosum62(), heuristics=object())
    ga = port.SimpleGlobalAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE")
    res = ga.perform_alignment(11.0, 2.0, port.blosum62(), device="host")
    assert res.alignment.f == 0.0
    _planes_equal(res, ref.SimpleGlobalAligner.from_str_seqs(
        "HEAGAWGHEE", "PAWHEAE").perform_alignment(11.0, 2.0, ref.blosum62(),
                                                   backend="oracle"))
    assert ga.perform_alignment(11.0, 2.0, port.blosum62(), device="cpu",
                                keep_planes=False).score is None
    pa = port.PWMAligner.from_str_seqs("ATCGATCG")
    with pytest.raises(port.MatrixShapeError):
        pa.perform_alignment(3.0, 1.0, np.zeros((5, 4)), device="cpu")
    # strict encoding: a character outside the alphabet is refused
    with pytest.raises(port.CharIsNotMatchable):
        port.SimpleGlobalAligner.from_str_seqs("HEAG1", "PAWHEAE")
    with pytest.raises(ref.CharIsNotMatchable):
        ref.SimpleGlobalAligner.from_str_seqs("HEAG1", "PAWHEAE")
    # from_seqs takes codes or text
    q = port.Protein.encode("HEAGAWGHEE")
    a = port.SimpleLocalAligner.from_seqs(q, "PAWHEAE").perform_alignment(
        11.0, 2.0, port.blosum62(), device="cpu")
    _pairs_equal(a, want)


def _codes(path):
    recs = read_fasta_file(path)
    return (ref.Protein.encode(recs[0].seq, strict=True),
            ref.Protein.encode(recs[1].seq, strict=True))


@pytest.mark.parametrize("example,device", [
    ("book_example_1", "cpu"), ("protein", "cpu"), ("book_example_1", "host"),
    ("protein", "host"), ("human_gene_example", "host")])
def test_examples_with_planes(example, device):
    """``tests/test_examples_parity.py``: the example pairs with their planes
    through the simple aligners, against the JAX package's (its XLA engine
    on the CPU; the oracle for the 1.2 kb pair, whose plain fill is too slow
    for these tests and runs on the card in
    ``tests/test_torch_cuda.py::test_golden_fixtures_on_the_card``)."""
    q, t = _codes(f"{EXAMPLES}/{example}.fasta")
    backend = "oracle" if example == "human_gene_example" else "xla"
    for cls in ("SimpleLocalAligner", "SimpleGlobalAligner"):
        got = getattr(port, cls).from_seqs(q, t).perform_alignment(
            11.0, 2.0, port.blosum62(), device=device)
        want = getattr(ref, cls).from_seqs(q, t).perform_alignment(
            11.0, 2.0, ref.blosum62(), backend=backend)
        _pairs_equal(got, want)
        _planes_equal(got, want)


def test_huge_pair_keep_planes_refused(monkeypatch):
    """``tests/test_align_api.py::test_huge_pair_no_wavefront_raises``: a
    huge pair with planes is an explicit OOM request, refused on every
    route in the reference's words; so is a huge pair no exact wavefront
    engine takes."""
    rng = np.random.default_rng(2)
    q = rng.integers(0, 24, 10_000).astype(np.int8)
    t = rng.integers(0, 24, 10_000).astype(np.int8)
    with pytest.raises(port.ValidationError, match="plane"):
        port.align_global(q, t, port.blosum62(), 11.5, 2.25, device="cpu")
    for device in ("cpu", "host", None):
        with pytest.raises(port.ValidationError, match="keep_planes") as got:
            port.align_global(q, t, port.blosum62(), 11.0, 2.0, device=device,
                              keep_planes=True)
        with pytest.raises(ref.ValidationError) as want:
            ref.align_global(q, t, ref.blosum62(), 11.0, 2.0, keep_planes=True)
        assert str(got.value) == str(want.value)
        with pytest.raises(port.ValidationError, match="keep_planes") as got:
            port.align_local(q, t, port.blosum62(), 11.0, 2.0, device=device,
                             keep_planes=True)
        with pytest.raises(ref.ValidationError) as want:
            ref.align_local(q, t, ref.blosum62(), 11.0, 2.0, keep_planes=True)
        assert str(got.value) == str(want.value)
    for device in ("cpu", "host"):
        with pytest.raises(port.ValidationError, match="keep_planes"):
            port.SimpleGlobalAligner.from_seqs(q, t).perform_alignment(
                11.0, 2.0, port.blosum62(), device=device)


def test_explicit_wavefront_sp_refuses_keep_planes():
    """``tests/test_align_api.py::test_explicit_wavefront_sp_validation``."""
    q = np.zeros(8, np.int8)
    with pytest.raises(port.ValidationError, match="integral"):
        port.align_global(q, q, np.full((24, 24), 0.5), 11.0, 2.0,
                          backend="wavefront_sp", device="cpu")
    with pytest.raises(port.ValidationError, match="keep_planes") as got:
        port.align_global(q, q, port.blosum62(), 11.0, 2.0, backend="wavefront_sp",
                          keep_planes=True, device="cpu")
    with pytest.raises(ref.ValidationError) as want:
        ref.align_global(q, q, ref.blosum62(), 11.0, 2.0, backend="wavefront_sp",
                         keep_planes=True)
    assert str(got.value) == str(want.value)


def test_batch_global_end_scores_argmax_off():
    """``tests/test_align_api.py::test_batch_global_end_scores_argmax_off``:
    the global end score survives ``track_argmax=False`` and equals the
    plane's end cell."""
    rng = np.random.default_rng(0)
    qs = [rng.integers(0, 24, 12).astype(np.int8) for _ in range(5)]
    ts = [rng.integers(0, 24, 15).astype(np.int8) for _ in range(5)]
    rx = ref.batch_align(qs, ts, B62, 2.0, 1.0, mode="global", backend="xla",
                         track_argmax=False)
    got = port.batch_align(qs, ts, B62, 2.0, 1.0, mode="global", device="cpu",
                           track_argmax=False)
    assert np.array_equal(got.end, rx.end)
    for device in ("cpu", "host"):
        p = port.align_global(qs[0], ts[0], B62, 2.0, 1.0, device=device,
                              keep_planes=True)
        assert got.end[0] == p.score[15, 12]


def test_wavefront_backend_with_keep_planes():
    """``tests/test_wavefront.py::test_align_global_wavefront_backend``: the
    row scan forced on returns its directions (and no score plane) beside
    the oracle's alignment."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 24, 120).astype(np.int8)
    t = rng.integers(0, 24, 140).astype(np.int8)
    got = port.align_global(q, t, B62, 11.0, 2.0, backend="wavefront", keep_planes=True,
                            device="cpu")
    want = ref.align_global(q, t, B62, 11.0, 2.0, backend="oracle", keep_planes=True)
    _pairs_equal(got, want)
    assert got.score is None
    np.testing.assert_array_equal(got.directions, want.directions)
    plain = port.align_global(q, t, B62, 11.0, 2.0, backend="wavefront", device="cpu")
    assert plain.directions is None
    _pairs_equal(plain, want)
    with pytest.raises(port.ValidationError, match="wavefront backend requires"):
        port.align_global(q, t, np.full((24, 24), 0.5), 11.0, 2.0, backend="wavefront",
                          device="cpu")
    with pytest.raises(port.ValidationError, match="unknown backend"):
        port.align_global(q, t, B62, 11.0, 2.0, backend="xla", device="cpu")


def test_explicit_stream_backend():
    """``tests/test_stream_local.py::test_align_local_explicit_stream_backend``."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 24, 120).astype(np.int8)
    t = rng.integers(0, 24, 90).astype(np.int8)
    a = port.align_local(q, t, B62, 11.0, 2.0, backend="stream", device="cpu")
    b = ref.align_local(q, t, B62, 11.0, 2.0, backend="oracle")
    _pairs_equal(a, b)
    with pytest.raises(port.ValidationError, match="keep_planes") as got:
        port.align_local(q, t, B62, 11.0, 2.0, backend="stream", keep_planes=True,
                         device="cpu")
    with pytest.raises(ref.ValidationError) as want:
        ref.align_local(q, t, B62, 11.0, 2.0, backend="stream", keep_planes=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(port.ValidationError, match="unknown backend"):
        port.align_local(q, t, B62, 11.0, 2.0, backend="oracle", device="cpu")


def test_host_device_takes_no_backend_and_no_size_picks_it(monkeypatch):
    """``device="host"`` is asked for by name: a small pair on the CPU runs
    the plain versions, not the host engine."""
    from aligner_tpu_torch import host

    calls = []
    real = host.align_global
    monkeypatch.setattr(host, "align_global", lambda *a: calls.append(1) or real(*a))
    q = np.arange(10, dtype=np.int8)
    port.align_global(q, q[::-1].copy(), B62, 11.0, 2.0, device="cpu", keep_planes=True)
    assert calls == []
    port.align_global(q, q[::-1].copy(), B62, 11.0, 2.0, device="host", keep_planes=True)
    assert calls == [1]
    with pytest.raises(port.ValidationError, match="host"):
        port.align_global(q, q, B62, 11.0, 2.0, device="host", backend="wavefront")
    with pytest.raises(port.ValidationError, match="walk"):
        port.align_global(q, q, B62, 11.0, 2.0, device="cpu", walk="both")


def test_keep_planes_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.arange(10, dtype=np.int8)
    for cls in (port.SimpleGlobalAligner, port.SimpleLocalAligner):
        with pytest.raises(port.DeviceUnavailable):
            cls.from_seqs(q, q).perform_alignment(11.0, 2.0, port.blosum62())


def test_simple_aligners_are_exported():
    for name in ("SimpleGlobalAligner", "SimpleLocalAligner"):
        assert name in port.__all__ and name in ref.__all__
