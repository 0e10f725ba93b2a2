"""The port's PWM path against the JAX package, bit for bit: the plain
version of the fill kernel's PWM specialisation (``fill_pwm``) against the
Pallas kernel (interpret mode) and the XLA engine, then
``batch_align_pwm``, ``align_pwm``, ``PWMAligner`` and the heuristic PWM
aligner, and the dtype chooser.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance is zero: words, fmax, fy, fx, end and alignments must be equal.
Non-integral PWMs are compared in f64, integral ones in f32; each PWM is
asymmetric, so a transposed lookup cannot pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.ops import pallas_dp
from aligner_tpu.ops.scan_engine import fill_pwm_batch as xla_fill_pwm
from aligner_tpu_torch.backend import dtype_for
from aligner_tpu_torch.ops import dp_fill
from aligner_tpu_torch.ops.dp_fill import PWMFill, dirs_from_packed

torch.set_num_threads(1)

B, R, W = 9, 13, 11  # R and W not multiples of 8
DEL, EXT = 3.5, 1.25


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the JAX batch path would otherwise shard over conftest's 8 devices
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def _queries(rng):
    q = rng.integers(0, 4, (B, R)).astype(np.int32)
    ql = rng.integers(1, R + 1, B).astype(np.int32)
    ql[0] = ql[4] = 0  # empty windows are inert
    for b in range(B):
        q[b, ql[b]:] = 0
    return q, ql


def _pwm(rng, batched, integral):
    shape = (B, 4, W) if batched else (4, W)
    if integral:
        return rng.integers(-4, 6, shape).astype(np.float64)
    return rng.normal(0.0, 3.0, shape)


def _port(q, ql, pwm, dtype, **kw):
    dp = PWMFill.from_numpy(pwm, DEL, EXT, device="cpu", dtype=dtype)
    r = dp(torch.from_numpy(q), torch.from_numpy(ql), **kw)
    out = [r.fmax.numpy(), r.fy.numpy(), r.fx.numpy(), r.end.numpy()]
    return out + ([r.words.numpy()] if r.words is not None else [])


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        assert np.array_equal(x, y), (x, y)


KINDS = [(False, False), (True, False), (False, True), (True, True)]
KIND_IDS = ["shared-f64", "batched-f64", "shared-f32int", "batched-f32int"]


@pytest.mark.parametrize("batched,integral", KINDS, ids=KIND_IDS)
def test_fill_pwm_words_match_pallas_and_xla(rng, batched, integral):
    q, ql = _queries(rng)
    pwm = _pwm(rng, batched, integral)
    tdt, jdt = ((torch.float32, jnp.float32) if integral
                else (torch.float64, jnp.float64))
    got = _port(q, ql, pwm, tdt, with_dirs=True)
    want = pallas_dp.fill_pwm_full_traced(q, ql, jnp.asarray(pwm, jdt), DEL, EXT,
                                          dtype=jdt, interpret=True)
    _assert_same(got, want)
    x = xla_fill_pwm(q, ql, jnp.asarray(pwm, jdt), DEL, EXT, with_planes=True,
                     dtype=jdt)
    dirs = dirs_from_packed(got[4], np.full(B, W), ql, "local")[:, : R + 1, : W + 1]
    _assert_same(got[:4] + [dirs], [x.fmax, x.fy, x.fx, x.end, x.dirs])


@pytest.mark.parametrize("track", [True, False], ids=["argmax", "noargmax"])
@pytest.mark.parametrize("batched,integral", KINDS, ids=KIND_IDS)
def test_fill_pwm_scores_match_pallas_and_xla(rng, batched, integral, track):
    q, ql = _queries(rng)
    pwm = _pwm(rng, batched, integral)
    tdt, jdt = ((torch.float32, jnp.float32) if integral
                else (torch.float64, jnp.float64))
    got = _port(q, ql, pwm, tdt, track_argmax=track)
    want = pallas_dp.fill_pwm_scores_traced(q, ql, jnp.asarray(pwm, jdt), DEL, EXT,
                                            dtype=jdt, interpret=True,
                                            track_argmax=track)
    _assert_same(got, want)  # without tracking fy/fx/end are zero in both
    x = xla_fill_pwm(q, ql, jnp.asarray(pwm, jdt), DEL, EXT, with_planes=False,
                     dtype=jdt)
    _assert_same(got if track else got[:1],
                 [x.fmax, x.fy, x.fx, x.end] if track else [x.fmax])


def test_fill_pwm_reads_the_row_layout_in_place(rng):
    q, ql = _queries(rng)
    pwm = torch.from_numpy(_pwm(rng, False, False))
    qt = torch.from_numpy(q)
    rows = torch.zeros((16, B), dtype=torch.int32)
    rows[:R] = qt.T
    a = dp_fill.fill_pwm(qt, torch.from_numpy(ql), pwm, DEL, EXT, with_dirs=True)
    b = dp_fill.fill_pwm(rows.T, torch.from_numpy(ql), pwm, DEL, EXT, with_dirs=True)
    for f in ("fmax", "fy", "fx", "end", "words"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_fill_pwm_rejects_bad_input(rng):
    q, ql = (torch.from_numpy(a) for a in _queries(rng))
    pwm = torch.from_numpy(_pwm(rng, False, False))
    with pytest.raises(ValueError, match="codes"):
        dp_fill.fill_pwm(q + 4, ql, pwm, DEL, EXT)
    with pytest.raises(ValueError, match="PWM"):
        dp_fill.fill_pwm(q, ql, pwm[:3], DEL, EXT)
    with pytest.raises(ValueError, match="batched PWM"):
        dp_fill.fill_pwm(q, ql, pwm[None].expand(B + 1, 4, W).contiguous(), DEL, EXT)
    with pytest.raises(TypeError):
        dp_fill.fill_pwm(q.long(), ql, pwm, DEL, EXT)
    with pytest.raises(TypeError):
        dp_fill.fill_pwm(q, ql, pwm.to(torch.float16), DEL, EXT)
    with pytest.raises(ValueError, match="contiguous"):
        dp_fill.fill_pwm(torch.zeros((B, 2 * R), dtype=torch.int32)[:, ::2], ql,
                         pwm, DEL, EXT)
    with pytest.raises(ValueError):
        PWMFill.from_numpy(np.zeros((3, W)), DEL, EXT, device="cpu",
                           dtype=torch.float64)


def test_dtype_follows_the_data():
    b62 = np.array(port.blosum62())
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dtype_for(cuda, b62, 11.0, 2.0) == torch.float32
    assert dtype_for("cuda:0", np.ones((4, 7)), 30.0, 7.0) == torch.float32
    assert dtype_for(cuda, b62 + 0.5, 11.0, 2.0) == torch.float64
    assert dtype_for(cuda, b62, 11.5, 2.0) == torch.float64
    assert dtype_for(cuda, b62, 11.0, 0.25) == torch.float64
    pwm = port.transform_matrix(port.random_pwm(12, np.random.default_rng(0)), 0.0,
                                210.0, np.full(4, 0.25))
    assert dtype_for(cuda, pwm, 30.0, 7.0) == torch.float64
    for m in (b62, pwm):
        assert dtype_for(cpu, m, 11.0, 2.0) == torch.float64


def _dna(rng, n, lo, hi):
    return [rng.integers(0, 4, rng.integers(lo, hi + 1)).astype(np.int8)
            for _ in range(n)]


def _same_pwm_alignments(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if y is None:
            assert x is None
            continue
        x, y = x.alignment, y.alignment
        assert np.array_equal(x.numbered, y.numbered)
        assert x.numbered.dtype == y.numbered.dtype
        assert np.array_equal(x.query, y.query)
        assert x.coords == y.coords
        assert x.f == y.f
        assert x.dim == y.dim
        assert np.array_equal(x.frequency_matrix(), y.frequency_matrix())


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_batch_align_pwm_scores(rng, batched):
    qs = _dna(rng, 10, 0, 21)
    pwm = rng.normal(0.0, 3.0, (10, 4, W) if batched else (4, W))
    a = port.batch_align_pwm(qs, pwm, DEL, EXT)
    b = ref.batch_align_pwm(qs, pwm, DEL, EXT, backend="xla")
    for f in ("fmax", "fy", "fx", "end"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and np.array_equal(x, y), f
    # scores only: the maximum is exact, the argmax fields are zero
    c = port.batch_align_pwm(qs, pwm, DEL, EXT, track_argmax=False)
    assert np.array_equal(c.fmax, b.fmax)
    assert not c.fy.any() and not c.fx.any() and not c.end.any()


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_batch_align_pwm_alignments(rng, batched):
    qs = _dna(rng, 11, 0, 25)
    qs[3] = qs[3][:0]  # an empty query gives the empty alignment
    pwm = rng.normal(0.5, 3.0, (11, 4, W) if batched else (4, W))
    a = port.batch_align_pwm(qs, pwm, DEL, EXT, with_alignments=True)
    b = ref.batch_align_pwm(qs, pwm, DEL, EXT, backend="xla", with_alignments=True)
    _same_pwm_alignments(a, b)
    assert a[3].alignment.coords == ((1, 1), (1, 1)) and a[3].alignment.f == 0.0


def test_batch_align_pwm_pad_to_and_skip(rng):
    qs = _dna(rng, 6, 1, 20)
    pwm = rng.normal(0.5, 3.0, (6, 4, W))
    skip = np.array([False, True, False, False, True, False])
    for wa in (False, True):
        a = port.batch_align_pwm(qs, pwm, DEL, EXT, with_alignments=wa, pad_to=16,
                                 skip=skip)
        b = ref.batch_align_pwm(qs, pwm, DEL, EXT, backend="xla", with_alignments=wa,
                                pad_to=16, skip=skip)
        if wa:
            _same_pwm_alignments(a, b)
            assert a[1] is None and a[4] is None
        else:
            assert np.array_equal(a.fmax, b.fmax) and len(a.fmax) == 6
            assert a.fmax[1] == 0 and a.fmax[4] == 0
    with pytest.raises(port.ValidationError):
        port.batch_align_pwm(qs, pwm, DEL, EXT, pad_to=4)
    with pytest.raises(port.MatrixShapeError):
        port.batch_align_pwm(qs, pwm[:, :3], DEL, EXT)


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "plain"])
def test_align_pwm(rng, device):
    pwm = rng.normal(0.5, 3.0, (4, 17))
    for n in (0, 1, 9, 30):
        q = rng.integers(0, 4, n).astype(np.int8)
        a = port.align_pwm(q, pwm, DEL, EXT, device=device)
        for backend in (None, "xla"):
            b = ref.align_pwm(q, pwm, DEL, EXT, backend=backend)
            _same_pwm_alignments([a], [b])
    assert a.alignment.coords != ((1, 1), (1, 1))
    with pytest.raises(port.MatrixShapeError):
        port.align_pwm(q, pwm[:3], DEL, EXT)


def test_pwm_aligner_and_heuristic(rng):
    seq = "".join("ATCG"[c] for c in rng.integers(0, 4, 40))
    freqs = rng.dirichlet(np.ones(4))
    pwm = port.random_pwm(18, np.random.default_rng(5))
    a = port.PWMAligner.from_str_seqs(seq).perform_alignment(DEL, EXT, pwm, device="cpu")
    b = ref.PWMAligner.from_str_seqs(seq).perform_alignment(DEL, EXT, pwm, backend="xla")
    _same_pwm_alignments([a], [b])
    with pytest.raises(port.UnnecessaryArgument):
        port.PWMAligner.from_str_seqs(seq).perform_alignment(DEL, EXT, pwm,
                                                             heuristics=object())
    for device, backend in (("cpu", "xla"), (None, None)):
        h = port.Heuristics(kd=0.0, r_squared=200.0, frequencies=freqs)
        a = port.HeuristicPWMAligner.from_str_seqs(seq).perform_alignment(
            6.0, 2.0, pwm, h, device=device)
        b = ref.heuristic.HeuristicPWMAligner.from_str_seqs(seq).perform_alignment(
            6.0, 2.0, pwm, ref.heuristic.Heuristics(0.0, 200.0, freqs), backend=backend)
        _same_pwm_alignments([a], [b])
        assert np.array_equal(a.matrix, b.matrix)
    with pytest.raises(port.MissingArgument):
        port.heuristic_align_pwm(seq, pwm, DEL, EXT, None)


@pytest.mark.parametrize("seed", range(3))
def test_decoders_match_reference(seed):
    """The batched decoders of the walk's step streams, pair and PWM,
    against the JAX package's on random streams and start cells."""
    from aligner_tpu.ops import device_walk as ref_walk
    from aligner_tpu_torch.ops import device_walk as port_walk

    rng = np.random.default_rng(seed)
    S, Bn, L = 40, 23, 30
    steps = rng.integers(0, 3, (S, Bn)).astype(np.uint8)
    lens = rng.integers(0, S - 5, Bn)
    for b in range(Bn):
        steps[lens[b]:, b] = 3
    up = np.cumsum((steps == 0) | (steps == 2), axis=0)[-1]
    lf = np.cumsum((steps == 1) | (steps == 2), axis=0)[-1]
    sy, sx = up + rng.integers(1, 5, Bn), lf + rng.integers(1, 5, Bn)
    q = rng.integers(0, 4, (Bn, L + 40))
    t = rng.integers(0, 24, (Bn, L + 40))
    for a, b in zip(port_walk.decode_pwm_batch(steps, lens, sy, sx, q),
                    ref_walk.decode_pwm_batch(steps, lens, sy, sx, q)):
        assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
    for a, b in zip(port_walk.decode_pair_batch(steps, lens, sy, sx, q, t),
                    ref_walk.decode_pair_batch(steps, lens, sy, sx, q, t)):
        assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))


def test_service_matrix_codec_matches_reference(rng):
    from aligner_tpu.service import models as ref_models
    from aligner_tpu_torch.service import models as port_models

    m = rng.normal(0.0, 3.0, (4, 13))
    d = port_models.matrix_to_serde_dict(m)
    assert d == ref_models.matrix_to_serde_dict(m)
    assert port_models.matrix_to_json(m) == ref_models.matrix_to_json(m)
    back = port_models.matrix_from_json(port_models.matrix_to_json(m))
    assert back.dtype == np.float64 and np.array_equal(back, m)
    assert np.array_equal(ref_models.matrix_from_json(d), back)
