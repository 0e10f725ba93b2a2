"""The port's fill (plain PyTorch version of csrc/dp_fill.cu) against the
JAX package's Pallas kernel (interpret mode) and XLA engine, bit for bit.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance is zero: fmax, fy, fx, end and the packed direction words must
be equal.  Integral matrices are compared in f32 and f64, non-integral
ones in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligner_tpu.matrices import blosum62
from aligner_tpu.ops import pallas_dp
from aligner_tpu.ops.scan_engine import fill_batch as xla_fill_batch
from aligner_tpu_torch.ops import dp_fill
from aligner_tpu_torch.ops.dp_fill import DPFill, dirs_from_packed

torch.set_num_threads(1)

V = 24


def _batch(rng, B, C, R, dense):
    q = rng.integers(0, V, (B, C)).astype(np.int32)
    t = rng.integers(0, V, (B, R)).astype(np.int32)
    if dense:
        ql = np.full(B, C, np.int32)
        tl = np.full(B, R, np.int32)
    else:
        ql = rng.integers(1, C + 1, B).astype(np.int32)
        tl = rng.integers(1, R + 1, B).astype(np.int32)
        ql[0], tl[1] = 0, 0  # empty problems are inert
        for b in range(B):
            q[b, ql[b]:] = 0
            t[b, tl[b]:] = 0
    return q, ql, t, tl


def _port(q, ql, t, tl, matrix, del_, ext, dtype, **kw):
    dp = DPFill.from_numpy(matrix, del_, ext, device="cpu", dtype=dtype)
    r = dp(torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(t),
           torch.from_numpy(tl), **kw)
    out = [r.fmax.numpy(), r.fy.numpy(), r.fx.numpy(), r.end.numpy()]
    return out + ([r.words.numpy()] if r.words is not None else [])


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        assert np.array_equal(x, y), (x, y)


def _float_matrix(rng):
    return rng.normal(0.0, 3.0, (V, V))


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("dense", [False, True], ids=["ragged", "dense"])
def test_words_match_pallas_full_f64(rng, mode, dense):
    """Full mode, non-integral matrix in f64: the general ε tie path."""
    q, ql, t, tl = _batch(rng, 9, 8, 13, dense)  # R = 13: not a multiple of 8
    m = _float_matrix(rng)
    want = pallas_dp.fill_full_traced(q, ql, t, tl, jnp.asarray(m), 3.5, 1.25,
                                      mode=mode, dtype=jnp.float64)
    got = _port(q, ql, t, tl, m, 3.5, 1.25, torch.float64, mode=mode,
                with_dirs=True)
    _assert_same(got, want)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_words_match_pallas_packed_lut_f32(rng, mode):
    """BLOSUM62 in f32 takes the Pallas packed-LUT path with its integer
    tie shortcut; the port's ε rule must give the same words."""
    q, ql, t, tl = _batch(rng, 11, 20, 12, dense=False)
    mat_arg, packed, bits, bias = pallas_dp.lut_matrix_arg(blosum62(), jnp.float32)
    assert packed
    want = pallas_dp.fill_full_traced(q, ql, t, tl, mat_arg, 11.0, 2.0, mode=mode,
                                      dtype=jnp.float32, packed_lut=True,
                                      lut_bits=bits, lut_bias=bias)
    got = _port(q, ql, t, tl, blosum62(), 11.0, 2.0, torch.float32, mode=mode,
                with_dirs=True)
    _assert_same(got, want)


@pytest.mark.parametrize("mode,track", [("local", False), ("global", False)])
def test_scores_only_matches_pallas(rng, mode, track):
    """Scores-only fill without argmax tracking (global mode forces
    tracking in both packages; local tracking is covered below)."""
    q, ql, t, tl = _batch(rng, 16, 6, 11, dense=False)
    m = blosum62()
    want = pallas_dp.fill_scores_traced(q, ql, t, tl, jnp.asarray(m, jnp.float64),
                                        11.0, 2.0, mode=mode, dtype=jnp.float64,
                                        track_argmax=track)
    got = _port(q, ql, t, tl, m, 11.0, 2.0, torch.float64, mode=mode,
                track_argmax=track)
    _assert_same(got, want)
    if mode == "local" and not track:
        assert not got[1].any() and not got[2].any() and not got[3].any()


def test_scores_match_fill_batch_pallas(rng):
    """The numpy-facing Pallas wrapper (scores-only with argmax tracking,
    packed LUT, f32)."""
    q, ql, t, tl = _batch(rng, 7, 9, 16, dense=False)
    r = pallas_dp.fill_batch_pallas(q, ql, t, tl, blosum62(), 11.0, 2.0,
                                    mode="local", with_planes=False,
                                    dtype=jnp.float32)
    got = _port(q, ql, t, tl, blosum62(), 11.0, 2.0, torch.float32, mode="local")
    _assert_same(got, [r.fmax, r.fy, r.fx, r.end])


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_matches_xla_engine_f64(rng, mode, batched):
    """Against the XLA lax.scan engine in f64: scores, argmax, end and the
    unpacked direction planes (borders included)."""
    B = 8
    q, ql, t, tl = _batch(rng, B, 12, 10, dense=False)
    m = (np.stack([_float_matrix(rng) for _ in range(B)]) if batched
         else _float_matrix(rng))
    r = xla_fill_batch(q, ql, t, tl, m, 2.5, 0.75, mode=mode, with_planes=True,
                       dtype=jnp.float64)
    got = _port(q, ql, t, tl, m, 2.5, 0.75, torch.float64, mode=mode,
                with_dirs=True)
    _assert_same(got[:4], [r.fmax, r.fy, r.fx, r.end])
    dirs = dirs_from_packed(got[4], ql, tl, mode)[:, : t.shape[1] + 1]
    assert np.array_equal(dirs, np.asarray(r.dirs))


def test_dpfill_carries_state(rng):
    """DPFill.from_numpy carries a (V, V) and a (B, V, V) matrix and the
    penalties; the buffer equals the numpy matrix and both fills equal
    the JAX engine's."""
    B = 6
    q, ql, t, tl = _batch(rng, B, 8, 9, dense=False)
    mats = np.stack([blosum62() + rng.integers(-2, 3, (V, V)) for _ in range(B)])
    mats = mats.astype(np.float64)
    for m in (blosum62().astype(np.float64), mats):
        dp = DPFill.from_numpy(m, 7.0, 3.0, device="cpu", dtype=torch.float64)
        assert dp.matrix.dtype == torch.float64
        assert np.array_equal(dp.matrix.numpy(), m)
        assert "matrix" in dict(dp.named_buffers())
        assert (dp.del_, dp.ext) == (7.0, 3.0)
        r = xla_fill_batch(q, ql, t, tl, m, 7.0, 3.0, mode="local",
                           with_planes=True, dtype=jnp.float64)
        got = _port(q, ql, t, tl, m, 7.0, 3.0, torch.float64, mode="local",
                    with_dirs=True)
        _assert_same(got[:4], [r.fmax, r.fy, r.fx, r.end])
        dirs = dirs_from_packed(got[4], ql, tl, "local")[:, : t.shape[1] + 1]
        assert np.array_equal(dirs, np.asarray(r.dirs))


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((2, 8), dtype=torch.int32)
    ln = torch.full((2,), 8, dtype=torch.int32)
    m = torch.zeros((V, V), dtype=torch.float64)
    with pytest.raises(TypeError):
        dp_fill.fill(q.long(), ln, q, ln, m, 1.0, 1.0)
    with pytest.raises(TypeError):
        dp_fill.fill(q, ln, q, ln, m.int(), 1.0, 1.0)
    with pytest.raises(ValueError):
        dp_fill.fill(q, ln, q[:1], ln, m, 1.0, 1.0)
    with pytest.raises(ValueError):
        dp_fill.fill(q.T, ln, q, ln, m, 1.0, 1.0)
    with pytest.raises(ValueError):
        dp_fill.fill(q, ln, q, ln, m, 1.0, 1.0, mode="pwm")
    with pytest.raises(ValueError):
        dp_fill.fill(q, ln, q + V, ln, m, 1.0, 1.0)
    with pytest.raises(ValueError):
        dp_fill.fill(q - 1, ln, q, ln, m, 1.0, 1.0)
    # CPU tensors never launch the kernel
    before = (dp_fill.launches.scores, dp_fill.launches.dirs)
    dp_fill.fill(q, ln, q, ln, m, 1.0, 1.0, with_dirs=True)
    assert (dp_fill.launches.scores, dp_fill.launches.dirs) == before


@pytest.mark.parametrize("mode", ["local", "global"])
def test_targets_in_the_kernels_layout_with_their_code_range(rng, mode):
    """``t`` as the ``.T`` view of a contiguous (R, B) tensor, with the
    codes' range given (the search's kept buckets), fills as the
    contiguous ``t`` does; a range outside the matrix is refused."""
    q, ql, t, tl = _batch(rng, 40, 24, 32, dense=False)
    m = torch.as_tensor(blosum62(), dtype=torch.float64)
    args = [torch.from_numpy(a) for a in (q, ql, t, tl)]
    want = dp_fill.fill(*args, m, 11.0, 2.0, mode=mode)
    tT = torch.from_numpy(np.ascontiguousarray(t.T))
    lo, hi = int(min(q.min(), t.min())), int(max(q.max(), t.max()))
    got = dp_fill.fill(args[0], args[1], tT.T, args[3], m, 11.0, 2.0, mode=mode,
                       code_range=(lo, hi))
    for f in ("fmax", "fy", "fx", "end"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for bad in ((lo, V), (-1, hi)):
        with pytest.raises(ValueError, match="must lie in"):
            dp_fill.fill(args[0], args[1], tT.T, args[3], m, 11.0, 2.0, code_range=bad)
