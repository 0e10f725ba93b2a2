"""Plane-level parity of the port's plain batched engine
(``aligner_tpu_torch/ops/scan_engine.py``, the plain version of the fill
kernel) with ``aligner_tpu/oracle.py``, on the inputs of the reference's
``tests/test_scan_engine.py``: the score plane (``with_scores_plane``, its
borders added by ``planes_from_interior``) and the direction plane (the
packed words through ``dirs_from_packed``) of every problem against the
oracle's, the argmax cell and maximum of local fills, the end cell,
per-problem transformed matrices in f64, PWM mode, and f32 against f64 for
an integer matrix."""

import numpy as np
import pytest
import torch

from aligner_tpu import oracle
from aligner_tpu.matrices import blosum62, random_pwm, transform_matrix
from aligner_tpu_torch.ops.dp_fill import dirs_from_packed, planes_from_interior
from aligner_tpu_torch.ops.scan_engine import fill_batch, fill_pwm_batch

torch.set_num_threads(1)


def _random_batch(rng, B, Cmax, Rmax, vol=24):
    qs = np.zeros((B, Cmax), np.int32)
    ts = np.zeros((B, Rmax), np.int32)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ql[b] = rng.integers(1, Cmax + 1)
        tl[b] = rng.integers(1, Rmax + 1)
        qs[b, : ql[b]] = rng.integers(0, vol, ql[b])
        ts[b, : tl[b]] = rng.integers(0, vol, tl[b])
    return qs, ql, ts, tl


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _fill(q, ql, t, tl, matrix, del_, ext, mode, dtype):
    """The plain fill with directions and the score plane; returns the
    result and its (B, R + 1, C + 1) score and direction planes."""
    r = fill_batch(*_t(q, ql, t, tl), torch.as_tensor(np.array(matrix), dtype=dtype),
                   del_, ext, mode=mode, with_dirs=True, with_scores_plane=True)
    plane = planes_from_interior(r.plane.numpy(), ql, tl, mode, del_, t.shape[1])
    dirs = dirs_from_packed(r.words.numpy(), ql, tl, mode)
    return r, plane, dirs


@pytest.mark.parametrize("mode", ["local", "global"])
def test_planes_match_oracle(rng, mode):
    M = blosum62()
    q, ql, t, tl = _random_batch(rng, 12, 16, 16)
    r, plane, dirs = _fill(q, ql, t, tl, M, 11.0, 2.0, mode, torch.float64)
    fn = oracle.fill_local if mode == "local" else oracle.fill_global
    for b in range(12):
        a_o, d_o = fn(q[b, : ql[b]], t[b, : tl[b]], M, 11.0, 2.0)
        assert np.array_equal(a_o, plane[b, : tl[b] + 1, : ql[b] + 1])
        assert np.array_equal(d_o, dirs[b, : tl[b] + 1, : ql[b] + 1])
        if mode == "local":
            my, mx = oracle.argmax_first_rowmajor(a_o)
            assert (int(r.fy[b]), int(r.fx[b])) == (my, mx)
            assert float(r.fmax[b]) == a_o.max()
        assert float(r.end[b]) == a_o[tl[b], ql[b]]


def test_batched_transformed_matrices(rng):
    """Per-problem non-integer matrices (the heuristic path) in f64."""
    M = blosum62()
    freqs = rng.random(24)
    freqs /= freqs.sum()
    mats = np.stack(
        [transform_matrix(M + rng.normal(size=(24, 24)), 2.0, 1e4, freqs) for _ in range(4)]
    )
    q, ql, t, tl = _random_batch(rng, 4, 10, 10)
    _, plane, dirs = _fill(q, ql, t, tl, mats, 7.0, 3.0, "local", torch.float64)
    for b in range(4):
        a_o, d_o = oracle.fill_local(q[b, : ql[b]], t[b, : tl[b]], mats[b], 7.0, 3.0)
        assert np.array_equal(a_o, plane[b, : tl[b] + 1, : ql[b] + 1])
        assert np.array_equal(d_o, dirs[b, : tl[b] + 1, : ql[b] + 1])


def test_pwm_planes_match_oracle(rng):
    pwm = random_pwm(9, rng)
    q, ql, _, _ = _random_batch(rng, 8, 20, 20, vol=4)
    qt, qlt = _t(q, ql)
    r = fill_pwm_batch(qt, qlt, torch.as_tensor(pwm, dtype=torch.float64), 3.0, 1.0,
                       with_dirs=True, with_scores_plane=True)
    W = pwm.shape[1]
    full = np.full(8, W, np.int32)
    plane = planes_from_interior(r.plane.numpy(), full, ql, "local", 3.0, q.shape[1])
    dirs = dirs_from_packed(r.words.numpy(), full, ql, "local")
    for b in range(8):
        a_o, d_o = oracle.fill_pwm(q[b, : ql[b]], pwm, 3.0, 1.0)
        assert np.array_equal(a_o, plane[b, : ql[b] + 1, :])
        assert np.array_equal(d_o, dirs[b, : ql[b] + 1, :])
        my, mx = oracle.argmax_first_rowmajor(a_o)
        assert (int(r.fy[b]), int(r.fx[b])) == (my, mx)


def test_f32_exact_for_integer_matrices(rng):
    """Integer-valued matrices give bit-identical results in f32."""
    M = blosum62()
    q, ql, t, tl = _random_batch(rng, 6, 12, 12)
    r32, p32, d32 = _fill(q, ql, t, tl, M, 11.0, 2.0, "local", torch.float32)
    r64, p64, d64 = _fill(q, ql, t, tl, M, 11.0, 2.0, "local", torch.float64)
    assert p32.dtype == np.float32 and p64.dtype == np.float64
    assert np.array_equal(p32.astype(np.float64), p64)
    assert np.array_equal(d32, d64)
    assert torch.equal(r32.words, r64.words)
