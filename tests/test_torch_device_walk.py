"""The port's batched walk (plain PyTorch version of csrc/device_walk.cu)
against ``aligner_tpu.ops.device_walk.walk_batch`` on the same packed
direction words, bit for bit, and its host decode against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligner_tpu.matrices import blosum62
from aligner_tpu.ops import device_walk as ref_walk
from aligner_tpu.ops.scan_engine import fill_batch as xla_fill_batch
from aligner_tpu_torch.ops import device_walk as port_walk

torch.set_num_threads(1)


def _pack(dirs: np.ndarray) -> np.ndarray:
    """(B, R+1, C+1) uint8 bordered planes → (B, R8/8, C) int32 words, row
    r at bit 2·(r % 8), padded rows Beginning — the fill kernels' layout."""
    d = dirs[:, 1:, 1:].astype(np.int64)
    B, R, C = d.shape
    R8 = -(-R // 8) * 8
    d = np.concatenate([d, np.full((B, R8 - R, C), 3, np.int64)], axis=1)
    w = (d.reshape(B, R8 // 8, 8, C) << (2 * np.arange(8))[None, None, :, None]).sum(2)
    return w.astype(np.int32)


def _compare(words, mode, sy, sx, R, C):
    want = ref_walk.walk_batch(jnp.asarray(words), "packed", mode, sy, sx, R, C)
    got = port_walk.walk_batch(torch.from_numpy(words), mode, sy, sx, R, C)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return got


def _xla_words(q, ql, t, tl, mode):
    r = xla_fill_batch(q, ql, t, tl, blosum62(), 11.0, 2.0, mode=mode,
                       with_planes=True, dtype=jnp.float64)
    return _pack(np.asarray(r.dirs)), np.asarray(r.fy), np.asarray(r.fx)


def _padded(seqs):
    L = -(-max(len(s) for s in seqs) // 8) * 8
    out = np.zeros((len(seqs), L), np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, np.array([len(s) for s in seqs], np.int32)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_walk_matches_reference_on_fill_words(rng, mode):
    qs = [rng.integers(0, 24, rng.integers(1, 30)) for _ in range(13)]
    ts = [s.copy() if i % 2 else rng.integers(0, 24, rng.integers(1, 30))
          for i, s in enumerate(qs)]
    q, ql = _padded(qs)
    t, tl = _padded(ts)
    words, fy, fx = _xla_words(q, ql, t, tl, mode)
    sy, sx = (tl, ql) if mode == "global" else (fy, fx)
    steps, lens, ey, ex = _compare(words, mode, sy, sx, t.shape[1], q.shape[1])
    a = port_walk.decode_pair_batch(steps, lens, sy, sx, q, t)
    b = ref_walk.decode_pair_batch(steps, lens, sy, sx, q, t)
    for xs, ys in zip(a, b):
        assert all(np.array_equal(u, v) and u.dtype == v.dtype for u, v in zip(xs, ys))


@pytest.mark.parametrize("mode", ["local", "global"])
def test_walk_matches_reference_on_random_words(rng, mode):
    """Arbitrary direction codes and start cells, borders included."""
    B, R8, C = 17, 16, 11
    words = rng.integers(-2**31, 2**31, (B, R8 // 8, C), dtype=np.int64)
    words = words.astype(np.int32)
    sy = rng.integers(0, R8 + 1, B).astype(np.int32)
    sx = rng.integers(0, C + 1, B).astype(np.int32)
    _compare(words, mode, sy, sx, R8, C)


def test_walk_long_asymmetric_global(rng):
    """S = R + C + 1 covers the all-gap corner walks on asymmetric shapes
    (the case of tests/test_device_walk.py::test_device_walk_long_pairs)."""
    qs = [rng.integers(0, 24, 300), rng.integers(0, 24, 3)]
    ts = [rng.integers(0, 24, 5), rng.integers(0, 24, 290)]
    q, ql = _padded(qs)
    t, tl = _padded(ts)
    words, _, _ = _xla_words(q, ql, t, tl, "global")
    steps, lens, _, _ = _compare(words, "global", tl, ql, t.shape[1], q.shape[1])
    assert lens.max() >= 290


def test_decode_pair_batch_matches_reference(rng):
    B, S, L = 13, 40, 48
    steps = rng.integers(0, 4, (S, B)).astype(np.uint8)
    lens = rng.integers(0, S, B).astype(np.int32)
    sy = rng.integers(np.maximum(lens, 1), L + 1).astype(np.int32)
    sx = rng.integers(np.maximum(lens, 1), L + 1).astype(np.int32)
    q = rng.integers(0, 24, (B, L)).astype(np.int32)
    t = rng.integers(0, 24, (B, L)).astype(np.int32)
    a = port_walk.decode_pair_batch(steps, lens, sy, sx, q, t)
    b = ref_walk.decode_pair_batch(steps, lens, sy, sx, q, t)
    for xs, ys in zip(a, b):
        assert all(np.array_equal(u, v) and u.dtype == v.dtype for u, v in zip(xs, ys))


def test_walk_rejects_bad_inputs():
    w = torch.zeros((2, 1, 8), dtype=torch.int32)
    s = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_walk.walk(w.long(), s, s, S=17, mode="local")
    with pytest.raises(ValueError):
        port_walk.walk(w, s[:1], s, S=17, mode="local")
    with pytest.raises(ValueError):
        port_walk.walk(w, s, s, S=17, mode="pwm")
    before = port_walk.launches.walk
    port_walk.walk(w, s, s, S=17, mode="global")
    assert port_walk.launches.walk == before
