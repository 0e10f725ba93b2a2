"""Cross-engine differential fuzzing of the port, on the inputs of three
tests of the reference's ``tests/test_fuzz_differential.py``: the port's
plain batched engine (``ops/scan_engine.py``, score plane and packed
directions) against the reference fill (the JAX package's native C++
engine, else ``aligner_tpu/oracle.py``), with integral and non-integral
matrices and penalties, and the port's checkpoint-and-replay alignment of
one global pair (``ops/wavefront.align_single_global_chunked`` on the
plain row-scan fill and the plain replay walk) against the JAX package's
host engine.  The band-engine case of that file is in
``tests/test_torch_sp_engines.py``."""

import numpy as np
import torch

from aligner_tpu import native, oracle
from aligner_tpu.matrices import blosum62
from aligner_tpu_torch.ops.dp_fill import dirs_from_packed, planes_from_interior
from aligner_tpu_torch.ops.scan_engine import fill_batch

torch.set_num_threads(1)


def _ref_fill(q, t, m, d, e, mode):
    if native.available():
        return native.fill(q, t, m, d, e, mode)
    fn = oracle.fill_local if mode == "local" else oracle.fill_global
    return fn(q, t, m, d, e)


def _port_planes(q, ql, t, tl, mat, d, e, mode):
    """The port's plain fill in f64 with directions and the score plane, as
    (B, R + 1, C + 1) score and direction planes."""
    r = fill_batch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, ql, t, tl)),
                   torch.as_tensor(np.array(mat), dtype=torch.float64), d, e, mode=mode,
                   with_dirs=True, with_scores_plane=True)
    return (planes_from_interior(r.plane.numpy(), ql, tl, mode, d, t.shape[1]),
            dirs_from_packed(r.words.numpy(), ql, tl, mode))


def test_differential_scan_engine_100(rng):
    M = np.asarray(blosum62())
    B = 25
    for trial in range(4):
        Cmax = int(rng.integers(4, 32))
        Rmax = int(rng.integers(4, 32))
        vol = 24 if trial % 2 == 0 else 4
        mat = M if vol == 24 else rng.integers(-4, 8, (4, 4)).astype(np.float64)
        if trial == 3:
            mat = mat + rng.normal(size=mat.shape)  # non-integral
        d, e = float(rng.integers(1, 20)), float(rng.integers(1, 8))
        q = np.zeros((B, Cmax), np.int32)
        t = np.zeros((B, Rmax), np.int32)
        ql = rng.integers(1, Cmax + 1, B).astype(np.int32)
        tl = rng.integers(1, Rmax + 1, B).astype(np.int32)
        for b in range(B):
            q[b, : ql[b]] = rng.integers(0, vol, ql[b])
            t[b, : tl[b]] = rng.integers(0, vol, tl[b])
        mode = "local" if trial % 2 == 0 else "global"
        plane, dirs = _port_planes(q, ql, t, tl, mat, d, e, mode)
        for b in range(B):
            p_o, d_o = _ref_fill(
                q[b, : ql[b]].astype(np.int8), t[b, : tl[b]].astype(np.int8),
                mat, d, e, mode,
            )
            assert np.array_equal(p_o, plane[b, : tl[b] + 1, : ql[b] + 1]), (trial, b)
            assert np.array_equal(d_o, dirs[b, : tl[b] + 1, : ql[b] + 1]), (trial, b)


def test_differential_chunked_device_walk(rng):
    """Checkpoint-and-replay + the replay walk vs the host full-plane
    alignment on random shapes, penalties, alphabets, and block sizes
    (global mode; the chunked path requires integral int8 matrices)."""
    from aligner_tpu import host
    from aligner_tpu_torch.ops.wavefront import align_single_global_chunked

    M = np.asarray(blosum62())
    for trial in range(6):
        vol = 24 if trial % 2 == 0 else 4
        mat = (
            M if vol == 24
            else rng.integers(-4, 8, (4, 4)).astype(np.float64)
        )
        d = float(rng.integers(1, 20))
        e = float(rng.integers(1, 8))
        C = int(rng.integers(1, 180))
        R = int(rng.integers(1, 180))
        q = rng.integers(0, vol, C).astype(np.int8)
        t = rng.integers(0, vol, R).astype(np.int8)
        tb = 16 * int(rng.integers(1, 5))
        ref = host.align_global(q, t, mat, d, e)
        end, qa, ta, coords = align_single_global_chunked(
            q, t, mat, d, e, tb_rows=tb, tr=16, device="cpu"
        )
        assert end == ref.score[R, C], (trial, C, R, d, e, tb)
        np.testing.assert_array_equal(qa, ref.query_aligned)
        np.testing.assert_array_equal(ta, ref.target_aligned)
        assert coords == ((1, C), (1, R))


def test_differential_full_mode_nonintegral_penalties(rng):
    """Full-mode (direction-plane) parity with NON-integral penalties: the
    score plane and the directions of the port's plain fill equal the
    reference fill's, bit for bit (the reference's own test holds its
    Pallas kernel's plane to a tolerance)."""
    M = np.asarray(blosum62())
    for trial in range(4):
        d = float(rng.integers(1, 20)) + 0.5
        e = float(rng.integers(1, 8)) + 0.25
        C = int(rng.integers(2, 40))
        R = int(rng.integers(2, 40))
        q = rng.integers(0, 24, (1, C)).astype(np.int32)
        t = rng.integers(0, 24, (1, R)).astype(np.int32)
        ql = np.array([C], np.int32)
        tl = np.array([R], np.int32)
        plane_o, dirs_o = _ref_fill(q[0].astype(np.int8), t[0].astype(np.int8), M, d, e,
                                    "local")
        plane, dirs = _port_planes(q, ql, t, tl, M, d, e, "local")
        np.testing.assert_array_equal(dirs[0, : R + 1], dirs_o)
        np.testing.assert_array_equal(plane[0, : R + 1], plane_o)
