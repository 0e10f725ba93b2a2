"""The port's mesh steps (``aligner_tpu_torch.parallel.mesh``) against the
JAX package's on conftest's 8 virtual devices, the cases of
``tests/test_parallel.py``.

The port's mesh has 8 CPU slots, one for each virtual device.  Inputs are
made with numpy from a seed and handed to both packages.  Scores, best
matrices and winning indices are held bit for bit (also against the
oracle); the window statistics (mean, std, z), whose sums the two packages
reduce in different trees, to a relative 1e-12 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligner_tpu import oracle
from aligner_tpu.matrices import blosum62, random_pwm
from aligner_tpu.parallel import mesh as ref
from aligner_tpu_torch.errors import DeviceUnavailable, ValidationError
from aligner_tpu_torch.parallel import mesh as port

torch.set_num_threads(1)

F64 = torch.float64
STATS_RTOL = 1e-12


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return ref.make_mesh(8), port.make_mesh(8, devices=["cpu"] * 8)


def _pairs(rng, B, L, V=24):
    q = rng.integers(0, V, (B, L)).astype(np.int32)
    t = rng.integers(0, V, (B, L)).astype(np.int32)
    ql = rng.integers(0, L + 1, B).astype(np.int32)
    tl = rng.integers(0, L + 1, B).astype(np.int32)
    return q, ql, t, tl


def test_mesh_shape(meshes):
    jm, pm = meshes
    assert pm.shape == dict(jm.shape)
    assert pm.shape["data"] * pm.shape["matrix"] == 8
    assert pm.shape["data"] >= pm.shape["matrix"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_factors_like_the_reference(n):
    assert port.make_mesh(n, devices=["cpu"] * 8).grid.shape == tuple(
        ref.make_mesh(n).devices.shape)


def test_make_mesh_refusals(monkeypatch):
    with pytest.raises(ValidationError, match="9 devices requested"):
        port.make_mesh(9, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        port.make_mesh()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["local", "global"])
def test_sharded_scores_match_jax_and_oracle(meshes, rng, engine, mode):
    jm, pm = meshes
    M = np.asarray(blosum62())
    q, ql, t, tl = _pairs(rng, 16, 12)
    got = port.sharded_scores(pm, q, ql, t, tl, M, 11.0, 2.0, mode=mode, dtype=F64)
    want = ref.sharded_scores(jm, q, ql, t, tl, M, 11.0, 2.0, mode=mode,
                              dtype=jnp.float64, engine=engine)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fill = oracle.fill_local if mode == "local" else oracle.fill_global
    for b in np.flatnonzero((ql > 0) & (tl > 0)):  # an empty problem scores 0
        a, _ = fill(q[b, :ql[b]], t[b, :tl[b]], M, 11.0, 2.0)
        if mode == "local":
            assert float(got[0][b]) == a.max()
        else:
            assert float(got[3][b]) == a[tl[b], ql[b]]


def test_sharded_scores_refuses_an_uneven_batch(meshes, rng):
    _, pm = meshes
    q, ql, t, tl = _pairs(rng, 6, 8)
    with pytest.raises(ValidationError, match="pad with zero-length problems"):
        port.sharded_scores(pm, q, ql, t, tl, np.asarray(blosum62()), 11.0, 2.0)


def _windows(rng, B, L, ragged):
    ws = rng.integers(0, 4, (B, L)).astype(np.int32)
    wl = (rng.integers(0, L + 1, B) if ragged else np.full(B, L)).astype(np.int32)
    return ws, wl


def _hold_scan(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_window_scan_step_stats(meshes, rng, engine, ragged):
    jm, pm = meshes
    pwm = random_pwm(8, rng)
    ws, wl = _windows(rng, 16, 20, ragged)
    got = port.window_scan_step(pm, ws, wl, pwm, 3.0, 1.0, dtype=F64)
    want = ref.window_scan_step(jm, ws, wl, pwm, 3.0, 1.0, dtype=jnp.float64,
                                engine=engine)
    _hold_scan(got, want)
    s = got[0].numpy()[wl > 0]
    assert np.isclose(float(got[2]), s.mean()) and np.isclose(float(got[3]), s.std())
    for b in range(4):
        a, _ = oracle.fill_pwm(ws[b, :wl[b]], pwm, 3.0, 1.0)
        assert float(got[0][b]) == a.max()


def test_window_scan_all_padded_launch(meshes, rng):
    """The skip-mask pattern: every window empty gives 0/0/0 statistics and
    zero z-values, not NaN."""
    jm, pm = meshes
    pwm = random_pwm(8, rng)
    ws = rng.integers(0, 4, (16, 16)).astype(np.int32)
    wl = np.zeros(16, np.int32)
    got = port.window_scan_step(pm, ws, wl, pwm, 3.0, 1.0, dtype=F64)
    want = ref.window_scan_step(jm, ws, wl, pwm, 3.0, 1.0, dtype=jnp.float64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[2]) == float(got[3]) == 0.0 and not got[1].any()


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_matrix_population_best(meshes, rng, ties):
    jm, pm = meshes
    M = np.asarray(blosum62())
    Bq, L, nM = 4, 10, 6
    q, _, t, _ = _pairs(rng, Bq, L)
    ql = np.full(Bq, L, np.int32)
    tl = np.full(Bq, L, np.int32)
    mats = np.stack([M + rng.integers(-2, 3, (24, 24)) for _ in range(nM)]).astype(
        np.float64)
    if ties:
        # equal matrices within a matrix shard (0-2) and across the two
        # (3-5): the smallest index must win
        mats[2] = mats[4] = mats[1]
        mats[5] = mats[0]
    best, win = port.matrix_population_step(pm, q, ql, t, tl, mats, 7.0, 3.0, dtype=F64)
    jbest, jwin = ref.matrix_population_step(jm, q, ql, t, tl, mats, 7.0, 3.0,
                                             dtype=jnp.float64)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    tied = 0
    for b in range(Bq):
        fs = [oracle.fill_local(q[b], t[b], mats[m], 7.0, 3.0)[0].max() for m in range(nM)]
        assert float(best[b]) == max(fs)
        assert int(win[b]) == int(np.argmax(fs))
        tied += fs.count(max(fs)) > 1
    assert tied or not ties  # the tied matrices do tie at some pair's best


def test_matrix_population_refuses_an_uneven_population(meshes, rng):
    _, pm = meshes
    q, ql, t, tl = _pairs(rng, 4, 8)
    mats = np.zeros((3, 24, 24))
    with pytest.raises(ValidationError, match="do not shard evenly"):
        port.matrix_population_step(pm, q, ql, t, tl, mats, 7.0, 3.0)
