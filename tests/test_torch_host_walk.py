"""The host walks (``walk="host"``) against the default walk and against the
JAX package under ``ALIGNER_DEVICE_WALK=0``, on the CPU, bit for bit.

Mirrors every test of ``tests/test_device_walk.py`` (host equal to device
in both modes, skip and padding, PWM, the dead local problem, long pairs,
the PWM batch's padding and skips), ``tests/test_native.py``'s
``traceback_batch`` against the Python walker, and the huge-pair and
column-blocked host walks at small shapes (``tests/test_wavefront.py``'s
chunked walk, ``tests/test_wavefront_sp.py``'s tiled walk).  The port reads
no ``ALIGNER_DEVICE_WALK``: setting it changes nothing.  Tolerance: none."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.ops import wavefront as ref_wf
from aligner_tpu.parallel import wavefront_sp as ref_sp
from aligner_tpu_torch import align as port_align
from aligner_tpu_torch import native, oracle
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.parallel import wavefront_sp as sp

torch.set_num_threads(1)

B62 = np.asarray(ref.blosum62())


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def _rand_batch(rng, n, lo=1, hi=60, v=24, related=False):
    qs = [rng.integers(0, v, rng.integers(lo, hi)).astype(np.int8) for _ in range(n)]
    if related:
        # mutated copies: local mode always has a positive-scoring cell
        ts = []
        for q in qs:
            t = q.copy()
            if len(t) > 1:  # keep t[0] == q[0]: a positive diagonal cell
                k = max(1, len(t) // 8)
                t[rng.integers(1, len(t), k)] = rng.integers(0, v, k)
            ts.append(t)
    else:
        ts = [rng.integers(0, v, rng.integers(lo, hi)).astype(np.int8) for _ in range(n)]
    return qs, ts


def _ref_host(monkeypatch, fn, *args, **kw):
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "0")
    try:
        return fn(*args, **kw)
    finally:
        monkeypatch.delenv("ALIGNER_DEVICE_WALK")


def _assert_pairs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert np.array_equal(a.alignment.query, b.alignment.query)
        assert np.array_equal(a.alignment.target, b.alignment.target)
        assert a.alignment.query.dtype == b.alignment.query.dtype
        assert a.alignment.coords == b.alignment.coords
        assert a.alignment.f == b.alignment.f


def _assert_pwm_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert np.array_equal(a.alignment.numbered, b.alignment.numbered)
        assert np.array_equal(a.alignment.query, b.alignment.query)
        assert a.alignment.coords == b.alignment.coords
        assert a.alignment.f == b.alignment.f


def _both_walks(fn, *args, **kw):
    return fn(*args, walk="device", **kw), fn(*args, walk="host", **kw)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_host_walk_matches_device(monkeypatch, mode):
    rng = np.random.default_rng(["global", "local"].index(mode))
    qs, ts = _rand_batch(rng, 17, related=(mode == "local"))
    dev, host = _both_walks(port.batch_align, qs, ts, B62, 11.0, 2.0, mode=mode,
                            device="cpu", with_alignments=True)
    want = _ref_host(monkeypatch, ref.batch_align, qs, ts, B62, 11.0, 2.0, mode=mode,
                     backend="xla", with_alignments=True)
    _assert_pairs_equal(dev, want)
    _assert_pairs_equal(host, want)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_host_walk_skip_and_pad(monkeypatch, mode):
    """Skipped problems make the Python walkers walk (the native batch call
    takes a batch with none skipped)."""
    rng = np.random.default_rng(10 + ["global", "local"].index(mode))
    qs, ts = _rand_batch(rng, 9, related=(mode == "local"))
    skip = np.zeros(9, bool)
    skip[[1, 4, 7]] = True
    kw = dict(mode=mode, with_alignments=True, pad_to=16, skip=skip)
    dev, host = _both_walks(port.batch_align, qs, ts, B62, 11.0, 2.0, device="cpu", **kw)
    want = _ref_host(monkeypatch, ref.batch_align, qs, ts, B62, 11.0, 2.0, backend="xla",
                     **kw)
    _assert_pairs_equal(dev, want)
    _assert_pairs_equal(host, want)
    for i in (1, 4, 7):
        assert host[i] is None


@pytest.mark.parametrize("mode", ["global", "local"])
def test_python_walkers_equal_the_native_batch_walk(monkeypatch, mode):
    """Without the native runtime the host walk takes the Python walkers,
    problem by problem; both equal the device walk."""
    rng = np.random.default_rng(20 + ["global", "local"].index(mode))
    qs, ts = _rand_batch(rng, 11, related=(mode == "local"))
    kw = dict(mode=mode, device="cpu", with_alignments=True)
    dev = port.batch_align(qs, ts, B62, 11.0, 2.0, **kw)
    calls = []
    real = native.traceback_batch
    monkeypatch.setattr(native, "traceback_batch", lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    _assert_pairs_equal(port.batch_align(qs, ts, B62, 11.0, 2.0, walk="host", **kw), dev)
    assert calls == [1]
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_pairs_equal(port.batch_align(qs, ts, B62, 11.0, 2.0, walk="host", **kw), dev)
    assert calls == [1]


def test_host_walk_pwm_matches_device(monkeypatch):
    rng = np.random.default_rng(3)
    pwm = rng.normal(2.0, 3.0, (4, 12))
    qs = [rng.integers(0, 4, rng.integers(3, 40)).astype(np.int8) for _ in range(13)]
    dev, host = _both_walks(port.batch_align_pwm, qs, pwm, 3.0, 1.0, device="cpu",
                            with_alignments=True)
    want = _ref_host(monkeypatch, ref.batch_align_pwm, qs, pwm, 3.0, 1.0, backend="xla",
                     with_alignments=True)
    _assert_pwm_equal(dev, want)
    _assert_pwm_equal(host, want)
    a = port.align_pwm(qs[0], pwm, 3.0, 1.0, device="cpu", walk="host")
    _assert_pwm_equal([a], [want[0]])


def test_host_walk_empty_local_returns_none(monkeypatch):
    """A local problem with no positive-scoring cell yields None for that
    entry, on both walks and in the reference's host walk."""
    m = np.full((24, 24), -5.0)
    qs = [np.arange(8, dtype=np.int8)]
    ts = [np.arange(8, dtype=np.int8)[::-1].copy()]
    for walk in ("device", "host"):
        assert port.batch_align(qs, ts, m, 11.0, 2.0, mode="local", device="cpu",
                                with_alignments=True, walk=walk) == [None]
    assert _ref_host(monkeypatch, ref.batch_align, qs, ts, m, 11.0, 2.0, mode="local",
                     backend="xla", with_alignments=True) == [None]
    with pytest.raises(port.ResultIsEmpty):
        port.align_local(qs[0], ts[0], m, 11.0, 2.0, device="cpu", walk="host")


def test_host_walk_long_pairs(monkeypatch):
    """Walks of R + C + 1 steps (all-gap corner walks) on asymmetric shapes."""
    rng = np.random.default_rng(4)
    qs = [rng.integers(0, 24, 300).astype(np.int8), rng.integers(0, 24, 3).astype(np.int8)]
    ts = [rng.integers(0, 24, 5).astype(np.int8), rng.integers(0, 24, 290).astype(np.int8)]
    kw = dict(mode="global", with_alignments=True)
    dev, host = _both_walks(port.batch_align, qs, ts, B62, 11.0, 2.0, device="cpu", **kw)
    want = _ref_host(monkeypatch, ref.batch_align, qs, ts, B62, 11.0, 2.0, backend="xla",
                     **kw)
    _assert_pairs_equal(dev, want)
    _assert_pairs_equal(host, want)


def test_batch_align_pwm_pad_and_skip(monkeypatch):
    """Padded problems are not returned, skipped ones are None, survivors
    equal an unpadded run, on both walks."""
    rng = np.random.default_rng(5)
    pwm = rng.integers(-3, 9, (4, 12)).astype(np.float64)
    qs4 = [rng.integers(0, 4, rng.integers(8, 40)).astype(np.int8) for _ in range(5)]
    skip = np.array([False, True, False, False, True])
    want = _ref_host(monkeypatch, ref.batch_align_pwm, qs4, pwm, 3.0, 1.0, backend="xla",
                     with_alignments=True, pad_to=8, skip=skip)
    for walk in ("device", "host"):
        plain = port.batch_align_pwm(qs4, pwm, 3.0, 1.0, device="cpu",
                                     with_alignments=True, walk=walk)
        padded = port.batch_align_pwm(qs4, pwm, 3.0, 1.0, device="cpu",
                                      with_alignments=True, pad_to=8, skip=skip, walk=walk)
        assert len(padded) == 5
        _assert_pwm_equal(padded, want)
        for a, b, s in zip(padded, plain, skip):
            if not s:
                _assert_pwm_equal([a], [b])


def test_traceback_batch_matches_python():
    """``tests/test_native.py::test_traceback_batch_matches_python`` on the
    port's copies of the native runtime and the oracle."""
    rng = np.random.default_rng(0)
    B, L = 6, 20
    q = rng.integers(0, 24, (B, L)).astype(np.int8)
    t = rng.integers(0, 24, (B, L)).astype(np.int8)
    dirs = np.zeros((B, L + 1, L + 1), np.uint8)
    sy = np.zeros(B, np.int64)
    sx = np.zeros(B, np.int64)
    expected = []
    for b in range(B):
        plane, d = oracle.fill_local(q[b], t[b], B62, 11.0, 2.0)
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
        assert list(wq[b]) + [int(q[b][sx[b] - 1])] == qa
        assert list(wt[b]) + [int(t[b][sy[b] - 1])] == ta
        assert (ey[b], ex[b]) == (cy, cx)


CHUNKED = [(150, 300), (97, 64), (64, 130), (20, 3)]


@pytest.mark.parametrize("C,R", CHUNKED, ids=[f"{c}x{r}" for c, r in CHUNKED])
def test_chunked_host_walk_matches_device_walk(monkeypatch, C, R):
    """``tests/test_wavefront.py::test_chunked_device_walk_matches_host_walk``:
    block-straddling walks and the border runs, against the JAX package's
    host walk over downloaded blocks."""
    rng = np.random.default_rng(C * 7 + R)
    q = rng.integers(0, 24, C).astype(np.int8)
    t = rng.integers(0, 24, R).astype(np.int8)
    kw = dict(tb_rows=64, tr=16)
    dev, host = _both_walks(wf.align_single_global_chunked, q, t, B62, 11.0, 2.0,
                            device="cpu", **kw)
    want = _ref_host(monkeypatch, ref_wf.align_single_global_chunked, q, t, B62, 11.0,
                     2.0, interpret=True, **kw)
    for got in (dev, host):
        assert got[0] == want[0] and got[3] == want[3]
        for x, y in zip(got[1:3], want[1:3]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_chunked_host_walk_replays_only_the_blocks_it_crosses(monkeypatch):
    """A walk that meets the left border in the last block replays that one
    block; the rest are never filled with directions."""
    q = np.arange(20, dtype=np.int8) % 24
    t = np.concatenate([np.full(300, 3, np.int8), q])  # the match sits at the bottom
    calls = []
    real = wf.row_scan
    monkeypatch.setattr(wf, "row_scan", lambda *a, **k: calls.append(k["with_dirs"])
                        or real(*a, **k))
    got = wf.align_single_global_chunked(q, t, B62, 11.0, 2.0, tb_rows=64, tr=16,
                                         device="cpu", walk="host")
    assert calls.count(True) < len(t) // 64 + 1
    want = oracle.align_global(q, t, B62, 11.0, 2.0)
    assert np.array_equal(got[1], want.query_aligned)
    assert np.array_equal(got[2], want.target_aligned)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()).reshape(-1), ("data",))


SHARDED = [(300, 150), (128 * 8, 100), (70, 260)]


@pytest.mark.parametrize("C,R", SHARDED, ids=[f"{c}x{r}" for c, r in SHARDED])
def test_sharded_host_walk_matches_device_walk(monkeypatch, mesh, C, R):
    """``tests/test_wavefront_sp.py::test_sharded_align_device_walk_matches_host_walk``
    (the row-scan block engine): tile crossings in both axes, against the
    JAX pipeline's host walk on conftest's 8 devices."""
    rng = np.random.default_rng(C + R)
    q = rng.integers(0, 24, C).astype(np.int8)
    t = rng.integers(0, 24, R).astype(np.int8)
    dev, host = _both_walks(sp.sharded_global_align, 8, q, t, B62, 11.0, 2.0, tr=32,
                            tb_rows=64, device="cpu")
    want = _ref_host(monkeypatch, ref_sp.sharded_global_align, mesh, q, t, B62, 11.0, 2.0,
                     tr=32, tb_rows=64, engine="pallas")
    for got in (dev, host):
        assert got[0] == want[0] and got[3] == want[3]
        for x, y in zip(got[1:3], want[1:3]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_walk_passes_through_the_single_pair_entry_points(monkeypatch):
    """``align_global`` on each of its routes (one plane, checkpoint and
    replay, column blocks, the batched fill) and ``align_local`` with
    ``walk="host"`` equal the default walk; no walk kernel's plain version
    runs under the host walk."""
    rng = np.random.default_rng(6)
    q = rng.integers(0, 24, 90).astype(np.int8)
    t = rng.integers(0, 24, 110).astype(np.int8)
    plain_walks = []
    for mod, name in ((wf, "replay_walk_plain"),):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: plain_walks.append(1)
                            or _r(*a, **k))
    from aligner_tpu_torch.ops import device_walk

    real_walk = device_walk.walk_plain
    monkeypatch.setattr(device_walk, "walk_plain",
                        lambda *a, **k: plain_walks.append(2) or real_walk(*a, **k))
    want_g = oracle.align_global(q, t, B62, 11.0, 2.0)
    routes = [dict(), dict(backend="wavefront_sp"), dict(matrix=B62 * 0.5)]
    for budget in (None, 1000):
        if budget:
            monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", budget)
        for r in routes if budget is None else [dict()]:
            m = r.get("matrix", B62)
            kw = {k: v for k, v in r.items() if k != "matrix"}
            dev = port.align_global(q, t, m, 11.0, 2.0, device="cpu", **kw)
            plain_walks.clear()
            host = port.align_global(q, t, m, 11.0, 2.0, device="cpu", walk="host", **kw)
            assert plain_walks == []
            _assert_pairs_equal([host], [dev])
            if m is B62:
                assert np.array_equal(host.alignment.query, want_g.query_aligned)
    monkeypatch.undo()
    dev = port.align_local(q, t, B62, 11.0, 2.0, device="cpu")
    host = port.align_local(q, t, B62, 11.0, 2.0, device="cpu", walk="host")
    _assert_pairs_equal([host], [dev])


def test_aligner_device_walk_changes_nothing(monkeypatch):
    """The port reads no ``ALIGNER_DEVICE_WALK``: under ``0`` the default is
    still the device walk (the walk's own wrapper runs, the host walk does
    not), and the results are the same."""
    from aligner_tpu_torch.ops import device_walk

    rng = np.random.default_rng(7)
    qs, ts = _rand_batch(rng, 6, related=True)
    pwm = rng.normal(2.0, 3.0, (4, 10))
    q4 = [rng.integers(0, 4, 20).astype(np.int8) for _ in range(3)]
    base = port.batch_align(qs, ts, B62, 11.0, 2.0, device="cpu", with_alignments=True)
    base_pwm = port.batch_align_pwm(q4, pwm, 3.0, 1.0, device="cpu", with_alignments=True)
    seen = []
    real = device_walk.walk_batch
    monkeypatch.setattr(device_walk, "walk_batch", lambda *a, **k: seen.append(1)
                        or real(*a, **k))
    monkeypatch.setattr(port_align, "_walk_pairs_on_host",
                        lambda *a, **k: pytest.fail("the host walk ran"))
    monkeypatch.setattr(native, "traceback_batch",
                        lambda *a, **k: pytest.fail("the native walk ran"))
    for flag in ("0", "1"):
        monkeypatch.setenv("ALIGNER_DEVICE_WALK", flag)
        seen.clear()
        _assert_pairs_equal(port.batch_align(qs, ts, B62, 11.0, 2.0, device="cpu",
                                             with_alignments=True), base)
        _assert_pwm_equal(port.batch_align_pwm(q4, pwm, 3.0, 1.0, device="cpu",
                                               with_alignments=True), base_pwm)
        assert seen == [1, 1]
    with pytest.raises(port.ValidationError, match="walk"):
        port.batch_align(qs, ts, B62, 11.0, 2.0, device="cpu", with_alignments=True,
                         walk="native")
