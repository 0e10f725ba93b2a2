"""The port's automatic data sharding of every batched fill
(``aligner_tpu_torch.align._auto_shard_devices``) against the unsharded
port and the JAX package, the cases of ``tests/test_auto_shard.py``.

The port has no card here, so its shard list (``align._shard_devices``) is
patched to 8 CPU shards, as conftest gives the JAX package 8 virtual
devices, over which its own fills shard.  Each case runs a real entry point
of the port sharded, then unsharded under ``ALIGNER_AUTO_SHARD=0``, and the
JAX package's with ``backend="xla"``; results are held bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.align import batch_align as ref_batch_align
from aligner_tpu.align import batch_align_pwm as ref_batch_align_pwm
from aligner_tpu.repeat import engine as ref_engine
from aligner_tpu.statistics import calculate_p_value as ref_p_value
from aligner_tpu_torch import align as port_align
from aligner_tpu_torch.observability import counters
from aligner_tpu_torch.ops import dp_fill
from aligner_tpu_torch.repeat import engine as port_engine

torch.set_num_threads(1)

N_SHARDS = 8


@pytest.fixture
def sharded(monkeypatch):
    """The port's fills shard over 8 CPU shards; returns a function that
    turns sharding off (``ALIGNER_AUTO_SHARD=0``) for the rest of the test."""
    monkeypatch.setattr(port_align, "_shard_devices", lambda device: [device] * N_SHARDS)
    monkeypatch.delenv("ALIGNER_AUTO_SHARD", raising=False)
    counters.reset()
    return lambda: monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def _engines() -> set[str]:
    return set(counters.snapshot())


def _same_alignments(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is None:
            continue
        x, y = x.alignment, y.alignment
        assert x.f == y.f and tuple(map(tuple, x.coords)) == tuple(map(tuple, y.coords))
        np.testing.assert_array_equal(x.query, y.query)
        np.testing.assert_array_equal(x.target, y.target)


def test_devices_visible(sharded):
    import jax

    assert len(jax.devices()) == N_SHARDS  # the JAX package shards too
    cpu = torch.device("cpu")
    assert port_align._auto_shard_devices(cpu) == [cpu] * N_SHARDS
    sharded()
    assert port_align._auto_shard_devices(cpu) == [cpu]


def test_shard_devices_without_the_patch():
    """On its own the shard list is the visible cards for ``"cuda"`` and the
    device alone for a named card or the CPU."""
    cpu = torch.device("cpu")
    assert port_align._shard_devices(cpu) == [cpu]
    assert port_align._shard_devices(torch.device("cuda", 1)) == [torch.device("cuda", 1)]


def test_p_value_sharded_equals_single(sharded, rng):
    M = port.blosum62()
    q = rng.integers(0, 24, 60).astype(np.int8)
    t = rng.integers(0, 24, 64).astype(np.int8)
    f = port.align_local(q, t, M, 11.0, 2.0, device="cpu").alignment.f

    def p(fn, **kw):
        return fn(q, t, f, 11.0, 2.0, M, rng=np.random.default_rng(3), n_sequences=500,
                  **kw)

    p_sharded = p(port.calculate_p_value, device="cpu")
    assert "cpux8/local" in _engines()
    p_jax = p(ref_p_value, backend="xla")
    sharded()
    assert p_sharded == p(port.calculate_p_value, device="cpu") == p_jax


def _scan(engine, seq, pwm, opts):
    mean, std = engine.calculate_starting_values(seq, pwm, opts, np.random.default_rng(11))
    return mean, std, engine.calculate_cycle(seq, pwm, [], mean, std, opts)


def test_repeat_scan_sharded_equals_single(sharded, rng):
    """The window scan (starting values and one cycle, whose survivors take
    the sharded PWM batch with alignments): scores, statistics and surviving
    tasks equal."""
    seq = rng.integers(0, 4, 3000).astype(np.int8)
    pwm = rng.integers(-1, 2, (4, 48)).astype(np.float64)
    for at in (400, 1400, 2300):  # the PWM's consensus, so that windows survive
        seq[at:at + 48] = pwm.argmax(0)
    kw = dict(repeat_length=48, query_offset=16, deletions=6.0, extension=2.0)
    got = _scan(port_engine, seq, pwm, port_engine.SearchOptions(device="cpu", **kw))
    assert {"cpux8/pwm-scan", "cpux8/pwm"} <= _engines()
    want = _scan(ref_engine, seq, pwm, ref_engine.SearchOptions(backend="xla", **kw))
    sharded()
    single = _scan(port_engine, seq, pwm, port_engine.SearchOptions(device="cpu", **kw))
    for other in (single, want):
        assert got[:2] == other[:2]
        assert len(got[2]) == len(other[2]) > 0
        for a, b in zip(got[2], other[2]):
            assert (a.left_coord, a.right_coord, a.z, a.f) == (
                b.left_coord, b.right_coord, b.z, b.f)
            np.testing.assert_array_equal(a.alignment.frequency_matrix(),
                                          b.alignment.frequency_matrix())


def test_scan_scores_over_more_shards_than_windows(sharded, monkeypatch, rng):
    """``_scan_scores`` on 5 shards with chunks of 29 windows (the last
    chunk's shares partly empty) equals the one-device scan."""
    monkeypatch.setattr(port_align, "_shard_devices", lambda device: [device] * 5)
    seq = rng.integers(0, 4, 700).astype(np.int8)
    pwm = rng.integers(-2, 3, (4, 24)).astype(np.float64)
    opts = port_engine.SearchOptions(repeat_length=24, query_offset=8, deletions=5.0,
                                     extension=2.0, device="cpu")
    wins = port_engine.windows_of(len(seq), opts, opts.query_offset)
    assert len(wins) % 29 == 1  # the last chunk: one window, 4 empty shares
    many = port_engine._scan_scores(seq, wins, pwm, opts, chunk=29)
    assert _engines() == {"cpux5/pwm-scan"}
    sharded()
    np.testing.assert_array_equal(many, port_engine._scan_scores(seq, wins, pwm, opts,
                                                                 chunk=29))


def test_worker_population_sharded_equals_single(sharded, tmp_path, monkeypatch):
    """A worker's batch end to end: the subtasks it writes are equal sharded,
    unsharded and from the JAX worker."""
    from aligner_tpu.service import queue as ref_queue
    from aligner_tpu.service import store as ref_store
    from aligner_tpu.service import worker as ref_worker
    from aligner_tpu_torch.service.dispatcher import TOPIC_JOBS
    from aligner_tpu_torch.service.models import AlignJob
    from aligner_tpu_torch.service.queue import JobQueue
    from aligner_tpu_torch.service.store import Store
    from aligner_tpu_torch.service.worker import Worker

    monkeypatch.delenv("ALIGNER_POP_DEVICE_LOOP", raising=False)

    class Req:
        kd_value = 0.0
        r_squared_value = 100.0
        del_value = 7.0
        dim_value = 24
        matrices_volume_value = 3

    def run(db, store, queue, worker):
        r0, r1 = np.random.default_rng(0), np.random.default_rng(1)
        qs = "".join("ARNDCQEGHILKMFPSTWYV"[c] for c in r0.integers(0, 20, 40))
        ts = "".join("ARNDCQEGHILKMFPSTWYV"[c] for c in r0.integers(0, 20, 44))
        store.insert_align_task(Req, "h1", "q", qs, "t", ts)
        for _ in range(3):
            job = AlignJob(
                sequence_1=qs, sequence_2=ts,
                matrix=r1.integers(-1, 2, (24, 24)).astype(np.float64),
                frequences=np.full(24, 1.0 / 24), kd_value=0.0, r_squared_value=100.0,
                del_value=7.0, matrices_volume_value=3, hash="h1",
            )
            queue.produce(TOPIC_JOBS, job.to_json())
        assert worker(store, queue).process_batch() == 3
        with store._conn() as c:
            return c.execute(
                "select f_value, matrix_json from align_subtasks order by id").fetchall()

    def port_run(db):
        return run(db, Store(db), JobQueue(db),
                   lambda s, q: Worker(store=s, queue=q, name="w0", device="cpu"))

    rows_sharded = port_run(str(tmp_path / "a.db"))
    assert "cpux8/local" in _engines()
    rows_jax = run(str(tmp_path / "j.db"), ref_store.Store(str(tmp_path / "j.db")),
                   ref_queue.JobQueue(str(tmp_path / "j.db")),
                   lambda s, q: ref_worker.Worker(store=s, queue=q, name="w0",
                                                  backend="xla"))
    sharded()
    assert rows_sharded == port_run(str(tmp_path / "b.db")) == rows_jax


def _ragged_pairs(rng, B, lo=5, hi=20):
    qs = [rng.integers(0, 24, int(rng.integers(lo, hi))) for _ in range(B)]
    ts = [rng.integers(0, 24, int(rng.integers(lo, hi))) for _ in range(B)]
    return qs, ts


@pytest.mark.parametrize("mode", ["local", "global"])
def test_sharded_fill_matches_unsharded(rng, mode):
    """``_fill_sharded`` on 8 shards (B = 11, not a multiple: padding)
    against the one-device fill of the port and the JAX package's sharded
    Pallas fill (interpret mode): scores and direction words."""
    import jax.numpy as jnp

    from aligner_tpu.align import _fill_sharded as ref_fill_sharded
    from aligner_tpu.align import pad_batch

    qs, ts = _ragged_pairs(rng, 11)
    q, ql = pad_batch(qs)
    t, tl = pad_batch(ts)
    M = np.asarray(ref.blosum62())
    cpu = torch.device("cpu")
    got = port_align._fill_sharded(dp_fill.DPFill, M, [q, ql, t, tl], 11.0, 2.0,
                                   torch.float32, [cpu] * N_SHARDS, cpu, mode=mode,
                                   with_dirs=True)
    one = port_align._fill(q, ql, t, tl, M, 11.0, 2.0, mode, True, cpu, torch.float32)
    want = ref_fill_sharded(q, ql, t, tl, M, 11.0, 2.0, mode, True, "pallas", jnp.float32,
                            True, N_SHARDS)
    assert isinstance(got.words, tuple) and len(got.words) == 6  # ceil(11 / 8) = 2 a shard
    words = torch.cat(got.words)
    torch.testing.assert_close(words, one.words, rtol=0, atol=0)
    for f in ("fmax", "fy", "fx", "end"):
        torch.testing.assert_close(getattr(got, f), getattr(one, f), rtol=0, atol=0)
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(
        dp_fill.dirs_from_packed(words.numpy(), ql, tl, mode)[:, :want.dirs.shape[1]],
        want.dirs)


def test_sharded_pwm_fill_matches_unsharded(rng):
    import jax.numpy as jnp

    from aligner_tpu.align import _fill_pwm_sharded as ref_fill_pwm_sharded
    from aligner_tpu.align import pad_batch

    qs = [rng.integers(0, 4, int(rng.integers(8, 30))) for _ in range(10)]
    q, ql = pad_batch(qs)
    pwm = rng.integers(-1, 2, (4, 12)).astype(np.float64)
    cpu = torch.device("cpu")
    got = port_align._fill_sharded(dp_fill.PWMFill, pwm, [q, ql], 3.0, 1.0, torch.float32,
                                   [cpu] * N_SHARDS, cpu, with_dirs=True)
    one = port_align._fill_pwm(q, ql, pwm, 3.0, 1.0, True, cpu, torch.float32)
    want = ref_fill_pwm_sharded(q, ql, pwm, 3.0, 1.0, True, "pallas", jnp.float32,
                                N_SHARDS)
    words = torch.cat(got.words)
    torch.testing.assert_close(words, one.words, rtol=0, atol=0)
    np.testing.assert_array_equal(got.fmax.numpy(), np.asarray(want.fmax))
    np.testing.assert_array_equal(
        dp_fill.dirs_from_packed(words.numpy(), np.full(10, 12), ql, "local")[
            :, :want.dirs.shape[1]], want.dirs)


def _three_ways(sharded, fn_port, fn_ref, hold):
    got = fn_port()
    want = fn_ref()
    sharded()
    hold(got, fn_port())
    hold(got, want)


def _hold_scores(a, b):
    for f in ("fmax", "fy", "fx", "end"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


@pytest.mark.parametrize("with_alignments", [False, True], ids=["scores", "alignments"])
def test_batched_matrices_sharded(sharded, rng, with_alignments):
    """Per-problem matrices (the worker population's layout) split with
    the batch."""
    qs, ts = _ragged_pairs(rng, 6, 20, 26)
    mats = rng.integers(-3, 4, (6, 24, 24)).astype(np.float64)
    kw = dict(mode="local", with_alignments=with_alignments)
    _three_ways(
        sharded,
        lambda: port.batch_align(qs, ts, mats, 7.0, 3.0, device="cpu", **kw),
        lambda: ref_batch_align(qs, ts, mats, 7.0, 3.0, backend="xla", **kw),
        _same_alignments if with_alignments else _hold_scores)
    assert "cpux8/local" in _engines()


@pytest.mark.parametrize("mode", ["local", "global"])
def test_pair_batch_with_alignments_sharded(sharded, rng, mode):
    qs, ts = _ragged_pairs(rng, 13)
    M = port.blosum62()
    kw = dict(mode=mode, with_alignments=True)
    _three_ways(
        sharded,
        lambda: port.batch_align(qs, ts, M, 11.0, 2.0, device="cpu", **kw),
        lambda: ref_batch_align(qs, ts, M, 11.0, 2.0, backend="xla", **kw),
        _same_alignments)


def test_pwm_full_mode_sharded_equals_single(sharded, rng):
    """The survivor pass of the repeat search (PWM alignments) sharded."""
    qs = [rng.integers(0, 4, int(rng.integers(20, 50))) for _ in range(9)]
    pwm = rng.integers(-1, 2, (4, 24)).astype(np.float64)

    def hold(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.alignment.f == y.alignment.f
            assert x.alignment.coords == y.alignment.coords
            np.testing.assert_array_equal(x.alignment.frequency_matrix(),
                                          y.alignment.frequency_matrix())

    _three_ways(
        sharded,
        lambda: port.batch_align_pwm(qs, pwm, 6.0, 2.0, device="cpu", with_alignments=True),
        lambda: ref_batch_align_pwm(qs, pwm, 6.0, 2.0, backend="xla", with_alignments=True),
        hold)
    assert "cpux8/pwm" in _engines()


def test_pwm_batched_matrices_sharded(sharded, rng):
    """(B, 4, W) per-problem PWMs split with the batch, scores and full
    mode."""
    qs = [rng.integers(0, 4, 40) for _ in range(6)]
    pwms = rng.integers(-1, 2, (6, 4, 16)).astype(np.float64)

    def both(fn, **kw):
        return fn(qs, pwms, 5.0, 2.0, **kw), fn(qs, pwms, 5.0, 2.0, with_alignments=True,
                                                 **kw)

    def hold(a, b):
        _hold_scores(a[0], b[0])
        for x, y in zip(a[1], b[1]):
            assert x.alignment.f == y.alignment.f
            np.testing.assert_array_equal(x.alignment.query, y.alignment.query)

    _three_ways(sharded, lambda: both(port.batch_align_pwm, device="cpu"),
                lambda: both(ref_batch_align_pwm, backend="xla"), hold)


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "skip"])
def test_batch_smaller_than_the_shard_count(sharded, rng, skip):
    """Three problems on 8 shards: five shards hold padding alone, and with
    ``skip`` a shard's one problem is empty."""
    qs, ts = _ragged_pairs(rng, 3)
    M = port.blosum62()
    mask = np.array([False, True, False]) if skip else None
    kw = dict(mode="local", skip=mask)
    got = (port.batch_align(qs, ts, M, 11.0, 2.0, device="cpu", **kw),
           port.batch_align(qs, ts, M, 11.0, 2.0, device="cpu", with_alignments=True, **kw))
    assert "cpux8/local" in _engines()
    want = (ref_batch_align(qs, ts, M, 11.0, 2.0, backend="xla", **kw),
            ref_batch_align(qs, ts, M, 11.0, 2.0, backend="xla", with_alignments=True, **kw))
    sharded()
    for other in (want, (port.batch_align(qs, ts, M, 11.0, 2.0, device="cpu", **kw),
                         port.batch_align(qs, ts, M, 11.0, 2.0, device="cpu",
                                          with_alignments=True, **kw))):
        _hold_scores(got[0], other[0])
        _same_alignments(got[1], other[1])
    assert (got[1][1] is None) == skip


def test_unsharded_calls(sharded, rng):
    """A batch of one and a pair with its planes (``keep_planes``) fill on
    the one device, as in the reference."""
    q, t = (rng.integers(0, 24, 30).astype(np.int8) for _ in range(2))
    M = port.blosum62()
    port.batch_align([q], [t], M, 11.0, 2.0, device="cpu", with_alignments=True)
    port.align_local(q, t, M, 11.0, 2.0, device="cpu", keep_planes=True)
    port.batch_align_pwm([q % 4], np.ones((4, 8)), 3.0, 1.0, device="cpu")
    assert _engines() == {"cpu/local", "cpu/pwm"}


@pytest.mark.parametrize("pwm", [False, True], ids=["pair", "pwm"])
def test_host_walk_on_sharded_words(sharded, rng, pwm):
    """``walk="host"`` reads each shard's words and walks them on the host,
    equal to the device walk over the shards."""
    if pwm:
        qs = [rng.integers(0, 4, int(rng.integers(20, 50))) for _ in range(11)]
        mat = rng.integers(-1, 2, (4, 24)).astype(np.float64)

        def run(walk):
            return port.batch_align_pwm(qs, mat, 6.0, 2.0, device="cpu",
                                        with_alignments=True, walk=walk, pad_to=12)
    else:
        qs, ts = _ragged_pairs(rng, 11)

        def run(walk):
            return port.batch_align(qs, ts, port.blosum62(), 11.0, 2.0, device="cpu",
                                    with_alignments=True, walk=walk, pad_to=12)

    host = run("host")
    assert any("cpux8/" in e for e in _engines())
    device = run("device")
    assert len(host) == len(device) == 11
    for x, y in zip(host, device):
        assert x.alignment.f == y.alignment.f
        assert tuple(map(tuple, x.alignment.coords)) == tuple(map(tuple, y.alignment.coords))
        np.testing.assert_array_equal(x.alignment.query, y.alignment.query)
