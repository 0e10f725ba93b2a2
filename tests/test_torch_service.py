"""The port's alignment service (``aligner_tpu_torch.service`` and
``aligner-torch-calc``) on the CPU (``device="cpu"``: the kernels' plain
versions).

Every test of tests/test_service.py is mirrored here against the port's
modules.  Beside them: the same requests through the JAX service and the
port's, each on its own sqlite file, leave equal tables bit for bit
(subtasks, promoted results, p-values); a file the JAX package wrote is
served by the port and stays readable by the JAX package; a worker or a
backfill with no card (or a broken kernel build) raises having claimed,
dropped and stored nothing; and a job that keeps failing is redelivered
until ``MAX_ATTEMPTS`` claims, then committed away.
"""

import contextlib
import json
import os
import sqlite3
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import aligner_tpu.cli.calc as ref_calc
import aligner_tpu.service.dispatcher as ref_dispatcher
import aligner_tpu.service.queue as ref_queue
import aligner_tpu.service.store as ref_store
import aligner_tpu.service.updater as ref_updater
import aligner_tpu.service.worker as ref_worker
import aligner_tpu_torch.service.worker as worker_mod
from aligner_tpu_torch.cli import calc as port_calc
from aligner_tpu_torch.errors import DeviceUnavailable
from aligner_tpu_torch.ops import _build
from aligner_tpu_torch.service import queue as queue_mod
from aligner_tpu_torch.service.dispatcher import (
    Dispatcher,
    GROUP,
    TOPIC_JOBS,
    generate_pairs,
    serve,
    symbol_frequencies,
)
from aligner_tpu_torch.service.models import AlignJob
from aligner_tpu_torch.service.queue import MAX_ATTEMPTS, JobQueue
from aligner_tpu_torch.service.store import Store, get_population
from aligner_tpu_torch.service.updater import run_once as updater_run
from aligner_tpu_torch.service.worker import Worker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FASTA = """>seq1
HEAGAWGHEE
>seq2
PAWHEAE
>seq3
HEAGAWGHEA
"""

REQ = {
    "sequences": FASTA,
    "kdValue": 0.0,
    "rSquaredValue": 100.0,
    "delValue": 5.0,
    "dimValue": 24,
    "matricesVolumeValue": 3,
}


def homologous_request():
    """A seeded pair of 60 residues (the target the query with a quarter
    of its positions substituted) at the service's settings, 4 matrices."""
    rng = np.random.default_rng(60)
    aa = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    q = rng.integers(0, 20, 60)
    t = q.copy()
    mask = rng.random(60) < 0.25
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    return {
        "sequences": f">q\n{''.join(aa[q])}\n>t\n{''.join(aa[t])}\n",
        "kdValue": 0.0,
        "rSquaredValue": 1e5,
        "delValue": 11.0,
        "dimValue": 24,
        "matricesVolumeValue": 4,
    }


@pytest.fixture
def svc(tmp_path):
    db = str(tmp_path / "svc.db")
    store = Store(db)
    queue = JobQueue(db)
    return Dispatcher(store, queue, rng=np.random.default_rng(0)), store, queue


def rows(db, sql, args=()):
    with contextlib.closing(sqlite3.connect(db)) as c:
        return c.execute(sql, args).fetchall()


def drain(worker, queue):
    while queue.pending(TOPIC_JOBS) > 0:
        worker.process_batch()


# --------------------------------------------------------------------------
# the mirror of tests/test_service.py
# --------------------------------------------------------------------------


def test_validate_creates_tasks_and_jobs(svc):
    disp, store, queue = svc
    code, resp = disp.validate(REQ)
    assert code == 200
    assert len(resp["hashes"]) == 3  # all pairs of 3 sequences
    assert queue.pending(TOPIC_JOBS) == 9  # 3 pairs x 3 matrices
    # duplicate submission → no new tasks
    code, resp = disp.validate(REQ)
    assert code == 500


def test_validate_errors(svc):
    disp, _, _ = svc
    code, resp = disp.validate({**REQ, "sequences": ">only_one\nAAAA\n"})
    assert code == 400
    code, resp = disp.validate({"bogus": 1})
    assert code == 400
    for bad in ({**REQ, "dimValue": -3}, {**REQ, "dimValue": 0},
                {**REQ, "matricesVolumeValue": 0}):
        code, resp = disp.validate(bad)
        assert code == 400, bad


def test_worker_processes_and_promotes(svc):
    disp, store, queue = svc
    code, resp = disp.validate(REQ)
    hashes = resp["hashes"]
    w = Worker(store, queue, batch=16, device="cpu")
    while queue.pending(TOPIC_JOBS) > 0:
        assert w.process_batch() > 0 or queue.pending(TOPIC_JOBS) == 0
    for h in hashes:
        assert store.get_percentage_by_hash(h) == 100.0
    snap = disp.progress_snapshot(hashes)
    assert all(v == 100.0 for v in snap["progress"].values())
    assert updater_run(store) == 0  # everything already promoted inline
    for h in hashes:
        tid = store.get_task_id_by_hash(h)
        row = store.get_result_matrix_by_task_id(tid)
        assert row is not None
        assert row[2] >= 0.0


def test_calc_backfills_p_values(svc):
    disp, store, queue = svc
    disp.validate(REQ)
    drain(Worker(store, queue, batch=32, device="cpu"), queue)
    updater_run(store)
    n = port_calc.run_once(store, rng=np.random.default_rng(0), device="cpu",
                           n_sequences=60)
    assert n == 3
    # a degenerate fit can produce a NaN p-value (the reference's math does
    # too); sqlite stores NaN as NULL so such tasks stay unfilled
    assert len(store.get_ids_with_null_p_value()) <= 1


def test_queue_lease_redelivery(tmp_path):
    q = JobQueue(str(tmp_path / "q.db"))
    q.produce(TOPIC_JOBS, "payload1")
    a = q.claim_batch(TOPIC_JOBS, "c1", lease=0.0)  # expires immediately
    assert [(p, n) for _, p, n in a] == [("payload1", 1)]
    b = q.claim_batch(TOPIC_JOBS, "c2")
    assert [(p, n) for _, p, n in b] == [("payload1", 2)]  # redelivered
    q.commit([b[0][0]])
    assert q.pending(TOPIC_JOBS) == 0


def _health_node(health: dict, name: str) -> dict:
    nodes = [n for n in health["nodes"] if n["consumerName"] == name]
    assert len(nodes) == 1, health
    return nodes[0]


def test_health_members(svc):
    disp, store, queue = svc
    queue.register_consumer(GROUP, "node-a")
    node = _health_node(disp.health_check(), "node-a")
    assert node["status"] is True
    assert node["lastSeenAgeSec"] >= 0.0
    assert node["claimedJobs"] == 0


def test_health_reports_stale_and_load(svc, monkeypatch):
    disp, store, queue = svc
    queue.register_consumer(GROUP, "node-live")
    queue.produce(TOPIC_JOBS, "p1")
    queue.claim_batch(TOPIC_JOBS, "node-live", GROUP)
    node = _health_node(disp.health_check(), "node-live")
    assert node["status"] is True and node["claimedJobs"] == 1
    real_time = time.time
    monkeypatch.setattr(
        queue_mod.time, "time",
        lambda: real_time() + queue_mod.HEALTH_WINDOW + 5.0,
    )
    node = _health_node(disp.health_check(), "node-live")
    assert node["status"] is False
    assert node["lastSeenAgeSec"] > queue_mod.HEALTH_WINDOW


def test_claim_batch_race_no_overlap(tmp_path):
    """Two threads hammering claim_batch never claim the same job."""
    db = str(tmp_path / "race.db")
    q = JobQueue(db)
    n_jobs = 40
    for i in range(n_jobs):
        q.produce(TOPIC_JOBS, f"job-{i}")

    claims: dict[str, list[int]] = {"c1": [], "c2": []}
    errors: list[Exception] = []
    barrier = threading.Barrier(2)

    def run(consumer: str):
        local_q = JobQueue(db)  # own connection per worker, as in prod
        barrier.wait()
        try:
            while True:
                got = local_q.claim_batch(TOPIC_JOBS, consumer, GROUP, limit=4)
                if not got:
                    break
                claims[consumer].extend(j for j, _, _ in got)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,)) for c in claims]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    ids1, ids2 = set(claims["c1"]), set(claims["c2"])
    assert ids1 & ids2 == set(), f"double-claimed jobs: {ids1 & ids2}"
    assert len(ids1 | ids2) == n_jobs


def test_redelivery_duplicate_still_promotes(svc):
    disp, store, queue = svc
    code, resp = disp.validate(REQ)
    h = resp["hashes"][0]
    mat = np.zeros((24, 24))
    volume = REQ["matricesVolumeValue"]
    for i in range(volume):
        store.insert_align_subtask(h, float(i), mat, "Q", "T", source_key=str(i))
    for i in range(volume):
        store.insert_align_subtask(h, float(i), mat, "Q", "T", source_key=str(i))
    assert store.get_percentage_by_hash(h) == 100.0
    store.insert_align_subtask(h, -1.0, mat, "Q", "T")
    snap = disp.progress_snapshot([h])
    assert snap["progress"][h] == 100.0  # display is capped
    tid = store.get_task_id_by_hash(h)
    row = store.get_result_matrix_by_task_id(tid)
    assert row is not None and row[2] == float(volume - 1)  # max f promoted


def test_promote_exactly_once_concurrent(svc):
    disp, store, queue = svc
    code, resp = disp.validate(REQ)
    h = resp["hashes"][0]
    mat = np.zeros((24, 24))
    for i in range(REQ["matricesVolumeValue"]):
        store.insert_align_subtask(h, float(i), mat, "Q", "T", source_key=str(i))
    results = []
    barrier = threading.Barrier(4)

    def promote():
        local = Store(store.path)
        barrier.wait()
        results.append(local.promote_if_complete(h))

    threads = [threading.Thread(target=promote) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sum(results) == 1
    n = rows(store.path, """select count(1) from result_matrices rm
                            inner join align_tasks at2 on rm.task_id = at2.id
                            where at2.hash = ?""", (h,))[0][0]
    assert n == 1


def test_population_threshold(tmp_path, rng):
    from aligner_tpu_torch.matrices import get_threshold

    store = Store(str(tmp_path / "p.db"))
    mats = get_population(store, 24, 5, rng)
    assert len(mats) == 5
    thr = get_threshold(24)
    for i in range(5):
        for j in range(i + 1, 5):
            assert np.linalg.norm(mats[i] - mats[j]) >= thr
    again = get_population(store, 24, 5, rng)
    assert all(np.array_equal(a, b) for a, b in zip(mats, again))


def test_job_roundtrip_serialization(rng):
    job = AlignJob(
        sequence_1="HEAG", sequence_2="PAWH",
        matrix=rng.random((4, 4)), frequences=rng.random(4),
        kd_value=1.0, r_squared_value=2.0, del_value=3.0,
        matrices_volume_value=4, hash="abc",
    )
    back = AlignJob.from_json(job.to_json())
    assert np.array_equal(back.matrix, job.matrix)
    assert np.array_equal(back.frequences, job.frequences)
    assert back.hash == "abc"


def test_http_server_end_to_end(svc):
    """The HTTP API answers byte for byte as the JAX dispatcher's does."""
    disp, store, queue = svc
    server = serve("127.0.0.1", 0, disp, sse_ticks=1)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health/check") as r:
            assert json.loads(r.read())["nodes"] == []
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/validate",
            data=json.dumps(REQ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as r:
            hashes = json.loads(r.read())["hashes"]
        assert len(hashes) == 3
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/progress?hashes={','.join(hashes)}"
        ) as r:
            line = r.readline().decode()
            assert line.startswith("data: ")
            snap = json.loads(line[6:])
            assert set(snap["progress"].keys()) == set(hashes)
            assert snap["message"] == ref_dispatcher.MSG_PROGRESS
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/validate",
            data=json.dumps({**REQ, "sequences": ">a\nAAAA\n"}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400
        assert e.value.read() == json.dumps(
            {"message": ref_dispatcher.MSG_TOO_FEW}).encode()
    finally:
        server.shutdown()


def test_symbol_frequencies_deterministic():
    f = symbol_frequencies("AARA", "RN", 24)
    assert f[0] == 3 / 6  # A
    assert f[1] == 2 / 6  # R
    assert f[2] == 1 / 6  # N
    assert f.sum() == pytest.approx(1.0)
    assert np.array_equal(f, ref_dispatcher.symbol_frequencies("AARA", "RN", 24))
    assert generate_pairs([1, 2, 3]) == ref_dispatcher.generate_pairs([1, 2, 3])


def test_blast_cmp(tmp_path, rng):
    from aligner_tpu_torch.service.blast_cmp import load_blast_results, run_cmp

    db = str(tmp_path / "b.db")
    store = Store(db)
    queue = JobQueue(db)
    disp = Dispatcher(store, queue, rng=rng)
    disp.validate(REQ)  # gives align_tasks rows to resolve identifiers from
    csvp = tmp_path / "blast.csv"
    csvp.write_text("seq1,seq2,0|005\n".replace("|", ","))
    assert load_blast_results(store, str(csvp)) == 1
    n = run_cmp(store, rng=np.random.default_rng(0), device="cpu", n_sequences=60)
    assert n == 1
    table = store.get_cmp_table()
    assert table[0][4] is not None and 0.0 <= table[0][4] <= 1.0


def _poison_payload(disp, store, queue):
    queue.produce(TOPIC_JOBS, "{not json", GROUP)
    disp.validate(REQ)


def _undoable_task(disp, store, queue):
    # dim != 24 makes the heuristic's frequency shapes clash
    code, _ = disp.validate(dict(REQ, dimValue=20, rSquaredValue=40.0))
    assert code == 200


def _malformed_matrix(disp, store, queue):
    disp.validate(REQ)
    with queue._conn() as c:
        row = c.execute("select id, payload from jobs limit 1").fetchone()
    payload = json.loads(row[1])
    payload["matrix"] = None  # models.py allows Option<matrix>
    with queue._conn() as c:
        c.execute("update jobs set payload = ? where id = ?",
                  (json.dumps(payload), row[0]))


@pytest.mark.parametrize("make", [_poison_payload, _undoable_task, _malformed_matrix],
                         ids=["poison-payload", "undoable-task", "malformed-matrix"])
def test_worker_drops_jobs_that_cannot_succeed(svc, make):
    """Mirrors test_worker_drops_poison_messages,
    test_worker_drops_undoable_task_instead_of_crash_looping and
    test_worker_drops_job_with_malformed_matrix: a job whose own data can
    never succeed is committed away on its first claim, not redelivered."""
    disp, store, queue = svc
    make(disp, store, queue)
    w = Worker(store, queue, batch=64, device="cpu")
    w.process_batch()
    assert queue.pending(TOPIC_JOBS) == 0


def test_two_workers_compete(svc):
    disp, store, queue = svc
    code, resp = disp.validate(REQ)
    w1 = Worker(store, queue, name="w1", batch=4, device="cpu")
    w2 = Worker(store, queue, name="w2", batch=4, device="cpu")
    while queue.pending(TOPIC_JOBS) > 0:
        w1.process_batch()
        w2.process_batch()
    for h in resp["hashes"]:
        assert store.get_percentage_by_hash(h) == 100.0
    assert _health_node(disp.health_check(), "w1")["status"] is True


def test_post_promotion_redelivery_is_noop(svc):
    disp, store, queue = svc
    code, resp = disp.validate(REQ)
    h = resp["hashes"][0]
    mat = np.zeros((24, 24))
    volume = REQ["matricesVolumeValue"]
    for i in range(volume):
        store.insert_align_subtask(h, float(i), mat, "Q", "T", source_key=str(i))
    assert store.promote_if_complete(h)
    store.insert_align_subtask(h, 0.0, mat, "Q", "T", source_key="0")
    assert store.get_percentage_by_hash(h) == 0.0  # no orphan rows
    tid = store.get_task_id_by_hash(h)
    assert store.get_result_matrix_by_task_id(tid) is not None
    snap = disp.progress_snapshot([h])
    assert snap["progress"][h] == 100.0  # DONE task reports complete


def test_worker_deregisters_on_clean_shutdown(svc):
    disp, store, queue = svc
    w = Worker(store, queue, name="short-lived", batch=4, device="cpu")
    lingering = queue.register_consumer(GROUP, "crashed-one")
    w.run_forever(poll_interval=0.0, max_batches=1)
    names = [m["name"] for m in queue.group_member_stats(GROUP)]
    assert "short-lived" not in names
    assert lingering in names


def short_lease(monkeypatch, seconds):
    """Every claim takes a lease of ``seconds``, whatever the caller asks."""
    orig = JobQueue.claim_batch
    monkeypatch.setattr(JobQueue, "claim_batch",
                        lambda self, topic, consumer, group=GROUP, limit=64, lease=None:
                        orig(self, topic, consumer, group, limit, lease=seconds))


def test_worker_leaves_jobs_for_redelivery_on_transient_failure(svc, monkeypatch):
    disp, store, queue = svc
    code, resp = disp.validate(REQ)
    real = worker_mod.heuristic_align_population
    boom = {"n": 0}

    def flaky(*a, **kw):
        boom["n"] += 1
        if boom["n"] <= 3:  # first pass: every task group fails
            # not a RuntimeError: that is the worker's own fault (a CUDA
            # error), which stops it (test_worker_that_keeps_failing_...)
            raise OSError("simulated flaky host")
        return real(*a, **kw)

    monkeypatch.setattr(worker_mod, "heuristic_align_population", flaky)
    short_lease(monkeypatch, 0.05)
    w = Worker(store, queue, batch=64, device="cpu")
    w.process_batch()  # all groups hit the transient failure
    done = rows(store.path, "select count(1) from jobs where status = 'done'")[0][0]
    assert done == 0
    time.sleep(0.1)  # past the short lease → redeliverable
    drain(w, queue)
    for h in resp["hashes"]:
        assert store.get_percentage_by_hash(h) == 100.0


def test_calc_backfill_survives_nonstrict_characters(svc):
    disp, store, queue = svc
    code, resp = disp.validate(dict(REQ, sequences=">a\nHEAGAWGHEEU\n>b\nPAWHEAEU\n"))
    h = resp["hashes"][0]
    mat = np.zeros((24, 24))
    for i in range(REQ["matricesVolumeValue"]):
        store.insert_align_subtask(h, float(i + 1), mat, "Q", "T", source_key=str(i))
    assert store.promote_if_complete(h)
    n = port_calc.run_once(store, rng=np.random.default_rng(0), device="cpu",
                           n_sequences=12)
    assert n == 1
    assert store.get_ids_with_null_p_value() == []


def test_sequence_identifier_resolves_target_only_records(svc):
    disp, store, queue = svc
    disp.validate(dict(REQ, sequences=">first\nHEAGAWGHEE\n>last desc\nPAWHEAE\n"))
    assert store.get_sequence_by_identifier("last") == "PAWHEAE"
    assert store.get_sequence_by_identifier("first") == "HEAGAWGHEE"


def test_service_load_three_consecutive(tmp_path):
    """Dispatcher + two competing workers drain 3 pairs x 8 matrices to
    promotion, three consecutive rounds on fresh state."""
    for round_i in range(3):
        db = str(tmp_path / f"load{round_i}.db")
        store, queue = Store(db), JobQueue(db)
        disp = Dispatcher(store, queue, rng=np.random.default_rng(round_i))
        code, resp = disp.validate(dict(REQ, matricesVolumeValue=8))
        assert code == 200
        hashes = resp["hashes"]
        assert queue.pending(TOPIC_JOBS) == 8 * len(hashes)
        ws = [Worker(store, queue, name=f"load-w{i}", batch=8, device="cpu")
              for i in range(2)]
        ts = [threading.Thread(target=drain, args=(w, queue)) for w in ws]
        [t.start() for t in ts]
        [t.join(timeout=300) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert queue.pending(TOPIC_JOBS) == 0
        snap = disp.progress_snapshot(hashes)  # promotes at >=100%
        for h in hashes:
            assert snap["progress"][h] == 100.0
            assert store.get_status_by_hash(h) == "DONE"
            tid = store.get_task_id_by_hash(h)
            assert store.get_result_matrix_by_task_id(tid) is not None
            assert store.get_percentage_by_hash(h) == 0.0


def test_heartbeat_extends_leases(tmp_path):
    q = JobQueue(str(tmp_path / "q.db"))
    q.produce(TOPIC_JOBS, "p1")
    a = q.claim_batch(TOPIC_JOBS, "c1", lease=0.05)
    assert len(a) == 1
    q.heartbeat("c1", GROUP, lease=60.0, job_ids=[a[0][0]])
    time.sleep(0.1)  # past the ORIGINAL lease
    assert q.claim_batch(TOPIC_JOBS, "c2") == []  # still owned by c1
    q.produce(TOPIC_JOBS, "p2")
    b = q.claim_batch(TOPIC_JOBS, "c3", lease=0.02)
    assert len(b) == 1
    time.sleep(0.05)
    assert len(q.claim_batch(TOPIC_JOBS, "c4")) == 1  # redelivered


def test_heartbeat_without_ids_does_not_extend(tmp_path):
    q = JobQueue(str(tmp_path / "q.db"))
    q.produce(TOPIC_JOBS, "p1")
    a = q.claim_batch(TOPIC_JOBS, "c1", lease=0.05)
    assert len(a) == 1
    q.heartbeat("c1", GROUP, lease=60.0)  # registry only
    time.sleep(0.1)
    assert len(q.claim_batch(TOPIC_JOBS, "c2")) == 1  # redelivered


def test_heartbeat_cannot_steal_back_reclaimed_job(tmp_path):
    q = JobQueue(str(tmp_path / "q.db"))
    q.produce(TOPIC_JOBS, "p1")
    a = q.claim_batch(TOPIC_JOBS, "c1", lease=0.02)
    assert len(a) == 1
    time.sleep(0.05)
    b = q.claim_batch(TOPIC_JOBS, "c2", lease=30.0)  # reclaim after expiry
    assert len(b) == 1
    q.heartbeat("c1", GROUP, lease=60.0, job_ids=[b[0][0]])
    with q._conn() as c:
        owner, until = c.execute(
            "select consumer, lease_until from jobs where id = ?", (b[0][0],)
        ).fetchone()
    assert owner == "c2"
    assert until <= time.time() + 31.0  # c1's 60s extension did not apply


def test_slow_worker_keeps_batch_while_heartbeating(svc, monkeypatch):
    """A population longer than the job lease does NOT have its batch
    redelivered: _LeaseKeeper's heartbeats extend the leases."""
    disp, store, queue = svc
    disp.validate(REQ)
    slow_called = {}
    real = worker_mod.heuristic_align_population

    def slow_population(*args, **kw):
        time.sleep(0.6)  # several heartbeat intervals past the lease below
        slow_called["yes"] = True
        return real(*args, **kw)

    monkeypatch.setattr(worker_mod, "heuristic_align_population", slow_population)
    short_lease(monkeypatch, 0.2)
    real_init = worker_mod._LeaseKeeper.__init__
    monkeypatch.setattr(worker_mod._LeaseKeeper, "__init__",
                        lambda self, q, n, g, job_ids=None, interval=0.05:
                        real_init(self, q, n, g, job_ids, 0.05))
    w = Worker(store, queue, name="slowpoke", batch=64, device="cpu")
    assert w.process_batch() == 9
    assert slow_called.get("yes")
    assert queue.pending(TOPIC_JOBS) == 0
    others = rows(store.path,
                  "select count(1) from jobs where consumer != 'slowpoke'")[0][0]
    assert others == 0
    assert {a for (a,) in rows(store.path, "select attempts from jobs")} == {1}


def test_worker_warmup_claims_nothing(svc):
    disp, store, queue = svc
    disp.validate(REQ)
    before = queue.pending(TOPIC_JOBS)
    w = Worker(store, queue, name="warm", batch=64, device="cpu")
    assert w.warmup() == 3  # one per pair-task
    assert queue.pending(TOPIC_JOBS) == before
    claimed = rows(store.path, "select count(1) from jobs where status != 'ready'")[0][0]
    assert claimed == 0
    assert w.process_batch() == before
    assert queue.pending(TOPIC_JOBS) == 0


def test_worker_ignores_the_device_loop_switch(tmp_path, monkeypatch):
    """Mirror of test_worker_fused_population_end_to_end: the port has no
    fused population loop, and ALIGNER_POP_DEVICE_LOOP=1 (which picks the
    JAX worker's) changes nothing: the same lifecycle, the same rows."""
    got = []
    for switch in ("1", None):
        if switch is None:
            monkeypatch.delenv("ALIGNER_POP_DEVICE_LOOP", raising=False)
        else:
            monkeypatch.setenv("ALIGNER_POP_DEVICE_LOOP", switch)
        db = str(tmp_path / f"loop{switch}.db")
        store, queue = Store(db), JobQueue(db)
        disp = Dispatcher(store, queue, rng=np.random.default_rng(0))
        code, resp = disp.validate(REQ)
        w = Worker(store, queue, name="loop", batch=64, device="cpu")
        w.warmup()
        assert w.process_batch() == 9
        assert queue.pending(TOPIC_JOBS) == 0
        got.append(subtask_rows(db))
        assert updater_run(store) == 3
    assert got[0] == got[1]


# --------------------------------------------------------------------------
# the JAX service and the port's: equal tables
# --------------------------------------------------------------------------


def subtask_rows(db):
    """Every subtask by task hash and origin job: f as float64 bytes, the
    matrix's JSON text, the result strings."""
    return [(h, k, np.float64(f).tobytes(), m, q, t) for h, k, f, m, q, t in rows(
        db, """select t.hash, s.source_key, s.f_value, s.matrix_json,
                      s.result_query_sequence, s.result_target_sequence
               from align_subtasks s join align_tasks t on t.id = s.task_id
               order by t.hash, cast(s.source_key as integer)""")]


def result_rows(db):
    return [(h, np.float64(f).tobytes(), m, q, t) for h, f, m, q, t in rows(
        db, """select t.hash, r.f_value, r.matrix_json, r.result_query_sequence,
                      r.result_target_sequence
               from result_matrices r join align_tasks t on t.id = r.task_id
               order by t.hash""")]


def p_value_rows(db):
    """p-values as float64 bytes (None where the fit gave NaN: sqlite stores
    NaN as NULL)."""
    return [(h, None if p is None else np.float64(p).tobytes())
            for h, p in rows(db, "select hash, p_value from align_tasks order by hash")]


def jax_service(db):
    store, queue = ref_store.Store(db), ref_queue.JobQueue(db)
    return ref_dispatcher.Dispatcher(store, queue, rng=np.random.default_rng(0)), store, queue


def port_service(db):
    store, queue = Store(db), JobQueue(db)
    return Dispatcher(store, queue, rng=np.random.default_rng(0)), store, queue


@pytest.mark.parametrize("req", [REQ, homologous_request()], ids=["REQ", "pair-60"])
def test_same_request_through_both_services(tmp_path, monkeypatch, req):
    """One request through the JAX service (its worker on the CPU, which
    runs the population's host loop) and through the port's, each on its
    own file with the same dispatcher seed: the subtasks, the promoted
    results and calc's p-values (--seed 0 --sequences 64) are equal bit
    for bit."""
    monkeypatch.delenv("ALIGNER_POP_DEVICE_LOOP", raising=False)
    a, b = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    disp_a, store_a, queue_a = jax_service(a)
    disp_b, store_b, queue_b = port_service(b)
    code_a, resp_a = disp_a.validate(req)
    code_b, resp_b = disp_b.validate(req)
    assert (code_a, resp_a) == (code_b, resp_b) and code_b == 200
    drain(ref_worker.Worker(store_a, queue_a, batch=64, backend="xla"), queue_a)
    drain(Worker(store_b, queue_b, batch=64, device="cpu"), queue_b)
    want = subtask_rows(a)
    assert len(want) == req["matricesVolumeValue"] * len(resp_a["hashes"])
    assert subtask_rows(b) == want
    assert ref_updater.run_once(store_a) == updater_run(store_b) == len(resp_a["hashes"])
    assert result_rows(b) == result_rows(a)
    assert ref_calc.main(["--db", a, "--seed", "0", "--sequences", "64",
                          "--backend", "xla"]) == 0
    assert port_calc.main(["--db", b, "--seed", "0", "--sequences", "64",
                           "--device", "cpu"]) == 0
    assert p_value_rows(b) == p_value_rows(a)


def test_jax_made_file_served_by_the_port(tmp_path, monkeypatch):
    """The JAX dispatcher fills a file; a port worker serves it (the jobs
    table gains ``attempts`` in place) and writes the rows the JAX worker
    writes into a copy of the same file; the JAX package then opens the
    migrated file, drains nothing more and promotes every task."""
    monkeypatch.delenv("ALIGNER_POP_DEVICE_LOOP", raising=False)
    a, b = str(tmp_path / "served-by-port.db"), str(tmp_path / "served-by-jax.db")
    disp, _, _ = jax_service(a)
    assert disp.validate(REQ)[0] == 200
    with contextlib.closing(sqlite3.connect(a)) as src, \
            contextlib.closing(sqlite3.connect(b)) as dst:
        src.backup(dst)
    assert "attempts" not in {r[1] for r in rows(a, "pragma table_info(jobs)")}
    store, queue = Store(a), JobQueue(a)
    assert {a_ for (a_,) in rows(a, "select attempts from jobs")} == {0}
    drain(Worker(store, queue, batch=64, device="cpu"), queue)
    store_b, queue_b = ref_store.Store(b), ref_queue.JobQueue(b)
    drain(ref_worker.Worker(store_b, queue_b, batch=64, backend="xla"), queue_b)
    assert subtask_rows(a) == subtask_rows(b) and len(subtask_rows(a)) == 9
    assert {a_ for (a_,) in rows(a, "select attempts from jobs")} == {1}
    # the JAX package on the migrated file
    jstore, jqueue = ref_store.Store(a), ref_queue.JobQueue(a)
    assert jqueue.pending(ref_dispatcher.TOPIC_JOBS) == 0
    jqueue.produce(ref_dispatcher.TOPIC_JOBS, "p")
    assert [p for _, p in jqueue.claim_batch(ref_dispatcher.TOPIC_JOBS, "c")] == ["p"]
    assert ref_updater.run_once(jstore) == ref_updater.run_once(store_b) == 3
    assert result_rows(a) == result_rows(b)


def test_migration_is_safe_to_race(tmp_path):
    """Port queues opening one JAX-made file at once: the column is added
    once and no starter fails."""
    db = str(tmp_path / "race.db")
    ref_queue.JobQueue(db).produce(TOPIC_JOBS, "p")
    errors = []
    barrier = threading.Barrier(4)

    def open_queue():
        barrier.wait()
        try:
            JobQueue(db)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=open_queue) for _ in range(4)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts) and not errors
    cols = [r[1] for r in rows(db, "pragma table_info(jobs)")]
    assert cols.count("attempts") == 1


# --------------------------------------------------------------------------
# no card, a broken build: nothing claimed, dropped or stored
# --------------------------------------------------------------------------


def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return DeviceUnavailable


def broken_build(monkeypatch):
    def fail():
        raise _build.KernelBuildFailure("nvcc failed")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "load", fail)
    return _build.KernelBuildFailure


def claimed_or_done(db):
    return rows(db, "select count(1) from jobs where status != 'ready'")[0][0]


@pytest.mark.parametrize("fault", [no_card, broken_build], ids=["no-card", "broken-build"])
def test_worker_that_cannot_compute_registers_and_claims_nothing(svc, monkeypatch, fault):
    disp, store, queue = svc
    disp.validate(REQ)
    before = queue.pending(TOPIC_JOBS)
    error = fault(monkeypatch)
    with pytest.raises(error):
        Worker(store, queue, name="cardless")  # device=None: the card
    assert queue.group_member_stats(GROUP) == []
    assert queue.pending(TOPIC_JOBS) == before
    assert claimed_or_done(store.path) == 0


def promoted_task(svc):
    disp, store, queue = svc
    code, resp = disp.validate(dict(REQ, sequences=">a\nHEAGAWGHEE\n>b\nPAWHEAEWG\n"))
    h = resp["hashes"][0]
    for i in range(REQ["matricesVolumeValue"]):
        store.insert_align_subtask(h, float(i + 1), np.zeros((24, 24)), "Q", "T",
                                   source_key=str(i))
    assert store.promote_if_complete(h)
    return store


def cli_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    env.pop("ALIGNER_QUEUE", None)
    return env


@pytest.mark.parametrize("cli", ["calc", "worker"])
def test_cli_without_a_card_exits_nonzero_having_done_nothing(svc, tmp_path, cli):
    """``aligner-torch-calc`` (a promoted task pending) and
    ``aligner-torch-node`` (jobs pending), run without ``--device cpu`` on
    a machine with no card: the process exits nonzero, no p-value is
    stored, no job claimed and no consumer registered."""
    store = promoted_task(svc)
    disp, _, queue = svc
    disp.validate(REQ)
    before = queue.pending(TOPIC_JOBS)
    argv = {"calc": ["aligner_tpu_torch.cli.calc", "--db", store.path, "--seed", "0",
                     "--sequences", "12"],
            "worker": ["aligner_tpu_torch.service.worker", "--max-batches", "2",
                       "--poll-interval", "0"]}[cli]
    out = subprocess.run([sys.executable, "-m", *argv], cwd=str(tmp_path),
                         env=dict(cli_env(), ALIGNER_DB=store.path), timeout=240,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert "DeviceUnavailable" in out.stderr, out.stderr
    assert "backfilled" not in out.stdout
    assert rows(store.path, "select count(1) from align_tasks where p_value is not null"
                )[0][0] == 0
    assert queue.pending(TOPIC_JOBS) == before
    assert rows(store.path, "select count(1) from jobs where status != 'ready'")[0][0] == 0
    assert queue.group_member_stats(GROUP) == []


def failing_p_value(error):
    def fault(monkeypatch):
        from aligner_tpu_torch.service import blast_cmp

        def fail(*a, **kw):
            raise error("simulated")

        monkeypatch.setattr(port_calc, "calculate_p_value", fail)
        monkeypatch.setattr(blast_cmp, "calculate_p_value", fail)
        return error

    return fault


@pytest.mark.parametrize("fault, device", [
    (no_card, None),
    (failing_p_value(_build.KernelBuildFailure), "cpu"),
    (failing_p_value(RuntimeError), "cpu"),  # a CUDA launch error
], ids=["no-card", "broken-build", "cuda-error"])
def test_backfills_without_a_working_card_store_nothing(svc, monkeypatch, tmp_path, fault,
                                                        device):
    """calc's and blast_cmp's passes raise on a missing card, a failed
    kernel build or a CUDA error (the reference's copies would log each
    row and report a finished pass), and store nothing."""
    from aligner_tpu_torch.service.blast_cmp import load_blast_results, run_cmp

    store = promoted_task(svc)
    csvp = tmp_path / "blast.csv"
    csvp.write_text("a,b,0|005\n".replace("|", ","))
    assert load_blast_results(store, str(csvp)) == 1
    error = fault(monkeypatch)
    with pytest.raises(error):
        port_calc.run_once(store, rng=np.random.default_rng(0), device=device,
                           n_sequences=12)
    with pytest.raises(error):
        run_cmp(store, rng=np.random.default_rng(0), device=device, n_sequences=12)
    assert len(store.get_ids_with_null_p_value()) == 1
    assert store.get_cmp_table()[0][4] is None


# --------------------------------------------------------------------------
# the attempts bound
# --------------------------------------------------------------------------


@pytest.mark.parametrize("error", [ZeroDivisionError, RuntimeError])
def test_failing_job_is_redelivered_until_max_attempts(svc, monkeypatch, error):
    """A population that raises outside the data errors leaves the jobs
    claimed for redelivery, and once MAX_ATTEMPTS claims have failed they
    are committed away, with nothing stored.  A ZeroDivisionError is
    presumed transient: the worker goes on, and commits the jobs away on
    their MAX_ATTEMPTS-th claim.  A RuntimeError (what a CUDA launch or a
    broken CUDA context raises) is the worker's own fault: it propagates,
    so each claim is a restarted worker's, and the claim after the
    MAX_ATTEMPTS-th drops the jobs unrun."""
    disp, store, queue = svc
    disp.validate(REQ)
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        raise error("simulated")

    monkeypatch.setattr(worker_mod, "heuristic_align_population", failing)
    short_lease(monkeypatch, 0.02)
    stops = error is RuntimeError
    for attempt in range(1, MAX_ATTEMPTS + 1):
        w = Worker(store, queue, batch=64, device="cpu")  # a restarted process
        if stops:
            with pytest.raises(RuntimeError):
                w.process_batch()
        else:
            assert w.process_batch() == 9
        states = rows(store.path, "select status, attempts from jobs")
        if attempt < MAX_ATTEMPTS or stops:
            assert states == [("claimed", attempt)] * 9
            time.sleep(0.05)  # past the lease: redeliverable
        else:
            assert states == [("done", MAX_ATTEMPTS)] * 9
    if stops:
        assert Worker(store, queue, batch=64, device="cpu").process_batch() == 9
        assert rows(store.path, "select status, attempts from jobs") == [
            ("done", MAX_ATTEMPTS + 1)] * 9
    assert len(calls) == (1 if stops else 3) * MAX_ATTEMPTS
    assert queue.pending(TOPIC_JOBS) == 0
    assert rows(store.path, "select count(1) from align_subtasks")[0][0] == 0


def failing_warmup(error, monkeypatch):
    import aligner_tpu_torch.heuristic as heuristic

    def fail(*a, **kw):
        raise error("simulated")

    monkeypatch.setattr(heuristic, "warmup_population", fail)


def failing_population(error, monkeypatch):
    def fail(*a, **kw):
        raise error("simulated")

    monkeypatch.setattr(worker_mod, "heuristic_align_population", fail)


@pytest.mark.parametrize("where", [failing_population, failing_warmup],
                         ids=["population", "warmup"])
@pytest.mark.parametrize("error, device", [
    (RuntimeError, "cpu"),
    (RuntimeError, "cuda"),
    (ZeroDivisionError, "cuda"),
], ids=["cuda-error-cpu-worker", "cuda-error", "other-error-on-the-card"])
def test_worker_that_keeps_failing_stops_before_the_next_batch(svc, monkeypatch, where,
                                                               error, device):
    """A worker whose every population (or whose warmup) raises its own
    fault, a RuntimeError anywhere or any error but a data error on the
    card (a broken CUDA context fails every later call), stops: it claims
    no second batch, drops nothing, and its first batch (if it claimed
    one) stays claimed for another worker once the leases run out."""
    disp, store, queue = svc
    disp.validate(REQ)
    where(error, monkeypatch)
    w = Worker(store, queue, batch=3, device="cpu")
    w.device = torch.device(device)  # the card's rules, no card needed
    with pytest.raises(error):
        w.run_forever(poll_interval=0, max_batches=10, warmup=where is failing_warmup)
    claimed = 3 if where is failing_population else 0
    assert sorted(rows(store.path, "select status, attempts from jobs")) == sorted(
        [("claimed", 1)] * claimed + [("ready", 0)] * (9 - claimed))
    assert rows(store.path, "select count(1) from align_subtasks")[0][0] == 0


def test_job_claimed_past_the_bound_is_dropped_unrun(svc, monkeypatch):
    """A job whose earlier holders died before committing (claimed
    MAX_ATTEMPTS times already) is committed away without a population."""
    disp, store, queue = svc
    disp.validate(REQ)
    with queue._conn() as c:
        c.execute("update jobs set attempts = ? where id <= 3", (MAX_ATTEMPTS,))
    ran = []
    real = worker_mod.heuristic_align_population
    monkeypatch.setattr(worker_mod, "heuristic_align_population",
                        lambda *a, **kw: ran.append(len(a[2])) or real(*a, **kw))
    w = Worker(store, queue, batch=64, device="cpu")
    assert w.process_batch() == 9
    assert ran == [3, 3]  # the first task's three jobs never ran
    assert queue.pending(TOPIC_JOBS) == 0
    assert rows(store.path, "select count(1) from align_subtasks")[0][0] == 6


def test_worker_stops_on_a_machine_fault_mid_batch(svc, monkeypatch):
    """A failed kernel build inside a population is the worker's fault,
    not the job's: it propagates, and the batch stays claimed (nothing
    dropped) for lease-expiry redelivery to another worker."""
    disp, store, queue = svc
    disp.validate(REQ)

    def fail(*a, **kw):
        raise _build.KernelBuildFailure("nvcc failed")

    monkeypatch.setattr(worker_mod, "heuristic_align_population", fail)
    w = Worker(store, queue, batch=64, device="cpu")
    with pytest.raises(_build.KernelBuildFailure):
        w.process_batch()
    assert rows(store.path, "select distinct status, attempts from jobs") == [("claimed", 1)]
