"""The port's HTTP state endpoint (``aligner_tpu_torch.service.netstate``):
RemoteStore/RemoteQueue against serve_state, the mirror of
tests/test_netstate.py; and the port's service as separate processes on
one machine (a state server, the dispatcher, and two
``aligner_tpu_torch.service.worker`` processes with ``--device cpu``, one
reaching the state over HTTP with a token), in the manner of
tests/test_multihost.py::test_launch_pod_script_two_hosts.
"""

from __future__ import annotations

import json
import os
import signal
import socket
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

from aligner_tpu_torch.errors import ValidationError
from aligner_tpu_torch.service.netstate import (
    RemoteQueue,
    RemoteStore,
    is_url,
    serve_state,
)
from aligner_tpu_torch.service.queue import open_queue
from aligner_tpu_torch.service.store import open_store

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def endpoint(tmp_path):
    server = serve_state("127.0.0.1", 0, str(tmp_path / "state.db"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    yield url
    server.shutdown()


class Req:
    kd_value = 0.0
    r_squared_value = 100.0
    del_value = 7.0
    dim_value = 24
    matrices_volume_value = 2


def test_store_roundtrip_over_http(endpoint, rng):
    store = RemoteStore(endpoint)
    store.insert_align_task(Req, "h1", "qid", "HEAG", "tid", "PAWH")
    assert store.get_task_id_by_hash("h1") == 1
    assert store.get_task_id_by_hash("missing") is None
    with pytest.raises(ValidationError):
        store.insert_align_task(Req, "h1", "qid", "HEAG", "tid", "PAWH")

    m = rng.integers(-2, 3, (24, 24)).astype(np.float64)
    store.insert_align_subtask("h1", 12.5, m, "HE_AG", "PAWH_")
    store.insert_align_subtask("h1", 30.0, m * 2, "HEAG", "PAWH")
    assert store.get_percentage_by_hash("h1") == 100.0
    f, best_m, rq, rt = store.get_best_subtask_by_hash("h1")
    assert f == 30.0
    np.testing.assert_array_equal(best_m, m * 2)  # ndarray round-trip
    assert store.promote_if_complete("h1") is True
    assert store.get_all_unfinished_hashes() == ["h1"]

    store.insert_base_matrix(24, m)
    back = store.get_base_matrices_with_limit(24, 5)
    assert len(back) == 1
    np.testing.assert_array_equal(back[0], m)


def test_queue_roundtrip_over_http(endpoint):
    queue = RemoteQueue(endpoint)
    name = queue.register_consumer("grp", "worker-x")
    assert name == "worker-x"
    queue.heartbeat(name, "grp")
    assert queue.group_members("grp") == ["worker-x"]

    queue.produce("topic", "payload-1", "grp")
    queue.produce("topic", "payload-2", "grp")
    assert queue.pending("topic", "grp") == 2
    claimed = queue.claim_batch("topic", name, "grp", limit=10)
    assert [(p, n) for _, p, n in claimed] == [("payload-1", 1), ("payload-2", 1)]
    queue.commit([jid for jid, _, _ in claimed])
    assert queue.pending("topic", "grp") == 0


def test_worker_end_to_end_over_http(endpoint, rng):
    """The actual Worker, talking exclusively to the HTTP endpoint."""
    from aligner_tpu_torch.service.dispatcher import TOPIC_JOBS
    from aligner_tpu_torch.service.models import AlignJob
    from aligner_tpu_torch.service.worker import Worker

    store = RemoteStore(endpoint)
    queue = RemoteQueue(endpoint)
    qs = "".join("ARNDCQEGHILKMFPSTWYV"[c] for c in rng.integers(0, 20, 30))
    ts = "".join("ARNDCQEGHILKMFPSTWYV"[c] for c in rng.integers(0, 20, 32))
    store.insert_align_task(Req, "hw", "q", qs, "t", ts)
    freqs = np.full(24, 1.0 / 24)
    for _ in range(2):
        job = AlignJob(
            sequence_1=qs, sequence_2=ts,
            matrix=rng.integers(-1, 2, (24, 24)).astype(np.float64),
            frequences=freqs, kd_value=0.0, r_squared_value=100.0,
            del_value=7.0, matrices_volume_value=2, hash="hw",
        )
        queue.produce(TOPIC_JOBS, job.to_json())
    w = Worker(store=store, queue=queue, name="remote-worker", device="cpu")
    assert w.process_batch() == 2
    assert store.get_percentage_by_hash("hw") == 100.0
    assert store.promote_if_complete("hw") is True


def test_open_factories(tmp_path, endpoint, monkeypatch):
    assert is_url("http://x:1") and is_url("https://x") and not is_url("/a/b")
    monkeypatch.setenv("ALIGNER_DB", endpoint)
    monkeypatch.delenv("ALIGNER_QUEUE", raising=False)
    assert isinstance(open_store(), RemoteStore)
    assert isinstance(open_queue(), RemoteQueue)
    monkeypatch.setenv("ALIGNER_DB", str(tmp_path / "local.db"))
    from aligner_tpu_torch.service.queue import JobQueue
    from aligner_tpu_torch.service.store import Store

    assert isinstance(open_store(), Store)
    assert isinstance(open_queue(), JobQueue)


def test_unknown_method_rejected(endpoint):
    store = RemoteStore(endpoint)
    with pytest.raises(AttributeError):
        store._conn()
    proxy = RemoteStore(endpoint)
    with pytest.raises(ValidationError):
        proxy._call("_conn")


def test_concurrent_remote_workers_at_least_once(endpoint):
    q1 = RemoteQueue(endpoint)
    q2 = RemoteQueue(endpoint)
    q1.register_consumer("grp", "w1")
    q2.register_consumer("grp", "w2")
    for i in range(10):
        q1.produce("race", f"job-{i}", "grp")
    got1 = q1.claim_batch("race", "w1", "grp", limit=6)
    got2 = q2.claim_batch("race", "w2", "grp", limit=6)
    ids1 = {j for j, _, _ in got1}
    ids2 = {j for j, _, _ in got2}
    assert not (ids1 & ids2)  # no double-claim while leases are live
    assert len(ids1 | ids2) == 10
    q1.commit(list(ids1))
    q2.commit(list(ids2))
    assert q1.pending("race", "grp") == 0


def test_token_gating(tmp_path, monkeypatch):
    monkeypatch.delenv("ALIGNER_STATE_TOKEN", raising=False)
    server = serve_state("127.0.0.1", 0, str(tmp_path / "tok.db"), token="s3cret")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError):
            # token="" = explicitly none (None falls back to the env)
            RemoteQueue(url, token="").pending("t")  # no token -> 403
        with pytest.raises(urllib.error.HTTPError):
            RemoteQueue(url, token="wrong").pending("t")
        assert RemoteQueue(url, token="s3cret").pending("t") == 0
        monkeypatch.setenv("ALIGNER_STATE_TOKEN", "s3cret")
        assert RemoteQueue(url).pending("t") == 0
    finally:
        server.shutdown()


# --------------------------------------------------------------------------
# the service as processes: state server, dispatcher, two workers
# --------------------------------------------------------------------------

REQ = {
    "sequences": ">q\nHEAGAWGHEEHEAGAWGHEE\n>t\nPAWHEAEPAWHEAEHEAGAW\n",
    "kdValue": 0.0,
    "rSquaredValue": 100.0,
    "delValue": 7.0,
    "dimValue": 24,
    "matricesVolumeValue": 4,
}
WAIT = 120.0  # seconds for each thing the processes must do


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, timeout: float = 5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _wait_for(what: str, cond, procs):
    deadline = time.time() + WAIT
    while True:
        try:
            if cond():
                return
        except (OSError, ValueError):
            pass  # not up yet
        dead = {n: p.returncode for n, p in procs.items() if p.poll() is not None}
        if dead or time.time() > deadline:
            logs = {n: procs[n].stdout.read()[-3000:] for n in dead}
            pytest.fail(f"{what}: timed out or processes exited {dead}: {logs}")
        time.sleep(0.2)


def test_service_processes_two_workers_one_over_http(tmp_path):
    """A state server process on the sqlite file, the dispatcher process,
    a worker on the file and a worker that reaches the state only over
    HTTP with the shared token: both register, a request posted to the
    dispatcher is drained by them and promoted through /progress, and
    every process stops when told."""
    state_port, http_port = _free_port(), _free_port()
    db = str(tmp_path / "aligner.db")
    token = "test-pod-secret"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               ALIGNER_LOG="info", ALIGNER_STATE_TOKEN=token, ALIGNER_DB=db)
    env.pop("ALIGNER_QUEUE", None)
    worker = [sys.executable, "-m", "aligner_tpu_torch.service.worker", "--device", "cpu",
              "--batch", "1", "--poll-interval", "0.1", "--max-batches", "3000"]
    cmds = {
        "state": ([sys.executable, "-m", "aligner_tpu_torch.service.netstate",
                   "--port", str(state_port), "--db", db], env),
        "dispatcher": ([sys.executable, "-m", "aligner_tpu_torch.service.dispatcher",
                        "--port", str(http_port)], env),
        "node-file": (worker + ["--name", "node-file"], env),
        "node-http": (worker + ["--name", "node-http"],
                      dict(env, ALIGNER_DB=f"http://127.0.0.1:{state_port}")),
    }
    procs = {}

    def start(*names):
        for name in names:
            cmd, e = cmds[name]
            procs[name] = subprocess.Popen(
                cmd, env=e, cwd=str(tmp_path), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, start_new_session=True)

    try:
        # the state endpoint first: a worker that cannot reach it at start
        # exits (deploy/launch_pod.sh waits for it the same way)
        start("state", "dispatcher")
        base = f"http://127.0.0.1:{http_port}"
        _wait_for("the state endpoint",
                  lambda: _get(f"http://127.0.0.1:{state_port}/healthz") == b"ok", procs)
        start("node-file", "node-http")

        def registered():
            nodes = json.loads(_get(f"{base}/health/check"))["nodes"]
            return {"node-file", "node-http"} <= {n["consumerName"] for n in nodes}

        _wait_for("both workers registered", registered, procs)
        # the HTTP worker's calls carry the token: without it the state refuses
        with pytest.raises(urllib.error.HTTPError):
            RemoteQueue(f"http://127.0.0.1:{state_port}", token="").pending("t")
        req = urllib.request.Request(f"{base}/validate", data=json.dumps(REQ).encode(),
                                     headers={"Content-Type": "application/json"})
        hashes = json.loads(urllib.request.urlopen(req, timeout=30).read())["hashes"]
        assert len(hashes) == 1

        def promoted():
            # the stream ticks once a second for as long as it is read:
            # take its first event (which promotes at 100 %)
            with urllib.request.urlopen(f"{base}/progress?hashes={hashes[0]}",
                                        timeout=30) as r:
                assert r.readline().decode().startswith("data:")
            with sqlite3.connect(db) as conn:
                return conn.execute(
                    """select count(1) from result_matrices rm
                       inner join align_tasks at2 on rm.task_id = at2.id
                       where at2.hash = ?""", (hashes[0],)).fetchone()[0] == 1

        _wait_for("promotion", promoted, procs)

        def jobs():
            with sqlite3.connect(db) as conn:
                return conn.execute("select status, attempts from jobs").fetchall()

        # a worker commits its batch after it stores the subtasks, so the
        # last commit can land just after the promotion
        _wait_for("the last batch committed",
                  lambda: all(status != "claimed" for status, _ in jobs()), procs)
        assert jobs() == [("done", 1)] * 4
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGTERM)
        for name, p in procs.items():
            try:
                p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate(timeout=30)
    assert all(p.poll() is not None for p in procs.values())


def test_launch_pod_torch_script_two_hosts(tmp_path):
    """``deploy/launch_pod_torch.sh`` for host 0 and host 1 on this machine,
    the workers on ``--device cpu``: host 0 runs the state endpoint, the
    dispatcher and a worker, host 1 a worker that reaches the state over
    HTTP with the shared token; both register, a request is drained and
    promoted, and every process stops when told (each wait bounded)."""
    state_port, http_port = _free_port(), _free_port()
    db = str(tmp_path / "aligner.db")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               ALIGNER_DB=db, ALIGNER_STATE_PORT=str(state_port),
               ALIGNER_HTTP_PORT=str(http_port), ALIGNER_DEVICE="cpu",
               ALIGNER_WORKER_ARGS="--batch 1 --poll-interval 0.1 --max-batches 3000",
               ALIGNER_LOG="info", ALIGNER_STATE_TOKEN="test-pod-secret")
    env.pop("ALIGNER_QUEUE", None)
    env_h1 = dict(env)
    del env_h1["ALIGNER_DB"]  # host 1 derives the HTTP endpoint itself
    script = os.path.join(REPO, "deploy", "launch_pod_torch.sh")
    procs = {name: subprocess.Popen(
        ["bash", script, "2", str(i), "127.0.0.1"], env=e, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for i, (name, e) in enumerate((("host0", env), ("host1", env_h1)))}
    base = f"http://127.0.0.1:{http_port}"
    try:
        def registered():
            nodes = json.loads(_get(f"{base}/health/check"))["nodes"]
            return {"node-host0", "node-host1"} <= {n["consumerName"] for n in nodes}

        _wait_for("both hosts' workers registered", registered, procs)
        req = urllib.request.Request(f"{base}/validate", data=json.dumps(REQ).encode(),
                                     headers={"Content-Type": "application/json"})
        hashes = json.loads(urllib.request.urlopen(req, timeout=30).read())["hashes"]
        assert len(hashes) == 1

        def promoted():
            with urllib.request.urlopen(f"{base}/progress?hashes={hashes[0]}",
                                        timeout=30) as r:
                assert r.readline().decode().startswith("data:")
            with sqlite3.connect(db) as conn:
                return conn.execute(
                    """select count(1) from result_matrices rm
                       inner join align_tasks at2 on rm.task_id = at2.id
                       where at2.hash = ?""", (hashes[0],)).fetchone()[0] == 1

        _wait_for("promotion", promoted, procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGTERM)
        for p in procs.values():
            try:
                p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate(timeout=30)
    assert all(p.poll() is not None for p in procs.values())
