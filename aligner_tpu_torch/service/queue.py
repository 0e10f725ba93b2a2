"""Lease-based work queue — the Kafka replacement.

Semantics matched to the reference's consumer setup (node/main.rs:32-44):
consumer groups, at-least-once delivery (a claimed job whose lease
expires before commit is redelivered), and a consumer registry backing
``/health/check`` (the reference lists consumer-group members,
handlers.rs:52-67).  Backed by the same sqlite file as the results store
so a single ALIGNER_DB env var configures the whole service.

Departure from the reference: ``claim_batch`` hands a worker *many* jobs
of the same task at once, so a worker turns a message stream into one
batched device launch per heuristic iteration.

The port's copy of ``aligner_tpu/service/queue.py``.  It adds one column,
``attempts``: the claims a job has had.  ``claim_batch`` increments it in
the claiming ``UPDATE`` and hands it to the worker, which commits away a
job that failed :data:`MAX_ATTEMPTS` times, whatever failed (the
reference redelivers a job that fails the same way forever, each retry a
full fill).  A ``jobs`` table written by the JAX package gains the column
in place when this class opens its file; the JAX package still opens the
file afterwards (its statements name their columns, and inserts take the
column's default).
"""

from __future__ import annotations

import os
import sqlite3
import time
import uuid
from contextlib import contextmanager

_SCHEMA = [
    """create table if not exists jobs (
        id integer primary key autoincrement,
        topic text not null,
        grp text not null,
        payload text not null,
        status text not null default 'ready',   -- ready | claimed | done
        consumer text,
        lease_until double,
        created double not null,
        attempts integer not null default 0
    )""",
    "create index if not exists jobs_topic on jobs (topic, grp, status)",
    """create table if not exists consumers (
        name text primary key,
        grp text not null,
        last_seen double not null
    )""",
]

HEALTH_WINDOW = 15.0  # seconds of silence before a consumer drops out
# default job lease.  A population can outlast it (a long pair, a slow
# host), so liveness is NOT the lease alone: while a batch is processing,
# the worker's _LeaseKeeper heartbeats extend that batch's leases (the
# max.poll.interval-style liveness the reference gets from Kafka,
# node/main.rs:32-44) — a slow-but-alive worker keeps its batch; only a
# silent one loses it.  Extension is scoped to the in-flight batch so
# jobs left claimed on purpose (store failure → redeliver) still expire.
DEFAULT_LEASE = 120.0
# dead consumers stay visible in /health/check this long (ops can see a
# recent crash), then their rows are reaped — workers register a fresh
# uuid name per start, so without retention the table and the health
# payload grow one permanent entry per past worker
CONSUMER_RETENTION = 3600.0
# claims a job may have: a worker commits away a job whose processing
# failed on its MAX_ATTEMPTS-th claim, and one claimed past it (its earlier
# holders died before they committed), with a warning
MAX_ATTEMPTS = 5


def open_queue(path: str | None = None):
    """Local sqlite JobQueue, or a RemoteQueue against the host-0 state
    endpoint when the path is an http(s) URL (the multi-host replacement
    for the reference's Kafka broker, config/node/dev.env)."""
    import os as _os

    from .netstate import RemoteQueue, is_url
    from .store import default_db_path

    path = path or _os.environ.get("ALIGNER_QUEUE", default_db_path())
    return RemoteQueue(path) if is_url(path) else JobQueue(path)


class JobQueue:
    def __init__(self, path: str | None = None):
        from .store import default_db_path

        self.path = path or os.environ.get("ALIGNER_QUEUE", default_db_path())
        with self._conn() as c:
            for q in _SCHEMA:
                c.execute(q)
            # a jobs table the JAX package made has no attempts column:
            # add it in place.  A concurrent starter may have added it
            # between the check and the ALTER; any other error propagates
            cols = {r[1] for r in c.execute("pragma table_info(jobs)")}
            if "attempts" not in cols:
                try:
                    c.execute("alter table jobs add column attempts "
                              "integer not null default 0")
                except sqlite3.OperationalError as e:
                    if "duplicate column" not in str(e):
                        raise

    @contextmanager
    def _conn(self):
        conn = sqlite3.connect(self.path, timeout=30.0)
        try:
            conn.execute("pragma journal_mode=WAL")
            yield conn
            conn.commit()
        finally:
            conn.close()

    def produce(self, topic: str, payload: str, group: str = "aligner.jobs.group"):
        with self._conn() as c:
            c.execute(
                "insert into jobs (topic, grp, payload, created) values (?,?,?,?)",
                (topic, group, payload, time.time()),
            )

    def register_consumer(self, group: str, name: str | None = None) -> str:
        name = name or f"consumer-{uuid.uuid4().hex[:8]}"
        self.heartbeat(name, group)
        return name

    def heartbeat(
        self,
        name: str,
        group: str,
        lease: float = DEFAULT_LEASE,
        job_ids: list[int] | None = None,
    ) -> None:
        """Refresh the consumer registry and, when ``job_ids`` is given,
        extend THOSE jobs' leases to ``now + lease`` (see DEFAULT_LEASE).

        Extension is scoped to the batch actually being processed (the
        worker's _LeaseKeeper passes its claimed ids) rather than to
        everything under the consumer's name: a job deliberately left
        claimed so lease expiry redelivers it (double store failure), or
        one orphaned by a restarted worker reusing a name, must not be
        kept alive forever by unrelated polling.  Only jobs still owned
        are touched: a job whose expired lease was already reclaimed by
        another worker has a different ``consumer`` and is left alone,
        so ownership can never be stolen back."""
        now = time.time()
        with self._conn() as c:
            c.execute(
                """insert into consumers (name, grp, last_seen) values (?,?,?)
                   on conflict(name) do update set last_seen = excluded.last_seen""",
                (name, group, now),
            )
            if job_ids:
                marks = ",".join("?" * len(job_ids))
                c.execute(
                    f"""update jobs set lease_until = max(lease_until, ?)
                        where consumer = ? and status = 'claimed'
                          and id in ({marks})""",
                    (now + lease, name, *job_ids),
                )
            c.execute(
                "delete from consumers where last_seen < ?",
                (now - CONSUMER_RETENTION,),
            )

    def deregister_consumer(self, name: str) -> None:
        """Remove a consumer row on CLEAN shutdown, so routine worker
        restarts (each start registers a fresh uuid name) don't leave
        an hour of ``status: false`` ghosts in ``/health/check``.
        Crashed workers never reach this and stay visible until
        CONSUMER_RETENTION reaps them — that lingering is the crash
        signal the retention window exists for."""
        with self._conn() as c:
            c.execute("delete from consumers where name = ?", (name,))

    def group_members(self, group: str) -> list[str]:
        """Names inside the heartbeat window — a projection of
        :meth:`group_member_stats` so the two liveness views cannot
        drift."""
        return [
            m["name"] for m in self.group_member_stats(group) if m["alive"]
        ]

    def group_member_stats(self, group: str) -> list[dict]:
        """Per-consumer liveness + load, for ``/health/check`` — the
        reference reports actual member state from Kafka group metadata
        (handlers.rs:32-70), not a hardcoded flag.  Consumers seen
        within CONSUMER_RETENTION are listed; ``alive`` reflects the
        heartbeat window and ``claimed`` counts currently-leased jobs."""
        now = time.time()
        with self._conn() as c:
            rows = c.execute(
                """select cs.name, cs.last_seen,
                          (select count(1) from jobs j
                           where j.consumer = cs.name and j.status = 'claimed'
                             and j.lease_until >= ?) as claimed
                   from consumers cs where cs.grp = ? and cs.last_seen >= ?
                   order by cs.name""",
                (now, group, now - CONSUMER_RETENTION),
            ).fetchall()
        return [
            {
                "name": r[0],
                "alive": (now - r[1]) <= HEALTH_WINDOW,
                "last_seen_age": max(now - r[1], 0.0),
                "claimed": int(r[2]),
            }
            for r in rows
        ]

    def claim_batch(
        self,
        topic: str,
        consumer: str,
        group: str = "aligner.jobs.group",
        limit: int = 64,
        lease: float = DEFAULT_LEASE,
    ) -> list[tuple[int, str, int]]:
        """Claim up to ``limit`` ready (or lease-expired) jobs: (id,
        payload, attempts), ``attempts`` counting this claim.

        Mutual exclusion matches Kafka's consumer-group ownership
        (node/main.rs:32-44): ``BEGIN IMMEDIATE`` takes the sqlite write
        lock before the candidate SELECT, so two concurrently polling
        workers serialize and can never claim the same job.  The claim
        is ONE batched UPDATE (re-stating the claimability predicate as
        belt-and-suspenders against any writer that bypassed the
        immediate transaction) — per-row updates would hold the
        exclusive lock for ``limit`` round-trips while every other
        poller blocks."""
        now = time.time()
        claimed: list[tuple[int, str, int]] = []
        with self._conn() as c:
            c.isolation_level = None  # explicit transaction control
            c.execute("begin immediate")
            rows = c.execute(
                """select id, payload, attempts + 1 from jobs
                   where topic = ? and grp = ?
                     and (status = 'ready'
                          or (status = 'claimed' and lease_until < ?))
                   order by id limit ?""",
                (topic, group, now, limit),
            ).fetchall()
            if rows:
                ids = [r[0] for r in rows]
                ph = ",".join("?" * len(ids))
                cur = c.execute(
                    f"""update jobs set status='claimed', consumer=?,
                               lease_until=?, attempts = attempts + 1
                        where id in ({ph})
                          and (status = 'ready'
                               or (status = 'claimed' and lease_until < ?))""",
                    (consumer, now + lease, *ids, now),
                )
                if cur.rowcount == len(ids):
                    claimed = [(int(r[0]), r[1], int(r[2])) for r in rows]
                else:  # unreachable under the immediate lock; re-project
                    owned = c.execute(
                        f"""select id, payload, attempts from jobs
                            where id in ({ph}) and consumer = ?
                              and status = 'claimed' and lease_until = ?""",
                        (*ids, consumer, now + lease),
                    ).fetchall()
                    claimed = [(int(r[0]), r[1], int(r[2])) for r in owned]
        return claimed

    def peek(
        self,
        topic: str,
        group: str = "aligner.jobs.group",
        limit: int = 64,
    ) -> list[str]:
        """Payloads of up to ``limit`` currently-claimable jobs WITHOUT
        claiming them — the worker ``--warmup`` reads real job shapes to
        get its kernels ready before taking any lease."""
        now = time.time()
        with self._conn() as c:
            rows = c.execute(
                """select payload from jobs
                   where topic = ? and grp = ?
                     and (status = 'ready'
                          or (status = 'claimed' and lease_until < ?))
                   order by id limit ?""",
                (topic, group, now, limit),
            ).fetchall()
        return [r[0] for r in rows]

    def commit(self, job_ids: list[int]) -> None:
        if not job_ids:
            return
        with self._conn() as c:
            marks = ",".join("?" * len(job_ids))
            c.execute(f"update jobs set status='done' where id in ({marks})", job_ids)

    def pending(self, topic: str, group: str = "aligner.jobs.group") -> int:
        with self._conn() as c:
            row = c.execute(
                "select count(1) from jobs where topic=? and grp=? and status != 'done'",
                (topic, group),
            ).fetchone()
        return int(row[0])
