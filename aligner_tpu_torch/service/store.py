"""Results store: sqlite rebuild of the MariaDB repository
(aligner-web/src/repository/{mod.rs,queries.rs}).

Same schema (base_matrices, align_tasks, align_subtasks, result_matrices,
blast_cmp) and operations; thread-safe via one connection per call.  The
best-subtask query takes the actual MAX f_value — the reference's
``ORDER BY f_value LIMIT 1`` ascends and therefore promoted the *worst*
subtask (queries.rs:74-80); that is a bug, not a behavior, so it is
fixed here (the node computes f as a maximum, handlers promote "max").

The port's copy of ``aligner_tpu/service/store.py``: the same schema and
statements, so either package opens a file the other wrote.
"""

from __future__ import annotations

import os
import sqlite3
from contextlib import contextmanager

import numpy as np

from ..errors import ValidationError
from ..matrices import get_threshold
from .models import matrix_from_json, matrix_to_json

_SCHEMA = [
    """create table if not exists base_matrices (
        id integer primary key autoincrement,
        dim smallint not null,
        matrix_json text not null unique
    )""",
    """create table if not exists align_tasks (
        id integer primary key autoincrement,
        hash text not null unique,
        query_sequence_id text not null,
        query_sequence text not null,
        target_sequence_id text not null,
        target_sequence text not null,
        kd_value double not null,
        r_squared_value double not null,
        del_value double not null,
        dim_value smallint not null,
        matrices_volume_value smallint not null,
        status text not null,
        p_value double
    )""",
    """create table if not exists align_subtasks (
        id integer primary key autoincrement,
        task_id int not null references align_tasks (id),
        f_value double not null,
        matrix_json text not null,
        result_query_sequence text,
        result_target_sequence text,
        source_key text
    )""",
    # at-least-once queue delivery (lease redelivery) may hand the same
    # job to two workers; keying subtasks by origin job makes the insert
    # idempotent so the completion count stays exact (Kafka gets this
    # from offset semantics; node/main.rs:76-88 relies on it)
    """create unique index if not exists subtasks_source
       on align_subtasks (task_id, source_key)""",
    """create table if not exists result_matrices (
        id integer primary key autoincrement,
        task_id int not null references align_tasks (id),
        f_value double not null,
        matrix_json text not null,
        result_query_sequence text,
        result_target_sequence text
    )""",
    """create table if not exists blast_cmp (
        id integer primary key autoincrement,
        query_sequence text not null,
        target_sequence text not null,
        blast_p_value double,
        p_value double
    )""",
]


def default_db_path() -> str:
    return os.environ.get("ALIGNER_DB", os.path.join(os.getcwd(), "aligner.db"))


def open_store(path: str | None = None):
    """Local sqlite Store, or a :class:`~.netstate.RemoteStore` when the
    path is an http(s) URL (the host-0 state endpoint — the multi-host
    replacement for the reference's network-reachable MariaDB,
    repository/mod.rs:278-334)."""
    path = path or default_db_path()
    from .netstate import RemoteStore, is_url

    return RemoteStore(path) if is_url(path) else Store(path)


class Store:
    """Connector equivalent (repository/mod.rs)."""

    def __init__(self, path: str | None = None):
        self.path = path or default_db_path()
        with self._conn() as c:
            for q in _SCHEMA:
                try:
                    c.execute(q)
                except sqlite3.OperationalError as e:
                    # pre-existing DB whose align_subtasks predates the
                    # source_key column: migrate in place, then retry.
                    # Only this one error triggers the ALTER — anything
                    # else ('database is locked', ...) must propagate
                    # untouched, and a concurrent starter may have
                    # already added the column
                    if "source_key" not in str(e):
                        raise
                    try:
                        c.execute(
                            "alter table align_subtasks "
                            "add column source_key text"
                        )
                    except sqlite3.OperationalError as e2:
                        if "duplicate column" not in str(e2):
                            raise
                    c.execute(q)

    @contextmanager
    def _conn(self):
        conn = sqlite3.connect(self.path, timeout=30.0)
        try:
            conn.execute("pragma journal_mode=WAL")
            yield conn
            conn.commit()
        finally:
            conn.close()

    # --- align task lifecycle ---

    def insert_align_task(
        self, req, hash_: str,
        query_id: str, query_seq: str, target_id: str, target_seq: str,
    ) -> str:
        """Insert with hash-unique de-dup (queries.rs:52-55, duplicate →
        error like the MariaDB unique constraint, handlers.rs:118-121)."""
        with self._conn() as c:
            try:
                c.execute(
                    """insert into align_tasks (hash, query_sequence_id,
                       query_sequence, target_sequence_id, target_sequence,
                       kd_value, r_squared_value, del_value, dim_value,
                       matrices_volume_value, status)
                       values (?,?,?,?,?,?,?,?,?,?,?)""",
                    (
                        hash_, query_id, query_seq, target_id, target_seq,
                        req.kd_value, req.r_squared_value, req.del_value,
                        req.dim_value, req.matrices_volume_value, "CREATED",
                    ),
                )
            except sqlite3.IntegrityError as e:
                raise ValidationError(f"duplicate task hash {hash_}") from e
        return hash_

    def get_task_id_by_hash(self, hash_: str) -> int | None:
        with self._conn() as c:
            row = c.execute(
                "select id from align_tasks where hash = ?", (hash_,)
            ).fetchone()
        return row[0] if row else None

    def get_status_by_hash(self, hash_: str) -> str | None:
        with self._conn() as c:
            row = c.execute(
                "select status from align_tasks where hash = ?", (hash_,)
            ).fetchone()
        return row[0] if row else None

    def insert_align_subtask(
        self, hash_: str, f_value: float, matrix: np.ndarray,
        result_query: str, result_target: str,
        source_key: str | None = None,
    ) -> None:
        """``source_key`` (the origin queue-job id) makes the insert
        idempotent under at-least-once redelivery: a duplicate delivery
        of the same job is a no-op instead of a duplicate subtask that
        would overshoot the completion percentage.  ``None`` keeps the
        unkeyed (always-insert) behavior for direct API use.

        The status check shares one ``BEGIN IMMEDIATE`` transaction with
        the insert: a redelivery that lands AFTER promotion (promotion
        deletes the subtask rows — and with them the source_keys the
        idempotency guard needs) must be a no-op, not an orphan row in
        a DONE task that would drag the reported percentage below 100
        forever."""
        with self._conn() as c:
            c.isolation_level = None
            c.execute("begin immediate")
            row = c.execute(
                "select id, status from align_tasks where hash = ?",
                (hash_,),
            ).fetchone()
            if row is None:
                raise ValidationError(f"no task with hash {hash_}")
            task_id, status = row
            if status == "DONE":
                return
            c.execute(
                """insert or ignore into align_subtasks
                   (task_id, f_value, matrix_json, result_query_sequence,
                    result_target_sequence, source_key) values (?,?,?,?,?,?)""",
                (
                    task_id, f_value, matrix_to_json(matrix),
                    result_query, result_target,
                    None if source_key is None else str(source_key),
                ),
            )

    def get_percentage_by_hash(self, hash_: str) -> float:
        """subtasks / matrices_volume * 100 (queries.rs:67-72)."""
        with self._conn() as c:
            row = c.execute(
                """select count(1) * 100.0 / at2.matrices_volume_value
                   from align_subtasks a
                   inner join align_tasks at2 on at2.id = a.task_id
                   where at2.hash = ?""",
                (hash_,),
            ).fetchone()
        return float(row[0]) if row and row[0] is not None else 0.0

    def get_best_subtask_by_hash(self, hash_: str):
        """MAX-f subtask (fixing queries.rs:74-80's ascending sort)."""
        with self._conn() as c:
            row = c.execute(
                """select f_value, matrix_json, result_query_sequence,
                          result_target_sequence
                   from align_subtasks a
                   inner join align_tasks at2 on a.task_id = at2.id
                   where at2.hash = ?
                   order by f_value desc limit 1""",
                (hash_,),
            ).fetchone()
        if row is None:
            return None
        return (float(row[0]), matrix_from_json(row[1]), row[2], row[3])

    def insert_result_matrix_by_hash(self, subtask, hash_: str) -> None:
        task_id = self.get_task_id_by_hash(hash_)
        f, matrix, rq, rt = subtask
        with self._conn() as c:
            c.execute(
                """insert into result_matrices
                   (task_id, f_value, matrix_json, result_query_sequence,
                    result_target_sequence) values (?,?,?,?,?)""",
                (task_id, f, matrix_to_json(matrix), rq, rt),
            )
            c.execute(
                "update align_tasks set status = 'DONE' where id = ?", (task_id,)
            )

    def delete_subtasks_by_hash(self, hash_: str) -> None:
        with self._conn() as c:
            c.execute(
                """delete from align_subtasks where task_id in
                   (select id from align_tasks where hash = ?)""",
                (hash_,),
            )

    def promote_if_complete(self, hash_: str) -> bool:
        """The promotion step shared by the progress handler
        (handlers.rs:165-172) and the updater (updater.rs:12-29).

        One ``BEGIN IMMEDIATE`` transaction so two concurrent progress
        streams cannot both promote (exactly one result_matrices row per
        task), and the gate is ``>= 100%`` rather than ``== 100%``: a
        rare unkeyed duplicate subtask overshooting the count must not
        deadlock the task forever (the reference's ``== 100`` gate only
        survives because Kafka rebalance duplicates are rare)."""
        with self._conn() as c:
            c.isolation_level = None
            c.execute("begin immediate")
            task = c.execute(
                """select id, matrices_volume_value, status
                   from align_tasks where hash = ?""",
                (hash_,),
            ).fetchone()
            if task is None:
                return False
            task_id, volume, status = task
            if status == "DONE":
                return False  # already promoted (idempotence guard)
            count = c.execute(
                "select count(1) from align_subtasks where task_id = ?",
                (task_id,),
            ).fetchone()[0]
            if count * 100.0 < 100.0 * volume - 1e-9:
                return False
            best = c.execute(
                """select f_value, matrix_json, result_query_sequence,
                          result_target_sequence
                   from align_subtasks where task_id = ?
                   order by f_value desc limit 1""",
                (task_id,),
            ).fetchone()
            if best is None:
                return False
            c.execute(
                """insert into result_matrices
                   (task_id, f_value, matrix_json, result_query_sequence,
                    result_target_sequence) values (?,?,?,?,?)""",
                (task_id, float(best[0]), best[1], best[2], best[3]),
            )
            c.execute(
                "update align_tasks set status = 'DONE' where id = ?", (task_id,)
            )
            c.execute(
                "delete from align_subtasks where task_id = ?", (task_id,)
            )
        return True

    # --- p-value backfill (calc bin) ---

    def get_ids_with_null_p_value(self) -> list[int]:
        with self._conn() as c:
            return [
                r[0]
                for r in c.execute(
                    "select id from align_tasks where p_value is null"
                ).fetchall()
            ]

    def get_all_unfinished_hashes(self) -> list[str]:
        with self._conn() as c:
            return [
                r[0]
                for r in c.execute(
                    "select hash from align_tasks where p_value is null"
                ).fetchall()
            ]

    def get_result_matrix_by_task_id(self, task_id: int):
        with self._conn() as c:
            row = c.execute(
                """select at2.query_sequence, at2.target_sequence, rm.f_value,
                          at2.del_value, rm.matrix_json
                   from result_matrices rm
                   inner join align_tasks at2 on rm.task_id = at2.id
                   where rm.task_id = ?""",
                (task_id,),
            ).fetchone()
        if row is None:
            return None
        return (row[0], row[1], float(row[2]), float(row[3]), matrix_from_json(row[4]))

    def add_p_value_by_id(self, p_value: float, task_id: int) -> None:
        with self._conn() as c:
            c.execute(
                "update align_tasks set p_value = ? where id = ?", (p_value, task_id)
            )

    # --- base matrices ---

    def get_base_matrices_with_limit(self, dim: int, limit: int) -> list[np.ndarray]:
        with self._conn() as c:
            rows = c.execute(
                "select matrix_json from base_matrices where dim = ? limit ?",
                (dim, limit),
            ).fetchall()
        return [matrix_from_json(r[0]) for r in rows]

    def insert_base_matrix(self, dim: int, matrix: np.ndarray) -> None:
        with self._conn() as c:
            c.execute(
                "insert or ignore into base_matrices (dim, matrix_json) values (?, ?)",
                (dim, matrix_to_json(matrix)),
            )

    # --- blast comparison (blast_cmp) ---

    def insert_blast_result(self, query: str, target: str, blast_p: float) -> None:
        with self._conn() as c:
            c.execute(
                """insert into blast_cmp (query_sequence, target_sequence,
                   blast_p_value) values (?,?,?)""",
                (query, target, blast_p),
            )

    def get_cmp_rows_with_null_p_value(self) -> list[tuple[int, str, str]]:
        with self._conn() as c:
            return c.execute(
                """select id, query_sequence, target_sequence from blast_cmp
                   where p_value is null"""
            ).fetchall()

    def get_sequence_by_identifier(self, ident: str) -> str | None:
        """Resolve an identifier to its sequence, whichever side of a
        task it appears on (generate_pairs makes the LAST record of a
        request target-only, so a query-column-only search would never
        find it)."""
        with self._conn() as c:
            row = c.execute(
                """select query_sequence from align_tasks
                   where query_sequence_id = ? limit 1""",
                (ident,),
            ).fetchone()
            if row is None:
                row = c.execute(
                    """select target_sequence from align_tasks
                       where target_sequence_id = ? limit 1""",
                    (ident,),
                ).fetchone()
        return row[0] if row else None

    def add_cmp_p_value_by_id(self, p_value: float, row_id: int) -> None:
        with self._conn() as c:
            c.execute(
                "update blast_cmp set p_value = ? where id = ?", (p_value, row_id)
            )

    def get_cmp_table(self):
        with self._conn() as c:
            return c.execute(
                """select id, query_sequence, target_sequence, blast_p_value,
                          p_value from blast_cmp"""
            ).fetchall()


def get_population(
    store: Store, dim: int, limit: int, rng: np.random.Generator | None = None
) -> list[np.ndarray]:
    """Fetch/generate `limit` mutually-distant random matrices
    (repository/mod.rs:336-387): stored ones first, then random {-1,0,1}
    matrices each at L2 distance >= get_threshold(dim) from all others."""
    rng = rng or np.random.default_rng()
    matrices = store.get_base_matrices_with_limit(dim, limit)
    if len(matrices) < limit:
        threshold = get_threshold(dim)
        while len(matrices) < limit:
            m = rng.integers(-1, 2, size=(dim, dim)).astype(np.float64)
            if all(np.linalg.norm(m - other) >= threshold for other in matrices):
                store.insert_base_matrix(dim, m)
                matrices.append(m)
    return matrices
