"""Distributed alignment service, the port's copy of ``aligner_tpu.service``.

Rebuild of aligner-web: the dispatcher HTTP API (``/health/check``,
``/validate``, ``/progress``) is preserved, while Kafka is replaced by a
lease-based sqlite work queue and MariaDB by a sqlite results store (one
file, ``ALIGNER_DB``, which either package opens).  Workers claim whole
batches of candidate-matrix jobs and run each task's population as one
batched launch per heuristic iteration on the card
(:func:`~aligner_tpu_torch.heuristic.heuristic_align_population`) instead
of one process per message.

Task-hash idempotency (models.rs:101-118), at-least-once delivery with
redelivery on lease expiry (Kafka auto-commit semantics), best-subtask
promotion and subtask cleanup (queries.rs:74-91, updater.rs:12-29) are
all kept — with the reference's best-subtask ``ORDER BY f_value ASC``
bug fixed to an actual max, and redelivery bounded by
:data:`~.queue.MAX_ATTEMPTS` claims a job.
"""

from .models import AlignJob, AlignJobRequest, task_hash
from .queue import JobQueue
from .store import Store, get_population

__all__ = [
    "AlignJob",
    "AlignJobRequest",
    "task_hash",
    "JobQueue",
    "Store",
    "get_population",
]
