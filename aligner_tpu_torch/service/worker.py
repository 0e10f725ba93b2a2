"""Worker node (aligner-web/src/bin/node/main.rs).

Consumes alignment jobs and writes subtask results to the store.  The
reference's node deserializes one Kafka message at a time and runs one
heuristic local alignment per message (node/main.rs:49-88, calling the
heuristic with del for both gap params — the AlignJob carries a single
``del_value``).  This worker claims a *batch* of jobs and groups them by
task hash, so each task's whole candidate-matrix population advances as
one batched launch per heuristic iteration
(:func:`~aligner_tpu_torch.heuristic.heuristic_align_population`: the
fill, the walk, the frequency count and the float64 transform on the
card, with the population's state there).

Failure semantics kept: at-least-once (lease redelivery instead of Kafka
auto-commit), commit before the store write is *not* replicated — the
reference commits the Kafka offset before inserting into the DB
(node/main.rs:76-88), which can lose results on a crash; here jobs are
committed only after their subtasks are stored, with one retry on store
failure (matching the node's single reconnect-retry).

The port's copy of ``aligner_tpu/service/worker.py``, with three
departures:

* ``device`` (``--device``) in place of ``backend``; ``None`` means the
  card.  The constructor resolves it, and on the card loads the kernel
  library (the ``nvcc`` build on a cold checkout), before it registers: a
  worker with no card or a broken build raises having registered and
  claimed nothing.  (A copy of the reference would claim every batch and
  commit every job away, since its missing-device error is an
  ``AlignerError``.)
* Only a job's data errors drop it (:func:`~aligner_tpu_torch.errors.is_data_error`).
  The worker's own faults stop it, from a population or from the warmup,
  with its batch left claimed until the leases run out: no card, a failed
  build, a ``RuntimeError`` (what a CUDA launch or a broken CUDA context
  raises), and on the card any error that is not a data error.  A card
  whose context an illegal address or an ECC fault has broken fails every
  later population at once, so a worker that went on claiming would spend
  every job's attempts in a tight loop.  Any other error (on the CPU) is
  presumed transient and leaves the task's jobs claimed for redelivery
  while the worker goes on.
* Redelivery is bounded: a job whose processing fails on its
  :data:`~.queue.MAX_ATTEMPTS`-th claim, or that is claimed past it (its
  holders died, or stopped on their own faults), is committed away with a
  warning (the reference redelivers a job that fails the same way forever,
  each retry a full population).

The population always runs the host loop over the kernels.  There is no
fused device loop in the port, so ``ALIGNER_POP_DEVICE_LOOP``, which picks
the JAX worker's loop, is not read here.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from collections import defaultdict

import numpy as np

log = logging.getLogger("aligner_tpu_torch.worker")

from ..alphabet import Protein
from ..backend import resolve_device
from ..errors import DeviceUnavailable, is_data_error
from ..heuristic import Heuristics, heuristic_align_population
from .dispatcher import GROUP, TOPIC_JOBS
from .models import AlignJob
from .queue import HEALTH_WINDOW, MAX_ATTEMPTS, JobQueue, open_queue
from .store import Store, open_store


class _LeaseKeeper:
    """Background heartbeat while a claimed batch is being processed.

    A population can take longer than the job lease (a long pair, a busy
    host), so without this the batch lease-expires mid-population and is
    redelivered to another worker that starts it over.  Each heartbeat
    refreshes the consumer registry AND extends the leases of THIS batch's
    jobs (queue.heartbeat with the claimed ids — scoped so jobs
    deliberately left claimed for redelivery still expire), the liveness
    contract Kafka's max.poll.interval gave the reference for free
    (node/main.rs:32-44).
    """

    def __init__(self, queue, name: str, group: str,
                 job_ids: list[int] | None = None,
                 interval: float = HEALTH_WINDOW / 3.0):
        self._queue = queue
        self._name = name
        self._group = group
        self._job_ids = list(job_ids or [])
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self._queue.heartbeat(self._name, self._group,
                                      job_ids=self._job_ids)
            except Exception:
                pass  # a flaky state endpoint must not kill processing

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=self._interval + 5.0)


class Worker:
    def __init__(
        self,
        store: Store | None = None,
        queue: JobQueue | None = None,
        name: str | None = None,
        batch: int = 64,
        device=None,
    ):
        # the device first: a worker that cannot compute must not register
        # or claim (see the module docstring)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from ..ops import _build

            _build.load()
        # ALIGNER_DB may be an http:// URL: then this worker talks to the
        # host-0 state endpoint and joining is just "start the process on
        # another machine" (the reference's add-a-Kafka-consumer property)
        self.store = store or open_store()
        self.queue = queue or open_queue()
        self.name = self.queue.register_consumer(GROUP, name)
        self.batch = batch

    def _own_fault(self, e: BaseException) -> bool:
        """True for an error that is this worker's and not a job's (see
        the module docstring): it stops the worker."""
        return isinstance(e, (DeviceUnavailable, RuntimeError)) or (
            self.device.type == "cuda" and not is_data_error(e))

    def warmup(self) -> int:
        """Get the kernels ready for the next claimable batch WITHOUT
        taking a lease: peek at the real pending payloads and run one
        all-skip launch per task group at the shapes
        :func:`heuristic_align_population` will launch (zero-length
        problems — free).  Returns task groups warmed."""
        from ..heuristic import warmup_population

        by_task: dict[str, list[AlignJob]] = defaultdict(list)
        for payload in self.queue.peek(TOPIC_JOBS, GROUP, limit=self.batch):
            try:
                job = AlignJob.from_json(payload)
            except Exception:
                continue  # poison handling belongs to process_batch
            by_task[job.hash].append(job)
        for jobs in by_task.values():
            ref = jobs[0]
            warmup_population(
                Protein.encode(ref.sequence_1, strict=False),
                Protein.encode(ref.sequence_2, strict=False),
                len(jobs), ref.del_value, ref.del_value,
                device=self.device,
            )
        if by_task:
            log.info("warmup: %d task group(s) ready", len(by_task))
        return len(by_task)

    def process_batch(self) -> int:
        """Claim and process up to ``batch`` jobs; returns jobs handled."""
        self.queue.heartbeat(self.name, GROUP)
        t0 = time.perf_counter()
        claimed = self.queue.claim_batch(
            TOPIC_JOBS, self.name, GROUP, limit=self.batch
        )
        if not claimed:
            return 0
        ids = [job_id for job_id, _, _ in claimed]
        with _LeaseKeeper(self.queue, self.name, GROUP, job_ids=ids):
            self._process_claimed(claimed)
        log.info("batch of %d job(s): claim to commit %.6f s", len(claimed),
                 time.perf_counter() - t0)
        return len(claimed)

    def _spent(self, items, why: str) -> list[int]:
        """The ids among ``items`` (job id, job, attempts) whose claims
        have reached MAX_ATTEMPTS, with a warning for each: they are
        committed away, the rest left claimed for redelivery."""
        spent = []
        for job_id, _, attempts in items:
            if attempts >= MAX_ATTEMPTS:
                log.warning("job %s: failed on claim %d of at most %d (%s); "
                            "dropping it", job_id, attempts, MAX_ATTEMPTS, why)
                spent.append(job_id)
        return spent

    def _process_claimed(self, claimed: list[tuple[int, str, int]]) -> None:
        by_task: dict[str, list[tuple[int, AlignJob, int]]] = defaultdict(list)
        poison: list[int] = []
        for job_id, payload, attempts in claimed:
            if attempts > MAX_ATTEMPTS:
                # its earlier holders never committed it (they died
                # mid-batch): a job that kills its worker is dropped too
                log.warning("job %s: claimed %d times without a commit; "
                            "dropping it", job_id, attempts)
                poison.append(job_id)
                continue
            try:
                job = AlignJob.from_json(payload)
            except Exception:
                # a malformed payload would otherwise be redelivered
                # forever (the reference node just panics, node/main.rs:61)
                log.warning("dropping undecodable job %s", job_id)
                poison.append(job_id)
                continue
            by_task[job.hash].append((job_id, job, attempts))
        self.queue.commit(poison)

        for hash_, items in by_task.items():
            jobs = [j for _, j, _ in items]
            ref = jobs[0]
            t0 = time.perf_counter()
            try:
                # batch prep sits INSIDE the try: a decodable job with a
                # missing/ragged matrix raises from np.stack and must be
                # poison-handled, not crash-loop the whole fleet
                mats = np.stack([j.matrix for j in jobs])
                heur = Heuristics(
                    kd=ref.kd_value, r_squared=ref.r_squared_value,
                    frequencies=ref.frequences,
                )
                results = heuristic_align_population(
                    Protein.encode(ref.sequence_1, strict=False),
                    Protein.encode(ref.sequence_2, strict=False),
                    mats, ref.del_value, ref.del_value, heur,
                    device=self.device,
                )
            except Exception as e:
                if self._own_fault(e):
                    # the worker cannot compute: stop it rather than spend
                    # every job's attempts; the batch's leases expire and
                    # another worker takes it
                    raise
                if is_data_error(e):
                    # deterministic per-task failures (a dim/frequency
                    # combination the heuristic math rejects, a malformed
                    # matrix payload) can never succeed on redelivery —
                    # commit the jobs away like poison
                    log.warning(
                        "task %s: heuristic population failed (%s: %s); "
                        "dropping its %d jobs", hash_, type(e).__name__, e,
                        len(items),
                    )
                    self.queue.commit([job_id for job_id, _, _ in items])
                else:
                    # anything else (a flaky host) is presumed transient:
                    # the jobs stay claimed so lease expiry redelivers
                    # them, up to MAX_ATTEMPTS claims
                    log.warning(
                        "task %s: transient failure (%s: %s); leaving its "
                        "%d jobs for lease-expiry redelivery", hash_,
                        type(e).__name__, e, len(items),
                    )
                    self.queue.commit(self._spent(items, type(e).__name__))
                continue
            log.info("task %s: population of %d job(s) in %.6f s", hash_,
                     len(items), time.perf_counter() - t0)
            done_ids = []
            for (job_id, _, attempts), res in zip(items, results):
                if res is None:
                    # this candidate matrix admits no alignment (see
                    # heuristic_align_population); retrying can never
                    # succeed, so commit the job away instead of
                    # redelivering it forever (the reference node would
                    # panic and lose the message the same way)
                    log.warning(
                        "job %s: matrix admits no alignment; dropping",
                        job_id,
                    )
                    done_ids.append(job_id)
                    continue
                qa, ta = res.alignment.render()
                # source_key = queue job id: a lease-expiry redelivery of
                # this job (crash between store and commit) re-inserts
                # idempotently instead of duplicating the subtask
                try:
                    self.store.insert_align_subtask(
                        hash_, res.alignment.f, res.matrix, qa, ta,
                        source_key=str(job_id),
                    )
                except Exception:
                    # one retry on a fresh connection (node/main.rs:78-88)
                    time.sleep(0.05)
                    try:
                        self.store.insert_align_subtask(
                            hash_, res.alignment.f, res.matrix, qa, ta,
                            source_key=str(job_id),
                        )
                    except Exception as e:
                        # stays claimed → redelivered on lease expiry,
                        # up to MAX_ATTEMPTS claims
                        done_ids += self._spent([(job_id, None, attempts)],
                                                type(e).__name__)
                        continue
                done_ids.append(job_id)
            self.queue.commit(done_ids)

    def run_forever(self, poll_interval: float = 0.5,
                    max_batches: int | None = None, warmup: bool = False):
        n = 0
        try:
            if warmup:
                try:
                    self.warmup()
                except Exception as e:
                    if self._own_fault(e):
                        raise
                    log.warning("warmup failed; continuing cold", exc_info=True)
            while max_batches is None or n < max_batches:
                handled = self.process_batch()
                if handled == 0:
                    time.sleep(poll_interval)
                n += 1
        finally:
            # clean shutdown (bounded run, SIGINT): drop our consumer
            # row so /health/check doesn't report a dead node for an
            # hour after every routine restart.  A crash skips this and
            # stays visible — that's the intended crash signal.
            try:
                self.queue.deregister_consumer(self.name)
            except Exception:
                pass  # shutdown must not fail on a dead state endpoint


def main(argv=None):
    import argparse

    from ..observability import configure_logging

    ap = argparse.ArgumentParser(prog="aligner-torch-node", description=__doc__)
    ap.add_argument("--name", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda: the kernels (raises without a card); "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--poll-interval", type=float, default=0.5)
    ap.add_argument("--max-batches", type=int, default=None,
                    help="exit after N poll cycles (tests/bounded runs)")
    ap.add_argument("--warmup", action="store_true",
                    help="get the kernels ready against pending job "
                         "shapes before claiming any lease")
    args = ap.parse_args(argv)
    configure_logging()
    Worker(name=args.name, batch=args.batch, device=args.device).run_forever(
        poll_interval=args.poll_interval, max_batches=args.max_batches,
        warmup=args.warmup,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
