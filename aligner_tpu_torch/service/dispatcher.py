"""Dispatcher HTTP API (aligner-web/src/bin/dispatcher/).

Routes (filters.rs:5-49):
* ``GET /health/check``  → consumer-group membership as
  ``{"nodes": [{"consumerName", "status"}]}``
* ``POST /validate``     → parse FASTA (≥2 records), all-pairs task
  creation (hash-deduplicated), fan one job per candidate matrix into the
  queue; responds ``{"hashes": [...]}`` or a localized error message
  (handlers.rs:73-148 — the Russian strings are part of the API surface
  and kept verbatim).
* ``GET /progress?hashes=h1,h2`` → 1 Hz SSE of per-hash percentages; at
  100% promotes the best subtask and deletes the rest
  (handlers.rs:151-181).

Fixed reference bugs (documented divergences):
* every pair ships its *own* sequences — the reference always shipped
  ``seqs[0], seqs[1]`` regardless of the pair (handlers.rs:127);
* symbol frequencies are indexed by symbol code — the reference filled
  ``freqs[i]`` in HashMap iteration order, i.e. nondeterministically
  (handlers.rs:209-224).

The port's copy of ``aligner_tpu/service/dispatcher.py``: the routes,
replies and messages are the same byte for byte.
"""

from __future__ import annotations

import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("aligner_tpu_torch.dispatcher")

import numpy as np

from ..alphabet import Protein
from ..errors import ValidationError
from ..io import read_fasta
from .models import AlignJob, AlignJobRequest, task_hash
from .queue import JobQueue, open_queue
from .store import Store, open_store, get_population

TOPIC_JOBS = "aligner.jobs"
GROUP = "aligner.jobs.group"

MSG_BAD_FASTA = "Ошибка при обработке данных. Проверьте входные последовательности."
MSG_TOO_FEW = "Передано отличное от число последовательностей меньше двух."
MSG_NO_NEW = "Ошибка при создании запроса. Не было передано новых задач на выравнивание."
MSG_PROGRESS = "Выравнивание вычисляется"


def generate_pairs(records):
    """All unordered pairs, in order (handlers.rs:253-264)."""
    out = []
    for i, rec in enumerate(records):
        for other in records[i + 1 :]:
            out.append((rec, other))
    return out


def symbol_frequencies(seq1: str, seq2: str, dim: int) -> np.ndarray:
    """Per-code symbol frequencies over both sequences (deterministic
    replacement for handlers.rs:209-224).  Normalized by the RAW
    concatenated length — codes >= dim and skipped characters dilute
    the frequencies exactly as the reference's char-count/total does."""
    enc = Protein.encode(seq1 + seq2, strict=False)
    kept = enc[enc < dim].astype(np.int64)
    counts = np.bincount(kept, minlength=dim).astype(np.float64)[:dim]
    return counts / max(len(seq1) + len(seq2), 1)


class Dispatcher:
    def __init__(self, store: Store | None = None, queue: JobQueue | None = None,
                 rng: np.random.Generator | None = None):
        self.store = store or open_store()
        self.queue = queue or open_queue()
        self.rng = rng or np.random.default_rng()

    # --- handlers ---

    def health_check(self) -> dict:
        """Same wire shape as the reference ({consumerName, status},
        handlers.rs:32-70) but ``status`` reflects actual liveness (the
        reference's Kafka metadata only lists live members, so its
        hardcoded ``true`` means the same thing); stale consumers appear
        with ``status: false``, plus additive detail fields."""
        nodes = [
            {
                "consumerName": s["name"],
                "status": s["alive"],
                "lastSeenAgeSec": round(s["last_seen_age"], 3),
                "claimedJobs": s["claimed"],
            }
            for s in self.queue.group_member_stats(GROUP)
        ]
        return {"nodes": nodes}

    def validate(self, body: dict) -> tuple[int, dict]:
        try:
            req = AlignJobRequest.from_json(body)
        except ValidationError:
            return 400, {"message": MSG_BAD_FASTA}
        try:
            records = read_fasta(req.sequences)
        except ValidationError:
            return 400, {"message": MSG_BAD_FASTA}
        if len(records) < 2:
            return 400, {"message": MSG_TOO_FEW}

        # ONE population for the whole request: the (dim, volume) args
        # are identical for every pair, and with a remote store each
        # get_population is a full RPC shipping every candidate matrix —
        # per-pair re-fetching did 189 redundant transfers on a
        # 20-record FASTA
        matrices = get_population(
            self.store, req.dim_value, req.matrices_volume_value, self.rng
        )
        hashes = []
        for query, target in generate_pairs(records):
            qseq, tseq = query.seq.decode(), target.seq.decode()
            h = task_hash(
                qseq, tseq, req.kd_value, req.r_squared_value, req.del_value,
                req.dim_value, req.matrices_volume_value,
            )
            try:
                # store the first-token record id (not the full header):
                # identifier-based lookups (blast_cmp) key on the id
                self.store.insert_align_task(
                    req, h, query.id, qseq, target.id, tseq
                )
            except ValidationError:
                continue  # duplicate hash — skip (handlers.rs:118-121)
            hashes.append(h)
            self.spawn_jobs(qseq, tseq, req, h, matrices)

        if not hashes:
            return 500, {"message": MSG_NO_NEW}
        return 200, {"hashes": hashes}

    def spawn_jobs(self, seq1: str, seq2: str, req: AlignJobRequest,
                   hash_: str, matrices=None):
        """One queued job per candidate matrix (handlers.rs:193-251)."""
        if matrices is None:
            matrices = get_population(
                self.store, req.dim_value, req.matrices_volume_value, self.rng
            )
        freqs = symbol_frequencies(seq1, seq2, req.dim_value)
        for matrix in matrices:
            job = AlignJob(
                sequence_1=seq1, sequence_2=seq2, matrix=matrix,
                frequences=freqs, kd_value=req.kd_value,
                r_squared_value=req.r_squared_value, del_value=req.del_value,
                matrices_volume_value=req.matrices_volume_value, hash=hash_,
            )
            self.queue.produce(TOPIC_JOBS, job.to_json(), GROUP)

    def progress_snapshot(self, hashes: list[str]) -> dict:
        percentages = {}
        for h in hashes:
            pct = self.store.get_percentage_by_hash(h)
            # >= (not ==): a duplicate subtask overshooting the count
            # must still promote, never deadlock (handlers.rs:165-172's
            # == gate relies on Kafka duplicates being rare)
            if pct >= 100.0 - 1e-9:
                self.store.promote_if_complete(h)
            # promoted tasks have no subtask rows left, so the raw count
            # reads 0 — report DONE as 100 (the reference would show 0
            # for a finished task on any later query, queries.rs:67-72)
            if self.store.get_status_by_hash(h) == "DONE":
                pct = 100.0
            percentages[h] = min(pct, 100.0)
        return {"progress": percentages, "message": MSG_PROGRESS}


def make_handler(dispatcher: Dispatcher, sse_ticks: int | None = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/health/check":
                self._json(200, dispatcher.health_check())
            elif url.path == "/progress":
                qs = parse_qs(url.query)
                hashes = []
                for v in qs.get("hashes", []):
                    hashes.extend(x for x in v.split(",") if x)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                ticks = 0
                try:
                    while sse_ticks is None or ticks < sse_ticks:
                        snap = dispatcher.progress_snapshot(hashes)
                        self.wfile.write(
                            f"data: {json.dumps(snap)}\n\n".encode()
                        )
                        self.wfile.flush()
                        ticks += 1
                        if sse_ticks is not None and ticks >= sse_ticks:
                            break
                        time.sleep(1.0)  # 1 Hz (handlers.rs:152)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._json(404, {"message": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/validate":
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"message": MSG_BAD_FASTA})
                    return
                try:
                    code, obj = dispatcher.validate(body)
                except Exception as e:  # noqa: BLE001 — a failed request
                    # must still get a JSON reply, not a dropped
                    # connection (and the log, not the client, gets the
                    # traceback)
                    log.exception("validate failed")
                    code, obj = 500, {
                        "message": f"internal error: {type(e).__name__}"
                    }
                self._json(code, obj)
            else:
                self._json(404, {"message": "not found"})

    return Handler


def serve(host: str = "127.0.0.1", port: int = 3030,
          dispatcher: Dispatcher | None = None, sse_ticks: int | None = None):
    """Run the dispatcher (warp bound 127.0.0.1:3030, dispatcher/main.rs:28)."""
    dispatcher = dispatcher or Dispatcher()
    server = ThreadingHTTPServer((host, port), make_handler(dispatcher, sse_ticks))
    return server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="aligner-torch-dispatcher", description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=3030)
    args = ap.parse_args(argv)
    server = serve(args.host, args.port)
    print(f"dispatcher listening on {args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    main()
