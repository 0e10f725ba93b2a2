"""Latent-repeat-search engine.

Counterpart of ``aligner_tpu/repeat/engine.py`` (itself a faithful
re-architecture of aligner-core/src/bin/latent-repeat-search/engine/):
the thread fan-outs over windows (calc.rs:45-75, 105-144) become batched
device launches — a scores-only PWM fill over every window, gathered on
the device from the device-resident sequence, then a full-alignment pass
over only the z-filtered survivors that the overlap filter keeps (whose
frequency matrices feed the next cycle's matrix).

Replicated behavior details:

* window enumeration: thread i starts at ``i*query_offset`` and steps by
  ``step*threads``; ``step`` is ``len/1000`` for the simple-init starting
  scan, else ``query_offset`` (calc.rs:37-41,56,114); window end clips at
  the sequence end when ``j + repeat_length + query_offset >= length``;
* starting stats use the std *with* sqrt (calc.rs:78-86), cycle updates
  use the variance as σ — the reference's missing-sqrt quirk
  (calc.rs:197-202);
* z threshold 3.0 (calc.rs:17), applied ``z >= Z``;
* the overlap filter is transcribed statement-for-statement from
  engine/mod.rs:49-102, including its non-transitive intersection check
  against the batch's first task and the possible re-processing of the
  final task when a batch extends to the end of the list;
* cycle loop: break on an empty scan keeping the previous tasks; matrix
  re-derivation only when another cycle follows (calc.rs:182-219);
  kd=0, r² = del*ext for every transform in exploring mode
  (calc.rs:156-164,209-215);
* reversed pass: one extra cycle on the reversed compacted sequence with
  rotated indices, reusing the final mean/std/matrix (calc.rs:223-238).

Spans (:func:`aligner_tpu_torch.observability.span`, recorded under
``torch.profiler`` only), nested as a record's search opens them:
``repeat`` [scans, windows, survivors] (one record of
:func:`perform_calculation_per_sequence`: the scans run, the windows they
scanned and the windows that passed z >= 3) holds ``repeat.start`` (the
PWM's draw, the shuffle and the starting scan) and one ``repeat.cycle``
[windows, survivors, kept] a cycle (and one for the reversed pass); a
scan is ``repeat.scan`` [windows, cells, chunks] (:func:`_scan_scores`),
the overlap filter of the survivors' tasks ``repeat.filter`` [tasks_in,
tasks_out], the full pass over the tasks it keeps ``repeat.survivors``
[windows, cells] and the next PWM (the frequency sum and the transform)
``repeat.matrix``.

The PWMs here come from ``transform_matrix`` and are not integral, so
every fill runs in float64 (``backend.dtype_for``), the reference's own
precision: one f32 rounding could move a window across the hard z
threshold and change every later cycle.  Checkpoints are the JAX
package's JSON, so a scan checkpointed by either package resumes in the
other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from ..align import _auto_shard_devices, _engine_name, batch_align_pwm
from ..alphabet import DNA, Index, index_coord, rotate_indices
from ..backend import dtype_for, resolve_device
from ..heuristic import Heuristics, heuristic_align_pwm
from ..io import read_fasta_file, read_records
from ..io.fasta import mask_intervals
from ..matrices import random_pwm, transform_matrix
from ..observability import count, log, measure, span
from ..ops.dp_fill import PWMFill
from ..ops.scan_engine import round8
from ..result import PWMAlignment, frequency_sum
from ..service.models import matrix_from_json, matrix_to_serde_dict

Z = 3.0
TEST_SEQUENCE_LENGTH = 100_000
DESCENDANTS_AMOUNT = 10
# windows per device launch; results do not depend on it.  Chosen by
# measurement on the H100 (PERF.md, the chunk-size finding).
SCAN_CHUNK = 65_536


@dataclasses.dataclass
class Task:
    """A candidate repeat site (engine/task.rs:4-10)."""

    alignment: PWMAlignment | None
    left_coord: int
    right_coord: int
    z: float
    f: float


@dataclasses.dataclass
class TaskResult:
    tasks: list[Task]
    matrix: np.ndarray
    # the scans this call ran for the result: the starting scan and each
    # cycle's (an empty one that ended the loop included); 0 for a result
    # replayed from a completed checkpoint
    scans: int = 0


@dataclasses.dataclass
class SearchOptions:
    """CLI options (latent-repeat-search/args.rs:5-44 defaults)."""

    repeat_length: int = 300
    query_offset: int = 30
    deletions: float = 30.0
    extension: float = 7.0
    rsquared: float = 100_000.0
    kd: float = 0.0
    threads: int = 1
    repeats: int = 10
    simple_init: bool = False
    reverse: bool = False
    device: str | None = None


def windows_of(length: int, opts: SearchOptions, step: int) -> list[tuple[int, int]]:
    """The exact window set of the reference's thread fan-out, as
    (start, border) pairs (:func:`_windows` as a list)."""
    return [(j, border) for j, border in _windows(length, opts, step).tolist()]


def _windows(length: int, opts: SearchOptions, step: int) -> np.ndarray:
    """The exact window set of the reference's thread fan-out, an (n, 2)
    int64 array of (start, border) rows.

    Thread i yields ``j = i*query_offset, i*query_offset + step*threads,
    ...`` (calc.rs:56,114); results arrive over an mpsc channel in
    nondeterministic order, so order here (thread-major) is as good as
    the reference's.  A window's border is ``j + repeat_length +
    query_offset``, or ``length`` where that reaches it.
    """
    stride = max(step * opts.threads, 1)
    starts = np.concatenate([
        np.arange(i * opts.query_offset, length, stride, dtype=np.int64)
        for i in range(opts.threads)
    ])
    far = starts + opts.repeat_length + opts.query_offset
    return np.stack([starts, np.where(far >= length, length, far)], axis=1)


def _scan_scores(
    seq: np.ndarray, wins, matrix: np.ndarray,
    opts: SearchOptions, chunk: int = SCAN_CHUNK,
) -> np.ndarray:
    """Scores-only PWM alignment of every window, ``chunk`` windows per
    launch.  The sequence goes to the device once; each chunk's windows
    are gathered there from it, straight into the kernel's (R8, B) row
    layout and masked by the window length (the counterpart of the JAX
    package's ``_scan_chunk_gather_impl``).

    With several shards (:func:`aligner_tpu_torch.align._auto_shard_devices`,
    for more than one window) each device gets the sequence once and each
    shard gathers and fills its contiguous share of every chunk on its
    device; no score is read before the last chunk is launched.  These are
    the windows the JAX package sends through its sharded
    ``batch_align_pwm``, with the same scores, without building the window
    slices on the host.  ``wins``: (start, border) pairs, a list or an
    (n, 2) array (:func:`_windows`)."""
    fs = np.empty(len(wins), dtype=np.float64)
    if not len(wins):
        return fs
    device = resolve_device(opts.device)
    devices = _auto_shard_devices(device) if len(wins) > 1 else [device]
    starts, borders = np.asarray(wins, dtype=np.int64).T
    dtype = dtype_for(device, matrix, opts.deletions, opts.extension,
                      lengths=(int((borders - starts).max()), matrix.shape[-1]))
    cells = int((borders - starts).sum()) * int(matrix.shape[-1])
    R8 = round8(int((borders - starts).max()))
    with span("repeat.scan", windows=len(wins), cells=cells, chunks=-(-len(wins) // chunk)):
        state = {}  # per device: the scoring state, the sequence, the windows, the scores
        for dev in devices:
            if dev not in state:
                state[dev] = (
                    PWMFill.from_numpy(matrix, opts.deletions, opts.extension, device=dev,
                                       dtype=dtype),
                    torch.as_tensor(np.asarray(seq, np.int32), device=dev),
                    torch.as_tensor(starts, device=dev),
                    torch.as_tensor((borders - starts).astype(np.int32), device=dev),
                    torch.arange(R8, device=dev)[:, None],
                    torch.empty(len(wins), dtype=torch.float64, device=dev), [])
        with measure(_engine_name(device, devices, "pwm-scan"), cells, len(wins),
                     device=devices):
            for lo in range(0, len(wins), chunk):
                hi = min(lo + chunk, len(wins))
                per = -(-(hi - lo) // len(devices))
                for k, dev in enumerate(devices):
                    a, b = min(lo + k * per, hi), min(lo + (k + 1) * per, hi)
                    if a == b:
                        continue
                    dp, seq_dev, starts_dev, qlen_dev, rows, out, spans = state[dev]
                    ql = qlen_dev[a:b]
                    idx = (starts_dev[None, a:b] + rows).clamp_(max=len(seq) - 1)
                    qT = torch.where(rows < ql[None, :], seq_dev[idx], 0)  # (R8, B)
                    # only f feeds the mean/std and z-filter (calc.rs:72-86,
                    # 139-144): no per-cell argmax bookkeeping
                    out[a:b] = dp(qT.T, ql, track_argmax=False).fmax
                    spans.append((a, b))
        for *_, out, spans in state.values():
            host = out.cpu().numpy()
            for a, b in spans:
                fs[a:b] = host[a:b]
    return fs


def calculate_starting_values(
    seq: np.ndarray, matrix: np.ndarray, opts: SearchOptions,
    rng: np.random.Generator,
) -> tuple[float, float]:
    """Mean/std of window scores over the shuffled sequence
    (calc.rs:19-86)."""
    shuffled = np.array(seq)
    rng.shuffle(shuffled)
    step = len(seq) // 1000 if opts.simple_init else opts.query_offset
    wins = _windows(len(seq), opts, step)
    fs = _scan_scores(shuffled, wins, matrix, opts)
    count(windows=len(wins))
    mean = float(fs.mean())
    std = float(np.sqrt(((fs - mean) ** 2).mean()))
    return mean, std


def calculate_cycle(
    seq: np.ndarray,
    matrix: np.ndarray,
    indices: list[Index],
    mean: float,
    std: float,
    opts: SearchOptions,
    select=None,
) -> list[Task]:
    """One scan over the real sequence; keep windows with z >= 3
    (calc.rs:88-147), and of their tasks the positions that
    ``select(left, right, z)`` returns (every one without it; a record's
    search passes the overlap filter).  Tasks and their alignments (needed
    for frequency matrices) are made for those alone, the alignments in a
    second full-mode pass: at the reference's defaults a cycle can keep
    nearly every window of a chromosome, of which the filter keeps about one
    in twelve, and the filter reads coordinates and z alone.
    """
    wins = _windows(len(seq), opts, opts.query_offset)
    fs = _scan_scores(seq, wins, matrix, opts)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (fs - mean) / std  # std may be 0 — inf/nan matches the reference
    keep = np.flatnonzero(z >= Z)
    log.info("repeat scan: %d windows, %d survivors", len(wins), len(keep))
    count(windows=len(wins), survivors=len(keep))
    left = _coords(wins[keep, 0], indices)
    right = _coords(wins[keep, 1], indices)
    zs, f = z[keep].tolist(), fs[keep].tolist()
    chosen = range(len(keep)) if select is None or not len(keep) else select(left, right, zs)
    tasks = [Task(None, left[k], right[k], zs[k], f[k]) for k in chosen]
    bounds = wins[keep[list(chosen)]].tolist()
    cells = sum(b - a for a, b in bounds) * int(matrix.shape[-1])
    with span("repeat.survivors", windows=len(tasks), cells=cells):
        for lo in range(0, len(tasks), SCAN_CHUNK):
            full = batch_align_pwm(
                [seq[a:b] for a, b in bounds[lo : lo + SCAN_CHUNK]], matrix,
                opts.deletions, opts.extension, device=opts.device,
                with_alignments=True,
            )
            for task, res in zip(tasks[lo : lo + SCAN_CHUNK], full):
                task.alignment = res.alignment
    return tasks


def _coords(values: np.ndarray, indices: list[Index]) -> list[int]:
    """:func:`index_coord` of each compacted coordinate (the coordinates
    themselves where the record skipped no character)."""
    values = values.tolist()
    return [index_coord(v, indices) for v in values] if indices else values


def _check_intersection(c1: tuple[int, int], c2: tuple[int, int]) -> bool:
    """engine/mod.rs:104-119 (verbatim, including the duplicated first
    clause)."""
    if c2[0] <= c1[0] <= c2[1]:
        return True
    if c2[0] <= c1[1] <= c2[1]:
        return True
    if c2[0] >= c1[0] and c2[1] <= c1[1]:
        return True
    if c2[0] <= c1[0] <= c2[1]:
        return True
    return False


def filter_tasks(tasks: list[Task]) -> list[Task]:
    """Overlap de-duplication keeping max-z per batch (engine/mod.rs:49-102):
    the tasks sorted by left_coord (stably), then :func:`_overlap_filter`."""
    tasks = sorted(tasks, key=lambda t: t.left_coord)
    keep = _overlap_filter([t.left_coord for t in tasks], [t.right_coord for t in tasks],
                           [t.z for t in tasks])
    return [tasks[k] for k in keep]


def _overlap_filter(left: list[int], right: list[int], z: list[float]) -> list[int]:
    """The overlap filter (engine/mod.rs:49-102) on tasks given by their
    coordinates and z, sorted by left: the positions of the tasks it keeps,
    in order.

    Statement-for-statement port: batches grow while tasks intersect the
    batch's *first* task; when a batch runs to the end of the list the
    final task is revisited and re-added unless one with the same
    left_coord is already in the result (Task PartialEq, task.rs:12-16).
    The reference's shrinking list is ``tasks[pos:]``: an offset stands in
    for its slices, which copy the rest of the list at every batch and
    make the filter quadratic (77 s on the host CPU of an H100 machine
    for the 333,228 tasks that the second cycle of a 10 Mb scan at the
    reference defaults keeps).  The tasks are plain lists, so that a cycle
    builds a ``Task`` only for those it keeps.
    """
    n = len(left)
    result: list[int] = []
    kept_left: set[int] = set()
    pos = 0
    while pos < n:
        if n - pos == 1:
            if left[pos] not in kept_left:
                result.append(pos)
            break

        current = (left[pos], right[pos])
        # Rust Iterator::max_by keeps the *last* maximum on ties
        # (engine/mod.rs:93-99) — `>=` while folding reproduces that
        best = pos
        index = 0
        for i in range(n - pos - 1):
            k = pos + 1 + i
            index = i
            if _check_intersection(current, (left[k], right[k])):
                if z[k] >= z[best]:
                    best = k
            else:
                break

        result.append(best)
        kept_left.add(left[best])
        pos += index + 1

    return result


def generate_descendants(
    sequence: np.ndarray, amount: int, offset: int, rng: np.random.Generator,
    volume: int = 4,
) -> list[np.ndarray]:
    """engine/mod.rs:17-31 (MutationPercent::Quarter → offset 4)."""
    return [mutate(sequence, offset, i, rng, volume) for i in range(amount)]


def mutate(
    sequence: np.ndarray, offset: int, start: int, rng: np.random.Generator,
    volume: int = 4,
) -> np.ndarray:
    """Randomize every ``offset``-th position from phase ``start``
    (engine/mod.rs:33-47)."""
    out = np.array(sequence)
    for i in range(start, len(sequence), offset):
        out[i] = rng.integers(0, volume)
    return out


def _tasks_to_json(tasks: list[Task]) -> list[dict]:
    return [
        {"left": t.left_coord, "right": t.right_coord, "z": t.z, "f": t.f}
        for t in tasks
    ]


def _tasks_from_json(items: list[dict]) -> list[Task]:
    return [
        Task(alignment=None, left_coord=t["left"], right_coord=t["right"],
             z=t["z"], f=t["f"])
        for t in items
    ]


def _input_fingerprint(raw_seq: bytes, opts: SearchOptions) -> str:
    """Digest of the exact scan input: the sequence bytes AS SCANNED
    (csv mode masks known repeats first, so the same FASTA under a
    different mask — or an edited known.csv — fingerprints differently)
    plus the options that shape the search state.  A checkpoint from a
    different input must not resume silently."""
    if isinstance(raw_seq, np.ndarray):
        # str() of a long array is the TRUNCATED repr ('[2 0 3 ... ]'):
        # two different inputs sharing edge elements would fingerprint
        # identically — hash the full buffer instead
        raw_seq = np.ascontiguousarray(raw_seq).tobytes()
    elif isinstance(raw_seq, str):
        raw_seq = raw_seq.encode("utf-8", "replace")
    elif not isinstance(raw_seq, (bytes, bytearray, memoryview)):
        raw_seq = np.asarray(raw_seq).tobytes()
    h = hashlib.sha1(raw_seq)
    h.update(
        repr((opts.repeat_length, opts.query_offset, opts.deletions,
              opts.extension, opts.rsquared, opts.kd, opts.threads,
              opts.repeats, opts.simple_init, opts.reverse)).encode()
    )
    return h.hexdigest()[:16]


def _save_checkpoint(path: str, head: str, cycle: int, mean: float,
                     std: float, matrix: np.ndarray, tasks: list[Task],
                     results: dict[str, TaskResult] | None = None,
                     fp: str | None = None):
    """Durable per-cycle state: enough to resume a long chromosome scan
    (the per-cycle analogue of the service store's subtask checkpointing,
    which the reference CLI lacks entirely).  ``results`` marks the
    record complete: resume then skips the record entirely and replays
    the stored task lists (alignments are not needed downstream — the
    CSV/JSON outputs consume only coords/z/f and the matrices)."""
    state = {
        "head": head, "fp": fp, "cycle": cycle, "mean": mean, "std": std,
        "matrix": matrix_to_serde_dict(matrix),
        "tasks": _tasks_to_json(tasks),
    }
    if results is not None:
        state["complete"] = {
            key: {"tasks": _tasks_to_json(r.tasks),
                  "matrix": matrix_to_serde_dict(r.matrix)}
            for key, r in results.items()
        }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(state, fh)
    os.replace(tmp, path)


def _load_checkpoint(path: str, head: str, fp: str | None = None):
    """Returns None (no usable checkpoint), a dict of TaskResult (record
    already complete), or a (cycle, mean, std, matrix, tasks) resume
    tuple.  ``fp`` is the current input fingerprint: state saved under a
    different fingerprint (other mask / options) is rejected — resuming
    it would silently replay results computed from a different input.  A
    legacy checkpoint with no fingerprint is accepted with a warning so
    pre-upgrade in-flight scans survive.  Matrices use the shared serde
    codec (``service/models.py``), whose reader keys on dim/data only."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            state = json.load(fh)
    except (OSError, ValueError) as e:
        log.warning(
            "checkpoint %s is unreadable (%s) — starting fresh", path, e
        )
        return None
    if not isinstance(state, dict) or state.get("head") != head:
        return None
    saved_fp = state.get("fp")
    if fp is not None and saved_fp is not None and saved_fp != fp:
        log.warning(
            "checkpoint %s was written for a different input "
            "(mask/options changed?) — starting fresh", path,
        )
        return None
    if fp is not None and saved_fp is None:
        log.warning(
            "checkpoint %s predates input fingerprinting; resuming "
            "unverified", path,
        )
    if "complete" in state:
        return {
            key: TaskResult(_tasks_from_json(r["tasks"]),
                            matrix_from_json(r["matrix"]))
            for key, r in state["complete"].items()
        }
    m = matrix_from_json(state["matrix"])
    return state["cycle"], state["mean"], state["std"], m, _tasks_from_json(
        state["tasks"]
    )


def _record_checkpoint_path(base: str, head: str) -> str:
    """Per-record checkpoint file so multi-record FASTA inputs resume
    correctly (one shared file would be clobbered by the next record).

    Falls back to the bare base path when only a shared checkpoint of
    the older single-file scheme exists for this head, so in-flight scans
    survive the path-scheme change."""
    digest = hashlib.sha1(head.encode("utf-8", "replace")).hexdigest()[:12]
    path = f"{base}.{digest}"
    if not os.path.exists(path) and os.path.exists(base):
        try:
            with open(base) as fh:
                if json.load(fh).get("head") == head:
                    return base
        except (OSError, ValueError):
            pass
    return path


def perform_calculation_per_sequence(
    opts: SearchOptions, raw_seq: bytes, head: str,
    rng: np.random.Generator,
    checkpoint: str | None = None,
) -> dict[str, TaskResult]:
    """Full per-chromosome search (calc.rs:149-241).

    ``checkpoint`` names a JSON file updated after every cycle; if it
    exists (and matches ``head``) the scan resumes from the next cycle —
    the matrix/statistics state is exact, completed cycles are not redone
    (surviving tasks reload without their alignments, which only the next
    matrix derivation consumed).
    """
    with span("repeat") as root:
        seq, freqs, indices = DNA.encode_with_freqs_and_indices(raw_seq)

        fp = _input_fingerprint(raw_seq, opts) if checkpoint else None
        resume = _load_checkpoint(checkpoint, head, fp) if checkpoint else None
        if isinstance(resume, dict):
            return resume  # record already completed in a previous run
        scans = 0
        if resume is not None:
            start_cycle, mean, std, matrix, tasks = resume
        else:
            with span("repeat.start") as sp:
                matrix = random_pwm(opts.repeat_length, rng)
                matrix = transform_matrix(
                    matrix, 0.0, opts.deletions * opts.extension, freqs
                )
                mean, std = calculate_starting_values(seq, matrix, opts, rng)
            _carry(root, sp, "windows")
            scans, start_cycle, tasks = 1, 0, []
            if checkpoint:
                # the starting scan is the expensive prelude — persist it even
                # before the first cycle completes
                _save_checkpoint(checkpoint, head, 0, mean, std, matrix,
                                 tasks, fp=fp)

        result: dict[str, TaskResult] = {}

        executed = start_cycle  # cycles whose scan actually ran (for the
        # complete-state stamp below; an empty-break scan counts — it ran)
        for i in range(start_cycle, opts.repeats):
            with span("repeat.cycle") as sp:
                new_tasks = calculate_cycle(seq, matrix, indices, mean, std, opts,
                                            select=_filter)
                _carry(root, sp, "windows", "survivors")
                executed = i + 1
                scans += 1
                if not new_tasks:
                    break
                tasks = new_tasks
                sp.count(kept=len(tasks))

                if i < opts.repeats - 1:
                    fs = np.array([t.f for t in tasks])
                    mean = float(fs.mean())
                    # reference quirk: variance used as sigma (no sqrt, calc.rs:197-202)
                    std = float(((fs - mean) ** 2).mean())
                    matrix = _next_matrix(tasks, matrix, opts, freqs)

            if checkpoint:
                _save_checkpoint(checkpoint, head, i + 1, mean, std, matrix,
                                 tasks, fp=fp)

        result["direct"] = TaskResult(tasks, matrix.copy(), scans)

        if opts.reverse:
            rev = seq[::-1].copy()
            rotated = rotate_indices(indices, len(rev))
            with span("repeat.cycle") as sp:
                kept = calculate_cycle(rev, matrix, rotated, mean, std, opts,
                                       select=_filter)
                _carry(root, sp, "windows", "survivors")
                sp.count(kept=len(kept))
            result["inverse"] = TaskResult(kept, matrix, 1)
        root.count(scans=scans + opts.reverse)

        if checkpoint:
            # the complete state's ``cycle`` records how many cycle scans
            # actually EXECUTED (early break included) — resume never reads
            # it (the results dict short-circuits), but honest throughput
            # accounting does (bench_chromosome.py)
            _save_checkpoint(
                checkpoint, head, executed, mean, std, matrix, tasks,
                results=result, fp=fp,
            )

        return result


def _carry(root, sp, *keys) -> None:
    """Add the counts ``keys`` of the closed or open span ``sp`` to
    ``root`` (nothing while no profiler records)."""
    if sp:
        root.count(**{k: sp.counts.get(k, 0) for k in keys})


def _next_matrix(tasks: list[Task], matrix: np.ndarray, opts: SearchOptions,
                 freqs: np.ndarray) -> np.ndarray:
    """The next cycle's PWM: the kept tasks' frequency matrices summed and
    transformed (calc.rs:204-215)."""
    with span("repeat.matrix"):
        out = frequency_sum([t.alignment for t in tasks])
        return transform_matrix(out, 0.0, opts.deletions * opts.extension, freqs)


def _filter(left: list[int], right: list[int], z: list[float]) -> list[int]:
    """:func:`filter_tasks` on a cycle's survivors given as lists: the
    positions it keeps."""
    with span("repeat.filter", tasks_in=len(left)) as sp:
        order = sorted(range(len(left)), key=left.__getitem__)
        keep = _overlap_filter([left[k] for k in order], [right[k] for k in order],
                               [z[k] for k in order])
        sp.count(tasks_out=len(keep))
    return [order[k] for k in keep]


# --- CLI modes (cmd/{testing,exploring,csv}.rs) ---


def run_testing_cmd(
    opts: SearchOptions, rng: np.random.Generator,
    sequence_length: int = TEST_SEQUENCE_LENGTH,
    descendants_amount: int = DESCENDANTS_AMOUNT,
) -> dict[str, TaskResult]:
    """Synthetic self-test (cmd/testing.rs): plant 10 mutated copies of a
    random query in a random chromosome and search for them.  The length
    knobs default to the reference constants (testing.rs:10-11)."""
    sequence_raw = DNA.random_seq(sequence_length, rng)
    query, freqs = DNA.random_seq_with_freqs(
        opts.repeat_length + opts.query_offset, rng
    )

    matrix = random_pwm(opts.repeat_length, rng)
    res = heuristic_align_pwm(
        query, matrix, opts.deletions, opts.extension,
        Heuristics(kd=opts.kd, r_squared=opts.rsquared, frequencies=freqs),
        device=opts.device,
    )
    matrix = res.matrix

    descendants = generate_descendants(query, descendants_amount, 4, rng)
    offset = len(sequence_raw) // (len(descendants) + 1)
    # exact reference construction (testing.rs:52-57): the first chunk is
    # reused for descendant 0
    parts = [sequence_raw[:offset]]
    for i, d in enumerate(descendants):
        parts.append(d)
        parts.append(sequence_raw[offset * i : offset * (i + 1)])
    sequence = np.concatenate(parts)

    mean, std = calculate_starting_values(sequence, matrix, opts, rng)
    tasks = calculate_cycle(sequence, matrix, [], mean, std, opts)
    return {"test": TaskResult(tasks, matrix)}


def _run_per_record(
    opts: SearchOptions, fasta_path, rng: np.random.Generator,
    checkpoint: str | None, prep_seq=None,
) -> dict[str, TaskResult]:
    """Shared per-record orchestration of exploring/csv modes: derive the
    record's checkpoint path and independent RNG stream, run the search,
    unpack direct/inverse results.  ``prep_seq(head, seq)`` transforms
    the sequence first (csv mode's known-repeat masking) — keeping ONE
    copy of the resume/rng logic so the two CLI modes cannot drift."""
    result: dict[str, TaskResult] = {}
    for rec in read_fasta_file(fasta_path):
        seq = prep_seq(rec.head, rec.seq) if prep_seq else rec.seq
        per_ckpt = (
            _record_checkpoint_path(checkpoint, rec.head) if checkpoint else None
        )
        per_seq = perform_calculation_per_sequence(
            opts, seq, rec.head, _record_rng(rng), checkpoint=per_ckpt
        )
        if "direct" in per_seq:
            result[rec.head] = per_seq["direct"]
        if "inverse" in per_seq:
            result[f"{rec.head}-reversed"] = per_seq["inverse"]
    return result


def run_exploring_cmd(
    opts: SearchOptions, fasta_path, rng: np.random.Generator,
    checkpoint: str | None = None,
) -> dict[str, TaskResult]:
    """Search every record of a FASTA file (cmd/exploring.rs)."""
    return _run_per_record(opts, fasta_path, rng, checkpoint)


def _record_rng(rng: np.random.Generator) -> np.random.Generator:
    """One independent stream per FASTA record, derived by a single
    draw from the command-level generator.  A checkpoint-resumed record
    consumes ZERO in-record draws (its scan is replayed from state), so
    sharing one stream across records would shift every later record's
    randomness depending on where a resume happened — with per-record
    streams a seeded resumed run reproduces the uninterrupted one."""
    return np.random.default_rng(int(rng.integers(0, 2**63)))


def run_csv_cmd(
    opts: SearchOptions, fasta_path, csv_path, rng: np.random.Generator,
    checkpoint: str | None = None,
) -> dict[str, TaskResult]:
    """Exploring mode with known repeats masked out (cmd/csv.rs +
    sequences.rs:33-43).  ``checkpoint`` resumes per record exactly like
    exploring mode — csv runs the same chromosome-scale scans."""
    data = read_records(csv_path)

    def mask(head, seq):
        if head in data:
            return mask_intervals(
                seq, [(r.left_coord, r.right_coord) for r in data[head]]
            )
        return seq

    return _run_per_record(opts, fasta_path, rng, checkpoint, prep_seq=mask)
