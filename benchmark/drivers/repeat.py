"""One latent-repeat search of a chromosome a request: one client sends the
pool's chromosomes in turn, in the seed's order, each to
``aligner_tpu_torch.repeat.engine.run_exploring_cmd`` (``aligner-repeat-search``'s
exploring mode without its argument parsing and output files) as a
one-record FASTA file that set-up writes, with the configuration's options,
no checkpoint and no reverse pass, on the card.  Each request draws its
starting PWM and its shuffle from a generator seed of its own, made from
the run's seed and the request's number.

The pool: ``pool.chromosomes`` records of ``chromosome.bases`` bases, the
i-th from the fixed seed ``pool.seed + i``: uniform over ATCG, with
``pool.planted`` copies of one ``pool.planted_length``-base query at
regular offsets, every ``pool.mutated_every``-th base of copy k redrawn
from phase k mod ``mutated_every`` (``make_chromosome``, after the former
``chip_smoke.make_chromosome``, in git at e76b081).

A request's ``cells`` is the reference's work: each window's length × W,
summed over the windows, times the scans the request ran (the starting
scan and each cycle's); the program's second pass on the survivors is not
counted.

Answers checked: ``check_requests`` requests picked by the seed, each
searched again, whole, by :func:`reference.repeat.search`: every task's
left, right, z and f and every entry of the final PWM bit for bit, and the
number of scans.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile

import numpy as np

from harness import roofline_repeat, traffic
from reference.repeat import Options, search, windows

LETTERS = np.frombuffer(b"ATCG", np.uint8)
HEAD = "chromosome"


@dataclasses.dataclass
class State:
    pool: list  # bytes of each chromosome
    fastas: list  # a one-record FASTA file of each
    order: np.ndarray  # pool indices in the seed's order
    opts: Options
    cells_per_scan: int
    seed: int
    device: object
    program: object = None  # the program's SearchOptions, made by set-up


def make_chromosome(bases: int, seed: int, planted: int, planted_length: int,
                    mutated_every: int) -> bytes:
    """Uniform bases with ``planted`` mutated copies of one query at regular
    offsets (the testing mode's construction, cmd/testing.rs:52-57, scaled
    up; the mutation of engine/mod.rs:17-47)."""
    rng = np.random.default_rng(seed)
    seq = LETTERS[rng.integers(0, 4, bases)]
    query = LETTERS[rng.integers(0, 4, planted_length)]
    stride = bases // (planted + 1)
    for k in range(planted):
        copy = query.copy()
        idx = np.arange(k % mutated_every, len(copy), mutated_every)
        copy[idx] = LETTERS[rng.integers(0, 4, len(idx))]
        pos = (k + 1) * stride
        seq[pos:pos + len(copy)] = copy[:max(0, bases - pos)]
    return seq.tobytes()


def options(cfg: dict) -> Options:
    o = cfg["options"]
    return Options(int(o["repeat_length"]), int(o["query_offset"]), float(o["deletions"]),
                   float(o["extension"]), int(o["repeats"]))


def program_options(cfg: dict, device):
    """The program's ``SearchOptions`` for the configuration: exploring mode,
    forward strand, on ``device`` (``"cuda"`` on the card)."""
    from aligner_tpu_torch.repeat.engine import SearchOptions

    o = cfg["options"]
    dev = "cuda" if device.type == "cuda" else str(device)
    return SearchOptions(repeat_length=int(o["repeat_length"]),
                         query_offset=int(o["query_offset"]), deletions=float(o["deletions"]),
                         extension=float(o["extension"]), rsquared=float(o["rsquared"]),
                         kd=float(o["kd"]), threads=int(o["threads"]), repeats=int(o["repeats"]),
                         reverse=False, device=dev)


def request_seed(seed: int, i: int) -> int:
    """Request ``i``'s generator seed, from the run's seed."""
    return int(traffic.rng_for(seed, 31, i).integers(0, 2**63))


def inputs(run) -> State:
    cfg = run.config
    pool, bases = cfg["pool"], int(cfg["chromosome"]["bases"])
    chroms = [make_chromosome(bases, int(pool["seed"]) + k, int(pool["planted"]),
                              int(pool["planted_length"]), int(pool["mutated_every"]))
              for k in range(int(pool["chromosomes"]))]
    opts = options(cfg)
    starts, ends = windows(bases, opts)
    order = traffic.rng_for(run.seed, 30).permutation(len(chroms))
    return State(chroms, [], order, opts, int((ends - starts).sum()) * opts.width, run.seed,
                 run.device)


def write_fasta(path: str, raw: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(f">{HEAD}\n".encode())
        for lo in range(0, len(raw), 80):
            fh.write(raw[lo:lo + 80] + b"\n")


def setup(run) -> State:
    from aligner_tpu_torch.observability import counters
    from aligner_tpu_torch.repeat import engine

    if "scans" not in {f.name for f in dataclasses.fields(engine.TaskResult)}:
        raise RuntimeError("the program's repeat search does not report its scans "
                           "(TaskResult.scans)")
    st = inputs(run)
    st.program = program_options(run.config, run.device)
    tmp = tempfile.mkdtemp(prefix="bench_repeat_")
    atexit.register(shutil.rmtree, tmp, True)
    for k, raw in enumerate(st.pool):
        st.fastas.append(os.path.join(tmp, f"chromosome{k}.fasta"))
        write_fasta(st.fastas[-1], raw)
    # every kernel and plan of the window: the scans, the survivors' pass
    # with directions and its walk, on the traffic's prefix of the first
    # chromosome with its fixed generator seed (the same work in every run)
    warm = run.traffic["warm_up"]
    path = os.path.join(tmp, "warm.fasta")
    write_fasta(path, st.pool[0][:int(warm["bases"])])
    engine.run_exploring_cmd(st.program, path, np.random.default_rng(int(warm["seed"])))
    counters.reset()
    return st


def pool_of(st: State, i: int) -> int:
    """Request ``i``'s chromosome: the pool's in the seed's order, in turn."""
    return int(st.order[i % len(st.order)])


def request(st: State, i: int) -> dict:
    from aligner_tpu_torch.repeat import engine

    k = pool_of(st, i)
    gen = request_seed(st.seed, i)
    (res,) = engine.run_exploring_cmd(st.program, st.fastas[k],
                                      np.random.default_rng(gen)).values()
    return {"pool": k, "gen": gen, "scans": res.scans, "cells": res.scans * st.cells_per_scan,
            "tasks": [(t.left_coord, t.right_coord, t.z, t.f) for t in res.tasks],
            "matrix": np.array(res.matrix, np.float64)}


def spans(st: State) -> list:
    eng = "aligner_tpu_torch.repeat.engine"
    return [(eng, "calculate_starting_values", "repeat.start"),
            (eng, "calculate_cycle", "repeat.cycle"),
            (eng, "_filter", "repeat.filter")]


def counters(st: State) -> dict:
    from aligner_tpu_torch.observability import counters as c

    return {k: dataclasses.asdict(v) for k, v in c.snapshot().items()}


def _bits(v: float) -> bytes:
    return np.float64(v).tobytes()


def wrong(rec: dict, want) -> tuple[int, int, int]:
    """(tasks_wrong, matrix_wrong, scans_wrong) of an answer ``rec`` against
    the reference's ``want``: the tasks whose right end, z or f differ from
    the reference's task with the same left end, bit for bit, and the tasks
    one side has and the other lacks; the PWM's entries that differ, bit
    for bit; the scans' difference."""
    got = {int(t[0]): t for t in rec["tasks"]}
    ref = {int(t[0]): t for t in want.tasks}
    tasks = len(got.keys() ^ ref.keys())
    tasks += abs(len(rec["tasks"]) - len(got)) + abs(len(want.tasks) - len(ref))
    for left in got.keys() & ref.keys():
        a, b = got[left], ref[left]
        tasks += (int(a[1]) != int(b[1]) or _bits(a[2]) != _bits(b[2])
                  or _bits(a[3]) != _bits(b[3]))
    m, w = np.asarray(rec["matrix"], np.float64), np.asarray(want.matrix, np.float64)
    matrix = (int(np.count_nonzero(m.view(np.int64) != w.view(np.int64)))
              if m.shape == w.shape else max(m.size, w.size))
    return tasks, matrix, abs(int(rec["scans"]) - int(want.scans))


def reference(st: State, k: int, gen: int, **kw):
    return search(st.pool[k], st.opts, gen, device=st.device, **kw)


def _checks(counts) -> list:
    return [("tasks_wrong", counts[0], 0), ("matrix_wrong", counts[1], 0),
            ("scans_wrong", counts[2], 0)]


def check(st: State, run) -> list:
    done = run.done()
    work(st, run)
    if not done:
        return [("requests_answered", 0, -1)]
    rng = traffic.rng_for(run.seed, 9)
    n = max(1, min(int(run.traffic["check_requests"]), len(done)))
    total = [0, 0, 0]
    for j in rng.choice(len(done), size=n, replace=False):
        r = done[int(j)]
        for a, v in enumerate(wrong(r, reference(st, r["pool"], r["gen"]))):
            total[a] += v
    return _checks(total)


def work(st: State, run) -> None:
    """The window's scans' bound (``scan_s``): each answered request's scans
    of every window."""
    starts, ends = windows(len(st.pool[0]), st.opts)
    one = roofline_repeat.fill(len(starts), int((ends - starts).sum()), st.opts.width,
                               dirs=False)
    run.work["scan_s"] = one * sum(int(r["scans"]) for r in run.done())


def control(st: State, run, dtype) -> list:
    """The reference with its fills in ``dtype`` in the program's place, on
    the window's first request."""
    k, gen = pool_of(st, 0), request_seed(st.seed, 0)
    low = reference(st, k, gen, dtype=dtype)
    rec = {"tasks": low.tasks, "matrix": low.matrix, "scans": low.scans}
    return _checks(wrong(rec, reference(st, k, gen)))
