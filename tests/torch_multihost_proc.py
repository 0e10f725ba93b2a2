"""Body of one rank of the port's two-process tests
(``tests/test_torch_multihost.py`` on the CPU, ``tests/test_torch_cuda.py``
on one card), and :func:`run_ranks`, which starts them.

Run as ``python torch_multihost_proc.py <outfile> [<device> [<shards>
[<pairs>]]]`` with ``ALIGNER_COORDINATOR``, ``ALIGNER_PROCESS_ID`` and
``ALIGNER_NUM_PROCESSES`` set.  Each rank joins the gloo group
(``initialize_from_env("gloo")``), builds the global mesh over ``<shards>``
shards of its own on ``<device>`` (by default 2 on ``cpu``: with 2 ranks a
(2, 2) mesh; 1 a rank on 4 ranks gives (4, 1)), takes its
``process_span`` of seeded batches through ``shard_local_batch`` and runs
the three mesh steps on its block; the results gathered through the
layouts go to ``<outfile>.p<rank>`` as JSON.  Then it runs the
column-blocked pipeline on the mesh (:func:`wavefront_runs`) on the seeded
pairs ``<pairs>`` (JSON, by default :data:`WAVEFRONT_PAIRS`), every
engine, both walks.  Imports nothing of JAX.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from aligner_tpu_torch.matrices import blosum62
from aligner_tpu_torch.observability import counters
from aligner_tpu_torch.parallel import mesh as pm
from aligner_tpu_torch.parallel import multihost
from aligner_tpu_torch.parallel import wavefront_sp as sp

B, L = 16, 24  # the pairs of sharded_scores
UNEVEN = 15  # rows of the uneven batches
WIN_L, WIN_W = 20, 8  # windows of window_scan_step and their PWM's width
POP_B, POP_M = 6, 6  # pairs and candidate matrices of matrix_population_step
F64 = torch.float64
# (query, target, column block width or None for the module's): the
# reference's 96 x 70 pair (tests/multihost_proc.py), one column block, so
# every slot but the first has only padding; and 1,100 columns in blocks of
# 256, 5 blocks, so a slot owns several and a boundary crosses the ranks
WAVEFRONT_PAIRS = ((96, 70, None), (1100, 70, 256))
WF_TR, WF_TB = 16, 32  # rows of a forward block and of a replay tile
ENGINES = ("pallas", "band", "lax")


def inputs():
    """The seeded global batches, the same on every rank (and in the test)."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 24, (B, L)).astype(np.int32)
    t = rng.integers(0, 24, (B, L)).astype(np.int32)
    ql = rng.integers(1, L + 1, B).astype(np.int32)
    tl = rng.integers(1, L + 1, B).astype(np.int32)
    ws = rng.integers(0, 4, (UNEVEN, WIN_L)).astype(np.int32)
    wl = rng.integers(0, WIN_L + 1, UNEVEN).astype(np.int32)
    pwm = rng.normal(0.0, 2.0, (4, WIN_W))
    m = np.asarray(blosum62(), np.float64)
    mats = np.stack([m + rng.integers(-2, 3, m.shape) for _ in range(POP_M)])
    mats[4] = mats[1]  # a tie across the two matrix shards
    return dict(q=q, t=t, ql=ql, tl=tl, ws=ws, wl=wl, pwm=pwm, m=m, mats=mats)


def wavefront_pair(C: int, R: int):
    """The seeded (query, target) codes of a C x R pair."""
    rng = np.random.default_rng(C + R)
    return rng.integers(0, 24, C).astype(np.int8), rng.integers(0, 24, R).astype(np.int8)


def wavefront_runs(mesh_or_n_blocks, pairs=WAVEFRONT_PAIRS, device=None):
    """``sharded_global_end_score`` and ``sharded_global_align`` (the device
    walk, then the host walk) of each pair on every engine, BLOSUM62, del
    11, ext 2: ``{"CxR": [{"engine", "end", "alignments": [[end, qa, ta,
    coords], ...]}, ...]}``.  A pair's block width, when given, stands for
    :data:`~aligner_tpu_torch.parallel.wavefront_sp.CB_COLS` during its
    calls."""
    m = np.asarray(blosum62())
    out = {}
    saved = sp.CB_COLS
    try:
        for C, R, cb in pairs:
            sp.CB_COLS = cb or saved
            q, t = wavefront_pair(C, R)
            runs = []
            for engine in ENGINES:
                kw = dict(tr=WF_TR, engine=engine, device=device)
                end = sp.sharded_global_end_score(mesh_or_n_blocks, q, t, m, 11, 2, **kw)
                alns = [sp.sharded_global_align(mesh_or_n_blocks, q, t, m, 11, 2,
                                                tb_rows=WF_TB, walk=walk, **kw)
                        for walk in ("device", "host")]
                runs.append(dict(engine=engine, end=end, alignments=[
                    [e, qa.tolist(), ta.tolist(), [list(c) for c in coords]]
                    for e, qa, ta, coords in alns]))
            out[f"{C}x{R}"] = runs
    finally:
        sp.CB_COLS = saved
    return out


def local_block(mesh, rows, global_rows):
    """This rank's blocks of the given global arrays, and their layout."""
    lo, hi = multihost.process_span(global_rows)
    blocks = [multihost.shard_local_batch(mesh, a[lo:hi], global_rows=global_rows)
              for a in rows]
    return [b for b, _ in blocks], blocks[0][1]


def run_ranks(outfile, device: str = "cpu", n: int = 2, timeout: float = 120.0,
              shards: int = 2, pairs=WAVEFRONT_PAIRS):
    """Start ``n`` ranks of this script, each with ``shards`` shards of
    ``device`` and the column-blocked ``pairs``, on a free local port, wait
    for them (at most ``timeout`` seconds, then kill them) and return what
    each wrote; a rank that fails or outlasts the wait raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(n):
        env = dict(os.environ, ALIGNER_COORDINATOR=f"127.0.0.1:{port}",
                   ALIGNER_NUM_PROCESSES=str(n), ALIGNER_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(outfile), device, str(shards),
             json.dumps(pairs)],
            env=env,
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the ranks did not finish within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a rank exited {p.returncode}:\n{out}")
    results = []
    for rank in range(n):
        with open(f"{outfile}.p{rank}") as fh:
            results.append(json.load(fh))
    return results


def one_process(device: str = "cpu"):
    """The three steps in one process on a 4-slot mesh of ``device``, on the
    whole batches (the windows padded with empty ones to 16 rows)."""
    x = inputs()
    mesh = pm.make_mesh(4, devices=[device] * 4)
    pad = 16 - UNEVEN
    ws = np.concatenate([x["ws"], np.zeros((pad, x["ws"].shape[1]), np.int32)])
    wl = np.concatenate([x["wl"], np.zeros(pad, np.int32)])
    pair = (x["q"], x["ql"], x["t"], x["tl"])
    pop = tuple(a[:POP_B] for a in pair)
    return dict(
        scores=pm.sharded_scores(mesh, *pair, x["m"], 11.0, 2.0, dtype=F64),
        scan=pm.window_scan_step(mesh, ws, wl, x["pwm"], 3.0, 1.0, dtype=F64),
        population=pm.matrix_population_step(mesh, *pop, x["mats"], 7.0, 3.0, dtype=F64),
        windows=(ws, wl), pop=pop)


def main() -> int:
    torch.set_num_threads(1)
    outfile = sys.argv[1]
    device = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    shards = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    pairs = json.loads(sys.argv[4]) if len(sys.argv) > 4 else WAVEFRONT_PAIRS
    multihost.initialize_from_env("gloo")
    import torch.distributed as dist

    rank = dist.get_rank()
    mesh = multihost.global_mesh(devices=[device] * shards)
    assert mesh.process_count == dist.get_world_size() and mesh.process_index == rank
    x = inputs()
    out = dict(mesh=list(mesh.grid.shape), span=multihost.process_span(B))

    (q, ql, t, tl), lay = local_block(mesh, (x["q"], x["ql"], x["t"], x["tl"]), B)
    res = pm.sharded_scores(mesh, q, ql, t, tl, x["m"], 11.0, 2.0, dtype=F64)
    out["scores"] = [lay.gather(r).tolist() for r in res]

    (q, ql, t, tl), lay = local_block(mesh, (x["q"], x["ql"], x["t"], x["tl"]), UNEVEN)
    out["uneven_layout"] = [list(map(list, lay.spans)), lay.per_pad, lay.global_rows]
    out["uneven_block_rows"] = len(q)
    res = pm.sharded_scores(mesh, q, ql, t, tl, x["m"], 11.0, 2.0, dtype=F64)
    out["uneven_scores"] = [lay.gather(r).tolist() for r in res]

    (ws, wl), lay = local_block(mesh, (x["ws"], x["wl"]), UNEVEN)
    scores, z, mean, std = pm.window_scan_step(mesh, ws, wl, x["pwm"], 3.0, 1.0, dtype=F64)
    out["scan"] = dict(scores=lay.gather(scores).tolist(), z=lay.gather(z).tolist(),
                       mean=float(mean), std=float(std))

    rows = (x["q"][:POP_B], x["ql"][:POP_B], x["t"][:POP_B], x["tl"][:POP_B])
    (q, ql, t, tl), lay = local_block(mesh, rows, POP_B)
    best, win = pm.matrix_population_step(mesh, q, ql, t, tl, x["mats"], 7.0, 3.0,
                                          dtype=F64)
    out["population"] = [lay.gather(best).tolist(), lay.gather(win).tolist()]
    out["wavefront"] = wavefront_runs(mesh, pairs)
    out["wavefront_counters"] = {k: [v.launches, v.cells] for k, v in counters.snapshot().items()
                                 if k.endswith(("-handoff", "-gather"))}

    with open(f"{outfile}.p{rank}", "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
