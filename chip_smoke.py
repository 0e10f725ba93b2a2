#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aligner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``aligner_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the port's
main path through the entry points a user calls, checking every result
against the native C++ host engine or the frozen golden fixtures:

1. build the kernels;
2. kernel == plain version, bit for bit, on seeded ragged and dense
   batches (pair mode local/global and PWM mode, shared and per-problem
   matrices, argmax on/off, directions on/off, f32/f64), the walk on
   words from the kernel fill, the row-scan fill of one global pair and
   the replay walk on ragged shapes, the band fill on band and chunk seams,
   with a streamed left boundary and at full width, the column-block fill
   on every block of ragged grids and the replay walk with a column base
   on every tile a walk crosses, real cells only, both walks on words whose
   paths run past the staged span and refill, the heuristic population's
   frequency count on its first iteration and on ragged step streams, the
   counting walk (K4 with the count as its epilogue) on that iteration and
   on ragged words, and the batched float64 transform on the card against
   numpy's), and
   each kernel's time beside its plain version's and its bound at the
   shapes the main path gives it, the batched fill's launch plan beside
   each of its rows (threads a block, rows of the column on chip, shared
   memory, ns a cell per problem), the walks' plans beside theirs (the
   ring's span, warps a block, ns a step, rows asked for and refills; a
   walk's time queued behind a busy kernel, so the host's launch time does
   not count, where the other kernels are timed back to back), the fill on
   every length bucket of the
   100k search and held whole on the tallest (its columns partly off chip), the
   repeat scan's chunk size timed at 8,192 and 65,536 windows, the row-scan's tile and replay-block
   sizes and the band walk's rows a lane, read-ahead and band sizes swept at
   65,536 x 65,536 with its launch plan,
   the column-block fill held and timed on the last forward block and the
   last replay tile of the 524,288 x 524,288 pair, and the column block's
   width and the forward block's rows swept at 262,144 x 262,144 and
   524,288 x 524,288, and the frequency count and the counting walk at the
   population's shape (queued, as the walks are; walk + count and the
   counting walk in turns) with one population iteration split by CUDA
   events both ways;
3. golden fixtures: ``batch_align`` on the three example FASTAs;
4. ``calculate_p_value`` with 5,000 sequences on ``examples/protein.fasta``;
5. ``aligner-search`` on a seeded 100,000-sequence protein database (local)
   and its first 5,000 records (global), every record of the buckets whose
   columns spill off chip held against native C++; then the local search once more
   under ``torch.profiler`` for the device's busy time and idle share;
6. a full-mode batch of 4,096 pairs of 400 residues, local and global;
7. the heuristic population a service worker runs for one request
   (``warmup_population``, then ``heuristic_align_population`` of 64 seeded
   {-1, 0, 1} starting matrices on the ``examples/protein.fasta`` pair,
   kd 0, r² 1e5, del = ext = 11), every member held bit for bit against
   ``heuristic_align``'s loop on the host engine with numpy's transforms,
   and one ``heuristic_align`` from BLOSUM62 held the same way;
8. the service, end to end: the port's dispatcher served over HTTP on a
   temporary sqlite file, ``POST /validate`` of one request (kd 0, r² 1e5,
   del 11, ``dimValue`` 24, ``matricesVolumeValue`` 64) on a FASTA of the
   two ``examples/protein.fasta`` records and a seeded homolog of each
   (6 tasks, 384 jobs), one worker process
   (``aligner_tpu_torch.service.worker --device cuda --warmup --batch 64``)
   that drains the queue, every stored subtask held bit for bit against
   ``heuristic_align``'s loop on the host engine for its pair and starting
   matrix, promotion through ``GET /progress`` (the updater then promotes
   nothing, each result is its task's best subtask), and
   ``aligner-torch-calc --seed 0`` on the card, each stored p-value held bit
   for bit against the fit on native C++ scores of the same shuffles;
9. ``aligner-repeat-search`` in exploring mode with a checkpoint on a
   seeded 10 Mb chromosome with 40 planted copies of one 330-base query,
   at the reference defaults (W = 300, window 330, offset 30, 10 cycles);
   then one more cycle from the completed checkpoint's state, held
   against native C++ (scores, z, sampled windows) and the host engine
   (survivor alignments);
10. one huge global pair: ``align_global`` on a seeded homologous protein
   pair of 65,536 x 65,536 (checkpoints and step stream held against the
   plain versions'), at 8,000 x 9,000 (checkpoint-and-replay) and
   3,000 x 4,000 (one direction plane) against the host engine, the
   ``aligner-align -g`` CLI on two 3,000-residue records, and one
   ``align_global`` at the width cap, 262,144 x 262,144, timed, its path
   rescored under the fill's rules and held against ``global_end_score``;
11. the end score of one huge global pair: ``global_end_score`` at
   65,536 x 65,536 against the row-scan fill's end cell and the plain band
   engine, at 8,000 x 9,000 and 3,000 x 4,000 against the host engine, its
   ``diag``, ``host`` and batched-fill routes on a small pair, one call at
   262,144 x 262,144 against the row-scan fill's end cell, timed, and
   ``local_max_score`` against native C++;
12. a global pair wider than one plane, on the column-blocked pipeline:
   the 65,536 x 65,536 pair as 4 column blocks (strings, end score and
   checkpoint rows against the single-plane routes and the plain
   versions), the 262,144 x 262,144 pair as 2 (strings and end score
   against the single-plane routes), then 524,288 x 524,288 through
   ``align_global`` and ``global_end_score`` by its width alone, each on
   the block engine ``auto_shard_config`` picks (the end score equals the
   other block engine's: K7's forward, or the band engine's; the rescored
   path equals the end score, the strings spell the pair), and
   ``backend="wavefront_sp"`` on a small pair against the host engine;
   the path is driven first, alone, and held against the other routes
   after its launch counts are read;
13. the simple aligners and the host walks: the fill kernel with the score
   plane held bit for bit against its plain version (ragged and dense
   batches, local and global, f32 and f64, shared and per-problem
   matrices, PWM mode) and timed on the ``examples/protein.fasta`` pair at
   B = 1; ``SimpleGlobalAligner``/``SimpleLocalAligner.from_str_seqs`` on the
   three example FASTAs against the golden fixtures, their planes against
   ``native.fill``; ``perform_alignment`` in both modes on a seeded
   8,192 x 8,192 pair (the most ``keep_planes`` takes), its planes against
   native C++ and its strings against ``device="host"``, timed beside it;
   then ``walk="host"`` against the default walk on the full batch, the
   1,024 PWM survivors, ``align_global`` at 65,536 x 65,536 and the
   column-blocked pipeline on that pair in 4 blocks, with K4 and W launched
   no time under it;
14. the column-blocked pipeline's engines: the band engine's end score and
   alignment of the 65,536 x 65,536 pair in 4 column blocks (its boundary
   history, checkpoint rows and step stream equal the row-scan engine's,
   its strings phase 12's) and of the 524,288 x 524,288 pair, timed (the end
   score equals K7's forward, the path rescores to it); that pair with
   BLOSUM62 x 20, del 220, ext 40 through ``align_global`` and
   ``global_end_score`` with nothing named (the "lax" engine, by the
   matrix: the strings equal phase 12's, the end score is 20 times its),
   and ``aligner-align -g -m FILE`` with that matrix on a 262,144 x 262,400
   pair (its stdout the rendering of the BLOSUM62 alignment); each of its
   blocks one K6 or K7 launch and each tile one K7 launch with directions
   and one walk; then K7 with BLOSUM62 x 20 on ragged blocks and on the
   last replay tile, and K6 on the band engine's last block of the
   524,288 x 524,288 alignment, against their plain versions, and the
   engine pick's calibration points, its fit and its picks;
15. multi-device on the one card: the auto-shard's fills with the card
   given twice as the shard list, through ``batch_align`` on the p-value's
   4,999 shuffles (K1, no argmax) and the full batch of 4,096 pairs with
   alignments, local and global (K2 and K4 a shard; the fill's scores and
   words and the strings), and ``repeat._scan_scores`` on the chromosome's
   333,334 windows (K3 a shard a chunk), each equal bit for bit to the
   unsharded call and timed beside it in turns; the column-blocked
   pipeline on a (2, 1) mesh of the card twice (the 524,288 x 524,288
   pair, 2 of its 4 column blocks a slot, bit-equal to phase 12 with its
   launch counts) and ``align_global``/``global_end_score`` of the
   65,536 x 65,536 pair with the card twice as the auto-shard's list (a
   huge pair on several devices takes the pipeline; bit-equal to phases 10
   and 11); then two ranks (copies of
   this script, ``--mesh-rank``; gloo, the card twice each: a (2, 2) mesh)
   run ``sharded_scores`` on their ``shard_local_batch`` blocks of the
   shuffles (an odd count: an uneven layout), ``window_scan_step`` on the
   scan's windows padded with empty ones and ``matrix_population_step``
   with 64 seeded {-1, 0, 1} matrices on the service's 6 pairs: gathered,
   the scores equal the unsharded K1 fill and the one-card scan, the mean,
   std and z are within 1e-12 of the scan's, the best matrices equal the
   one-process step; and align and end-score the 524,288 x 524,288 pair
   on the pipeline over their mesh's data axis (one slot a rank, the
   boundaries and the trace records through the CPU), bit-equal to phase
   12; each rank prints its launch counts and walls;
16. the kernels' launch counts of each path: the pair path (phases 3-6),
   the population path (phase 7: the counting walk once an iteration, the
   standalone count never), the service path (phase 8: the worker
   process's K2, K4 and counting-walk launches, which it prints at exit,
   and calc's K1 launches; the counting walk once an iteration of each
   task, the standalone count never), the PWM path (phase 9), the huge-pair path (phase 10), the
   end-score path (phase 11), the column-blocked path (phase 12), the
   simple aligners' path (phase 13: the score plane once a pair, no walk
   kernel), the host walks' path (phase 13: the fills, no walk kernel) and
   the engines' path (phase 14) and the sharded path (phase 15: this
   process's and the ranks'), each counted from zero; the row-scan,
   column-block and band fills make one launch a call.

Every phase prints one line with its result and wall time; a failing
check raises and the script exits nonzero.  The line before the last is
a JSON object with one entry per kernel (its launches on its paths, its
time, its plain version's time and its bound: the larger of the bytes it
must move over 3.35 TB/s and its operations over the card's rate for
their type: 67 T/s in float32 and 34 T/s in float64 outside the tensor
cores, 16.7 T/s in int32, a DPX add-max one operation); the last line is
the JSON device record.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import functools
import io
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

DEVICE = "cuda"
SEED = 0
DEL, EXT = 11.0, 2.0
N_PVALUE = 5_000  # SEQUENCES of the reference (statistics.py:41)
N_DB = 100_000
N_DB_GLOBAL = 5_000
N_FULL = 4_096
FULL_LEN = 400
AMINO = b"ACDEFGHIKLMNPQRSTVWY"
# the repeat search at the reference defaults (args.rs:5-44) on the
# construction of bench_chromosome.make_chromosome
CHROM_BP = 10_000_000
CHROM_SEED = 7
N_PLANTED = 40
PLANT_LEN = 330
PWM_W, OFFSET, PWM_DEL, PWM_EXT = 300, 30, 30.0, 7.0
REPEATS = 10
SCAN_CHUNKS = (8_192, 65_536)
N_SURVIVORS = 1_024  # survivor batch of the timing phase
# one huge global pair: a seeded homologous protein pair (a quarter of
# the positions substituted), BLOSUM62, del 11 / ext 2
PAIR_LEN = 65_536
PAIR_SEED = 11
WIDE_LEN = 262_144  # the width cap of one plane
BLOCKED_LEN = 524_288  # twice the cap: the column-blocked route by width alone
BLOCKED_B = 4  # column blocks of the 65,536 x 65,536 pair
CB_SWEEP = (32_768, 65_536, 131_072, 262_144)  # column-block widths at WIDE_LEN
TILE_CB_SWEEP = (65_536, 131_072, 262_144)  # replay-tile widths at WIDE_LEN
TR_SWEEP = (32_768, 131_072, 262_144)  # rows of a forward block at WIDE_LEN
FORWARD_SWEEP = (32_768, 131_072, 262_144, 524_288)  # the same at BLOCKED_LEN
TILE_SWEEP = ((2, 64), (4, 32), (4, 64), (4, 128), (4, 256), (8, 64), (8, 128), (8, 256))
TB_SWEEP = (2_048, 8_192, 16_384, 32_768, 65_536)
TB_TILE_ROWS = (64, 128)
# the band walk at 65,536 x 65,536: (rows a lane, slots read ahead) for one
# band as tall as the pair, then band heights at the shipped shape
BAND_SHAPE_SWEEP = ((1, 32), (2, 16), (2, 32), (2, 64), (4, 16), (4, 32), (4, 64),
                    (8, 32))
BAND_TB_SWEEP = (4_096, 16_384, 65_536)
BAND_TB_WIDE = (65_536, 262_144)  # band heights timed at the width cap
BAND_FULL_WIDTH_ROWS = 256  # the rows of the full-width band held against plain
SMALL_PAIR = (300, 400)  # the routes of global_end_score
CHUNKED_PAIR = (8_000, 9_000)  # (query, target): past the direct-plane budget
DIRECT_PAIR = (3_000, 4_000)
CLI_PAIR_LEN = 3_000
# the simple aligners: a homologous pair of 2^26 cells, the most keep_planes
# takes (ops.wavefront.DIRECT_PLANE_CELLS)
# the column-blocked engines (phase 14): BLOSUM62 x 20 with both penalties
# x 20 for the "lax" engine (entries -80 ... 220), the CLI's pair one
# COL_PAD wider than one plane, and the band heights of the engine pick's
# calibration at WIDE_LEN, by column block width
LAX_SCALE = 20
LAX_DEL, LAX_EXT = 220, 40
CLI_WIDE_PAIR = (262_400, 262_144)  # (query, target)
BAND_CAL = ((131_072, (8_192, 32_768, 131_072, 262_144)), (65_536, (32_768, 262_144)),
            (262_144, (32_768, 262_144)))
K7_CAL_ROWS = (16_384, 65_536)  # K7 on targets this short, at CB_COLS columns
SHORT_LEN = 16_384  # a short target under a 524,288-wide query, for the pick
PLANE_LEN = 8_192
PLANE_SEED = SEED + 31
# the heuristic population a service worker runs for one request of
# bench_service.py (kdValue 0, rSquaredValue 1e5, delValue 11, dimValue 24,
# matricesVolumeValue 64) on the examples/protein.fasta pair; the worker
# passes del for both gap penalties (aligner_tpu/service/worker.py)
POP_M, POP_DIM = 64, 24
POP_KD, POP_R2, POP_DEL = 0.0, 1e5, 11.0
POP_SEED = SEED + 21
POP_MAX_ITERS = 1000  # heuristic_align_population's default
# the service phase: that request posted to the port's dispatcher on a FASTA
# of the two examples/protein.fasta records and a seeded homolog of each
# (6 tasks of POP_M jobs), one worker process claiming a task a batch
SERVICE_SEED = SEED + 23
SERVICE_BATCH = 64
SERVICE_POLL_S = 0.2
SERVICE_IDLE_POLLS = 25  # the worker's poll cycles after the queue drains
SERVICE_DEADLINE_S = 600
# the multi-device phase: the one card as 2 shards, and 2 ranks (gloo)
# each with the card twice as its shards, a (2, 2) mesh
MESH_SHARDS = 2
MESH_RANKS = 2
MESH_SEED = SEED + 35
RANK_DEADLINE_S = 300
MESH_STATS_TOL = 1e-12  # mean, std and z of the ranks' scan against the one-card scan's
# runs the worker module as __main__ (what ``python -m`` does) and prints the
# process's kernel launch counts when it exits: its launches are counted in
# its own process
WORKER_RUNNER = """
import atexit, json, runpy, sys
from aligner_tpu_torch.ops import device_walk, dp_fill, freq_count
atexit.register(lambda: print("launches " + json.dumps(dict(
    scores=dp_fill.launches.scores, dirs=dp_fill.launches.dirs,
    walk=device_walk.launches.walk, walk_count=device_walk.launches.walk_count,
    freq_count=freq_count.launches.freq_count)),
    flush=True))
sys.argv[0] = "aligner_tpu_torch.service.worker"
runpy.run_module("aligner_tpu_torch.service.worker", run_name="__main__", alter_sys=True)
"""
REPLACES = {
    "dp_fill": "aligner_tpu/ops/pallas_dp.py:88",
    "device_walk": "aligner_tpu/ops/device_walk.py:34",
    "row_scan": "aligner_tpu/ops/wavefront.py:127",
    "replay_walk": "aligner_tpu/ops/wavefront.py:1202",
    "band": "aligner_tpu/ops/wavefront.py:973",
    "block_cs": "aligner_tpu/ops/wavefront.py:754",
    "freq_count": "aligner_tpu/heuristic.py:207",
    "walk_count": "aligner_tpu/heuristic.py:207, aligner_tpu/ops/device_walk.py:34",
}
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, the float32 rate outside the tensor cores (128 lanes an SM, an FMA
# counted as two operations) and the float64 rate outside the tensor
# cores; and the int32 rate of the integer kernels (K4-K7, W): the Hopper
# architecture white paper gives an SM 64 INT32 lanes, so 64 x 132 SMs x
# the data sheet's 1,980 MHz boost clock, about 16.7 T/s, a quarter of the
# float32 figure
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_F64_S = 34e12
PEAK_I32_S = 64 * 132 * 1.98e9
# operations a cell of the batched float fill: diag + s, two gap
# subtractions, three maxima in a local fill; with directions two
# comparisons, a shift and an or more.  A cell of the int32 global fills
# (K5, K7), a DPX add-max (__viaddmax_s32) counted as one operation: up -
# pen, max(diag + s, that), max(left - pen, that); with directions left -
# pen, two comparisons, a shift and an or more.  A walk step: a shift, a
# mask, two compares and decrements, the pack.
OPS_FILL, OPS_FILL_DIRS = 6, 10
OPS_SCAN, OPS_SCAN_DIRS = 3, 8
OPS_BAND = 2  # hat coordinates carry the penalty: max(diag + s, up), then left
OPS_WALK_STEP = 10
# a step of the frequency count: the code's shift and mask, its two moves
# counted, then replayed: a compare and the cursor's two decrements
OPS_COUNT_STEP = 8


def bound(ops: float, nbytes: float, rate: float = PEAK_I32_S) -> dict:
    """The least time the card could take for ``ops`` operations at
    ``rate`` a second (int32 by default) and ``nbytes`` bytes moved, and
    which of the two sets it."""
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"[{name}] ok in {time.perf_counter() - t0:.3f} s", flush=True)


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def tensors(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
            for a in arrays]


def same_fill(a, b) -> bool:
    for f in ("fmax", "fy", "fx", "end", "words"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and not (x.dtype == y.dtype and torch.equal(x, y)):
            return False
    return True


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def random_batch(rng, B, C, R, dense):
    q = rng.integers(0, 24, (B, C))
    t = rng.integers(0, 24, (B, R))
    if dense:
        return q, np.full(B, C), t, np.full(B, R)
    return q, rng.integers(0, C + 1, B), t, rng.integers(0, R + 1, B)


def pwm_batch(rng, B, R, W, batched, dtype, dev):
    """B ragged DNA queries (every 17th empty) and a shared or per-problem
    asymmetric PWM: integral for f32, non-integral for f64."""
    q = rng.integers(0, 4, (B, R))
    ql = rng.integers(0, R + 1, B)
    ql[::17] = 0
    shape = (B, 4, W) if batched else (4, W)
    pwm = (rng.integers(-4, 6, shape) if dtype == torch.float32
           else rng.normal(0.0, 3.0, shape))
    q, ql = tensors(dev, q, ql)
    return q, ql, torch.as_tensor(pwm, dtype=dtype, device=dev)


def homologous_pair(seed, C, R):
    """A seeded protein pair: the target is the query, cut or repeated to
    R, with a quarter of its positions substituted."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, C).astype(np.int8)
    t = np.resize(q, R).copy()
    mask = rng.random(R) < 0.25
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    return q, t


def padded_pair(dev, wf, q, t, tb):
    """The pair on the card as the row-scan fill takes it: columns padded
    to the fill's column multiple, rows to the block."""
    C_pad, R_pad = -(-len(q) // wf.COL_PAD) * wf.COL_PAD, -(-len(t) // tb) * tb
    return tensors(dev, np.pad(q, (0, C_pad - len(q))), np.pad(t, (0, R_pad - len(t))))


def same_scan(got, want, C, rows) -> bool:
    """End cell, checkpoint rows and direction codes of the real cells of
    two row-scan results (padded rows and columns are unspecified)."""
    ok = torch.equal(got[0], want[0])
    if got[1] is not None:
        # unpacking 16 codes a word: compare the words' real columns, and
        # in the last word row only the bits of real rows
        full = rows // 16
        ok = ok and torch.equal(got[1][:full, :C], want[1][:full, :C])
        if rows % 16:
            mask = (1 << (2 * (rows % 16))) - 1
            ok = ok and torch.equal(got[1][full, :C] & mask, want[1][full, :C] & mask)
    if got[2] is not None:
        ok = ok and torch.equal(got[2][:, :C], want[2][:, :C])
    return ok


def same_walk(got, want) -> bool:
    """Two (cursor, step stream) pairs: the cursors and the words the
    walks wrote (the buffers may differ in length)."""
    nw = -(-int(got[0][2]) // 16)
    return torch.equal(got[0], want[0]) and torch.equal(got[1][:nw], want[1][:nw])


def wavefront_vs_plain(dev, at, wf):
    """K5 (scores with checkpoints; directions from row 0 and from a
    checkpoint row) and the replay walk against their plain versions on
    ragged shapes, every tile width, real cells only."""
    m = torch.as_tensor(np.array(at.blosum62()).astype(np.int32), device=dev)
    n = 0
    # (columns a lane, C, R, tile rows, block rows)
    for K, C, R, tr, tb in ((2, 1, 1, 16, 16), (4, 127, 40, 16, 32), (8, 300, 257, 64, 128),
                            (4, 513, 130, 32, 64), (8, 700, 256, 64, 128),
                            (2, 257, 21, 16, 16)):
        qd, td = padded_pair(dev, wf, *homologous_pair(SEED + C, C, R), tb)
        C_pad, R_pad = qd.numel(), td.numel()
        kw = dict(tile_rows=tr, cols_per_thread=K)
        fwd = wf.row_scan(qd, td, m, 11, 2, None, 0, C, R, with_dirs=False,
                          ckpt_every=tb, **kw)
        fwd_p = wf.row_scan_plain(qd, td, m, 11, 2, None, 0, C, R, False, tb)
        check(same_scan(fwd, fwd_p, C, R), f"row_scan != plain (forward, {C}x{R})")
        n += 1
        state, steps = wf.new_walk(R, C, R_pad + C_pad + 1, dev)
        state_p, steps_p = wf.new_walk(R, C, R_pad + C_pad + 1, dev)
        for j in range((R - 1) // tb, -1, -1):
            args = (qd, td[j * tb:(j + 1) * tb], m, 11, 2, fwd[2][j - 1] if j else None,
                    j * tb, C, R)
            blk = wf.row_scan(*args, with_dirs=True, **kw)
            blk_p = wf.row_scan_plain(*args, True)
            check(same_scan(blk, blk_p, C, min(tb, R - j * tb)),
                  f"row_scan != plain (directions, block {j} of {C}x{R})")
            wf.replay_walk(blk[1], state, steps, row_base=j * tb)
            wf.replay_walk_plain(blk[1], state_p, steps_p, row_base=j * tb)
            check(same_walk((state, steps), (state_p, steps_p)),
                  f"replay_walk != plain (block {j} of {C}x{R})")
            n += 2
        cy, cx, _ = state.tolist()
        check(cy == 0 or cx == 0, f"the walk of {C}x{R} did not reach a border")
    return n


def same_band(got, want, TB, n_cols, with_rc=True) -> bool:
    """Two results of the band fill: ``rb`` on the slots that cells of the
    block's first ``n_cols`` columns feed, ``rc`` and ``end``."""
    ok = torch.equal(got[0][TB - 1:TB - 1 + n_cols], want[0][TB - 1:TB - 1 + n_cols])
    if with_rc:
        ok = ok and torch.equal(got[1], want[1])
    return ok and torch.equal(got[2], want[2])


def band_vs_plain(dev, at, host, wf, sp):
    """K6 against its plain version: band heights at, below and one past
    the row count, widths at and one past a chunk seam, every band of each
    pair (band 0 holds the border column and cell (1,1)), the right column
    on and off, every rows a lane and read-ahead, BLOSUM62 and a wide-range
    DNA matrix; a grid of blocks with a streamed left boundary against the
    host engine's plane; one full-width band."""
    b62 = np.array(at.blosum62())
    wide = np.random.default_rng(SEED + 9).integers(-30, 30, (4, 4)).astype(np.float64)
    check(wide.max() - wide.min() > 15, "the DNA matrix is not wide-range")
    n = 0
    # (C, R, band rows, rows a lane, slots read ahead, matrix, del, ext); the
    # streams are padded to a multiple of the read-ahead
    for C, R, tb, K, P, m, d, e in (
            (1, 1, 128, 1, 32, b62, 11, 2), (127, 128, 128, 2, 64, b62, 11, 2),
            (128, 129, 128, 4, 16, b62, 11, 2), (129, 300, 128, 4, 32, b62, 7, 3),
            (512, 255, 256, 8, 64, b62, 11, 2), (513, 257, 256, 8, 16, b62, 11, 2),
            (150, 170, 128, 4, 32, wide, 5, 2), (700, 1300, 512, 2, 16, b62, 11, 2)):
        V = m.shape[0]
        rng = np.random.default_rng(SEED + C + R)
        pp = wf._prep(rng.integers(0, V, C), rng.integers(0, V, R), m, d, e, dev)
        bands = []
        wf._band_end_score(pp, tb, P, K, block=wf.run_block_band_plain, trace=bands)
        for jb, (args, kw, _) in enumerate(bands):
            for with_rc in (True, False):
                got = wf.run_block_band(*args, **kw, with_rc=with_rc, read_ahead=P,
                                        rows_per_lane=K)
                want = wf.run_block_band_plain(*args, **kw, with_rc=with_rc)
                check(same_band(got, want, args[0].numel(), kw["Cb"]),
                      f"run_block_band != plain ({C}x{R}, band {jb} of {tb} rows, "
                      f"{K} rows a lane, {P} slots read ahead, rc={with_rc})")
                n += 1
    # a streamed left boundary: 3 column blocks by 3 bands, x0 > 0
    C, R, tb, cb = 600, 300, 128, 256
    q, t = homologous_pair(SEED + 10, C, R)
    H = host.align_global(q, t, b62, DEL, EXT).score
    end, rights, bottoms = sp.band_grid(q, t, b62, DEL, EXT, tb=tb, cb=cb, device=dev,
                                        read_ahead=64)
    end_p, rights_p, bottoms_p = sp.band_grid(q, t, b62, DEL, EXT, tb=tb, cb=cb,
                                              device=dev, block=wf.run_block_band_plain)
    check(int(end) == int(end_p) == H[R, C], "band grid: end score != the host engine")
    for ci in range(C // cb):  # the last block's right column lies past the query
        check(torch.equal(rights[ci][:R], rights_p[ci][:R])
              and np.array_equal(rights[ci][:R].cpu().numpy(), H[1:R + 1, (ci + 1) * cb]),
              f"band grid: right column of block {ci} != the host engine")
    for jb in range(R // tb):
        for ci in range(-(-C // cb)):
            w = min(cb, C - ci * cb)
            check(torch.equal(bottoms[jb][ci][:w], bottoms_p[jb][ci][:w])
                  and np.array_equal(bottoms[jb][ci][:w].cpu().numpy(),
                                     H[(jb + 1) * tb, ci * cb + 1:ci * cb + 1 + w]),
                  f"band grid: last row of block ({jb}, {ci}) != the host engine")
    n += 9
    # one full-width band
    pp = wf._prep(*homologous_pair(PAIR_SEED, PAIR_LEN, BAND_FULL_WIDTH_ROWS), b62, DEL,
                  EXT, dev)
    bands = []
    wf._band_end_score(pp, BAND_FULL_WIDTH_ROWS, wf.BAND_TD, wf.BAND_ROWS_PER_LANE,
                       block=wf.run_block_band_plain, trace=bands)
    (args, kw, want), = bands
    got = wf.run_block_band(*args, **kw, with_rc=False)
    check(same_band(got, want, args[0].numel(), kw["Cb"], with_rc=False),
          f"run_block_band != plain (one band of {BAND_FULL_WIDTH_ROWS} rows by "
          f"{PAIR_LEN} columns)")
    return n + 1


def same_block(got, want, rows, cols) -> bool:
    """Two results of the column-block fill on the block's real rows and
    columns: the last row, the right column, the end cell, the codes and
    the checkpoint rows."""
    return (torch.equal(got[0][:cols], want[0][:cols])
            and torch.equal(got[1][:rows], want[1][:rows])
            and same_scan(got[2:], want[2:], cols, rows))


def block_cs_vs_plain(dev, at, wf, sp):
    """K7 against its plain version on every block of ragged grids (x0 and
    y_base zero and not, the block with cell (1,1), the block that owns the
    end cell, the pair's last column on a block's last and first column),
    scores with checkpoint rows and directions, every tile width and three
    tile heights;
    then the replay walk with a column base against its plain version on
    every tile the walk crosses, leaving by the top and by the left edge."""
    b62 = np.array(at.blosum62())
    n = 0
    exits = set()
    # (C, R, column block, rows of a block, columns a lane, tile rows)
    for C, R, cb, tb, K, tile in ((512, 128, 256, 64, 2, 16), (513, 100, 256, 64, 4, 32),
                                  (700, 300, 512, 128, 8, 64), (300, 70, 512, 64, 4, 64),
                                  (1, 1, 256, 16, 4, 16), (1000, 200, 256, 64, 8, 32),
                                  (260, 1000, 256, 128, 2, 64)):
        q, t = homologous_pair(SEED + C + R, C, R)
        pp = sp._prep_sharded(-(-C // cb), q, t, b62, DEL, EXT, tb, tb, None, dev)
        # every block's inputs come from the blocks above and left of it,
        # each of which is held below: block (0, 0) takes closed forms
        _, lb_hist, ckpts = sp._forward(pp, True)
        Cb, TB = pp["Cb"], pp["tr"]
        check(Cb == cb, f"{C} columns in blocks of {cb} came out {Cb} wide")
        kw = dict(del_=int(DEL), ext=int(EXT))

        def block_args(j, d):
            h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, j, d)
            return (pp["q_dev"][d * Cb:(d + 1) * Cb], pp["t_dev"][j * TB:(j + 1) * TB],
                    pp["m_dev"], h0, lb, d * Cb, j * TB, C, R)

        for j in range(pp["J"]):
            for d in range(pp["n"]):
                args = block_args(j, d)
                for dirs in (False, True):
                    ck = 0 if dirs else tile  # checkpoint rows as the forward fill asks
                    got = wf.run_block_cs(*args, **kw, with_dirs=dirs, ckpt_every=ck,
                                          tile_rows=tile, cols_per_thread=K)
                    want = wf.run_block_cs_plain(*args, **kw, with_dirs=dirs,
                                                 ckpt_every=ck)
                    check(same_block(got, want, min(TB, R - j * TB), min(Cb, C - d * Cb)),
                          f"run_block_cs != plain ({C}x{R}, block ({j}, {d}) of {TB}x{Cb}, "
                          f"{K} columns a lane, {tile}-row tiles, dirs={dirs})")
                    n += 1
        size = pp["R_pad"] + pp["C_pad"] + 1
        state, steps = wf.new_walk(R, C, size, dev)
        state_p, steps_p = wf.new_walk(R, C, size, dev)
        cy, cx = R, C
        while cy > 0 and cx > 0:
            j, d = (cy - 1) // TB, (cx - 1) // Cb
            words = wf.run_block_cs(*block_args(j, d), **kw, with_dirs=True, tile_rows=tile,
                                    cols_per_thread=K)[3]
            if d:  # the tile to the left is not the cursor's: left alone
                wf.replay_walk(words, state, steps, row_base=j * TB, col_base=(d - 1) * Cb)
            wf.replay_walk(words, state, steps, row_base=j * TB, col_base=d * Cb)
            wf.replay_walk_plain(words, state_p, steps_p, row_base=j * TB, col_base=d * Cb)
            check(same_walk((state, steps), (state_p, steps_p)),
                  f"replay_walk != plain (tile ({j}, {d}) of {C}x{R}, column base {d * Cb})")
            cy, cx, _ = state.tolist()
            if d:
                exits.add("left" if cx == d * Cb and cy > j * TB else "top")
            n += 1
    check(exits == {"left", "top"},
          f"the walks with a column base left their tiles only by {sorted(exits)}")
    return n


def phase_kernels_vs_plain(dev, at, dp_fill, device_walk, scan_engine):
    """Every kernel specialisation against its plain version, bit for bit."""
    rng = np.random.default_rng(SEED)
    n = 0
    b62 = np.array(at.blosum62())
    for dense in (False, True):
        q, ql, t, tl = tensors(dev, *random_batch(rng, 300, 40, 37, dense))
        for dtype in (torch.float32, torch.float64):
            m = torch.as_tensor(b62, dtype=dtype, device=dev)
            for mode in ("local", "global"):
                for track in (True, False):
                    for dirs in (False, True):
                        kw = dict(mode=mode, track_argmax=track, with_dirs=dirs)
                        got = dp_fill.fill(q, ql, t, tl, m, DEL, EXT, **kw)
                        want = scan_engine.fill_batch(q, ql, t, tl, m, DEL, EXT, **kw)
                        check(same_fill(got, want),
                              f"dp_fill != plain ({dtype}, {mode}, track={track}, "
                              f"dirs={dirs}, dense={dense})")
                        n += 1
    # per-problem non-integral matrices, f64
    q, ql, t, tl = tensors(dev, *random_batch(rng, 130, 24, 29, False))
    mats = torch.as_tensor(rng.normal(0.0, 3.0, (130, 24, 24)), device=dev)
    for mode in ("local", "global"):
        kw = dict(mode=mode, with_dirs=True)
        check(same_fill(dp_fill.fill(q, ql, t, tl, mats, 3.5, 1.25, **kw),
                        scan_engine.fill_batch(q, ql, t, tl, mats, 3.5, 1.25, **kw)),
              f"dp_fill != plain (batched f64 matrix, {mode})")
        n += 1
    # PWM mode: ragged queries (some empty), R = 45 and W = 37 multiples
    # of neither 8 nor 32; integral f32 and non-integral f64 PWMs
    for batched in (False, True):
        for dtype in (torch.float32, torch.float64):
            q, ql, pwm = pwm_batch(rng, 300, 45, 37, batched, dtype, dev)
            for track in (True, False):
                for dirs in (False, True):
                    kw = dict(track_argmax=track, with_dirs=dirs)
                    check(same_fill(dp_fill.fill_pwm(q, ql, pwm, PWM_DEL, PWM_EXT, **kw),
                                    scan_engine.fill_pwm_batch(q, ql, pwm, PWM_DEL,
                                                               PWM_EXT, **kw)),
                          f"PWM dp_fill != plain ({dtype}, batched={batched}, "
                          f"track={track}, dirs={dirs})")
                    n += 1
    # a shared f64 PWM above 48 KB (the opt-in shared memory)
    q, ql, pwm = pwm_batch(rng, 40, 16, 2000, False, torch.float64, dev)
    check(same_fill(dp_fill.fill_pwm(q, ql, pwm, PWM_DEL, PWM_EXT, with_dirs=True),
                    scan_engine.fill_pwm_batch(q, ql, pwm, PWM_DEL, PWM_EXT,
                                               with_dirs=True)),
          "PWM dp_fill != plain (shared 4 x 2000 f64 PWM)")
    n += 1
    q, ql, pwm = pwm_batch(rng, 257, 45, 37, False, torch.float64, dev)
    r = dp_fill.fill_pwm(q, ql, pwm, PWM_DEL, PWM_EXT, with_dirs=True)
    S = q.shape[1] + pwm.shape[-1] + 1
    check(all(torch.equal(a, b) for a, b in zip(
        device_walk.walk(r.words, r.fy, r.fx, S=S, mode="local"),
        device_walk.walk_plain(r.words, r.fy, r.fx, S=S, mode="local"))),
        "device_walk != plain (PWM words)")
    n += 1
    # the walk on words from the kernel fill
    q, ql, t, tl = tensors(dev, *random_batch(rng, 257, 40, 45, False))
    m = torch.as_tensor(b62, dtype=torch.float32, device=dev)
    for mode in ("local", "global"):
        r = dp_fill.fill(q, ql, t, tl, m, DEL, EXT, mode=mode, with_dirs=True)
        sy, sx = (tl, ql) if mode == "global" else (r.fy, r.fx)
        S = t.shape[1] + q.shape[1] + 1
        got = device_walk.walk(r.words, sy, sx, S=S, mode=mode)
        want = device_walk.walk_plain(r.words, sy, sx, S=S, mode=mode)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"device_walk != plain ({mode})")
        n += 1
    return n


def walks_that_refill(dev, wf, device_walk) -> int:
    """Both walks on words whose paths run left past the staged span again
    and again (a near-diagonal path with LEFT runs of 600 columns every 16
    rows for W, planes of 3,000 columns whose rows are LEFT past column 50
    for K4): each held equal to its plain version, each refilling."""
    rng = np.random.default_rng(SEED + 9)
    R, C = 1024, 16_384
    codes = rng.choice([2, 0, 1], size=(R, C), p=[0.9, 0.05, 0.05])
    for y in range(5, R, 16):
        codes[y, np.arange(C) % 1000 < 600] = 1
    words = device_walk.pack_codes(codes, 16).to(dev)
    start = wf.new_walk(R, C, R + C + 1, dev)
    got = start[0].clone(), start[1].clone()
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    wf.replay_walk(words, *got, row_base=0, stats=stats)
    wf.replay_walk_plain(words, *start, row_base=0)
    check(same_walk(got, start), "replay_walk != plain on a walk that refills")
    check(int(stats[1]) > 0, f"the replay walk that should refill did not ({stats.tolist()})")
    B = 64
    codes = rng.choice([2, 0, 1], size=(B, 16, 3000), p=[0.8, 0.1, 0.1])
    codes[:, :, 50:] = 1
    words = device_walk.pack_codes(codes, 8).to(dev)
    sy = torch.as_tensor(rng.integers(1, 17, B), dtype=torch.int32, device=dev)
    sx = torch.full((B,), 3000, dtype=torch.int32, device=dev)
    stats.zero_()
    for mode in ("local", "global"):
        got = device_walk.walk(words, sy, sx, S=3017, mode=mode, stats=stats)
        want = device_walk.walk_plain(words, sy, sx, S=3017, mode=mode)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"device_walk != plain on walks that refill ({mode})")
    check(int(stats[1]) > 0, f"the batched walks that should refill did not "
                             f"({stats.tolist()})")
    return 3


def shuffles_for_p_value(at, q, t, n_sequences):
    """The exact shuffles ``calculate_p_value`` draws with this seed."""
    rng = np.random.default_rng(SEED)
    return [at.statistics.shuffle_and_randomize_sequence(t, rng)
            for _ in range(n_sequences - 1)]


def timed_pair(fn_kernel, fn_plain, reps):
    """(kernel result, kernel ms by CUDA events, plain result, plain ms of
    one synchronised run)."""
    ms = gpu_ms(fn_kernel, reps)
    got = fn_kernel()
    t0 = time.perf_counter()
    want = fn_plain()
    torch.cuda.synchronize()
    return got, ms, want, (time.perf_counter() - t0) * 1e3


def print_rows(rows) -> None:
    for r in rows:
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, max_abs_err {r['max_abs_err']}", flush=True)
        if "plan" in r:
            print(f"    {r['plan']}", flush=True)


def fill_bound(cells, ops_cell, args, matrix, res) -> dict:
    """Bound of one batched fill: its cells' operations against its inputs
    read once and its outputs written once."""
    return bound(ops_cell * cells, nbytes(*args, matrix, res.fmax, res.fy, res.fx,
                                          res.end, res.words, res.plane),
                 rate=PEAK_F64_S if matrix.dtype == torch.float64 else PEAK_OPS_S)


def plan_line(dp_fill, B, R8, C, matrix, ms) -> str:
    """The fill's launch plan for B problems of R8 x C cells, and the chain
    measure: the launch's time over the cells of one problem, in total and
    for each wave of resident problems."""
    p = dp_fill.launch_plan(B, R8, matrix)
    sms = dp_fill.card_limits(matrix.device).sms
    waves = -(-B // (p.resident_per_sm * sms))
    ns = ms * 1e6 / max(R8 * C, 1)
    return (f"plan: {p.threads} threads a block, S = {p.rows_on_chip} of {R8 + 1} rows "
            f"on chip, {p.smem_bytes} B shared memory a "
            f"block, matrix {'in shared memory' if p.mat_bytes else 'through L1'}, "
            f"{p.resident_per_sm} problems resident an SM, {waves} wave(s); "
            f"{ns:.2f} ns a cell per problem, {ns / waves:.2f} ns a wave")


def strip_line(wf, dev, block, rows, width, dirs, ms, tr=None, k=None, ck=0) -> str:
    """The strip walk's launch plan for one call (by default in the strip
    height the wrapper picks) and the time of one step of its critical
    path."""
    tr = wf._strip_rows(rows, ck, tr, dirs)
    k = wf.COLS_PER_THREAD if k is None else k
    p = wf.strip_plan(dev, block, rows, width, tr, k, 24, dirs)  # BLOSUM62's 24 symbols
    return (f"plan: {p.n_tr} strips of {tr} rows x {p.n_tc} chunks of {32 * k} columns, "
            f"{p.blocks} blocks of {p.warps} warps, {p.smem_bytes} B shared memory a "
            f"block, {p.steps_per_chunk} steps a chunk, lag {p.lag_steps} steps, "
            f"critical path {p.critical_steps} steps: "
            f"{ms * 1e6 / p.critical_steps:.1f} ns a step")


def walk_plan_line(device_walk, dev, words, wk, ms, stats) -> str:
    """The batched walk's launch plan for one call, the ns a step of its
    longest walk (the walks run side by side), and its rows asked for and
    refilled."""
    B, _, C = words.shape
    p = device_walk.walk_plan(B, C, dev)
    longest = int(wk[1].max())
    return (f"one warp a problem, {p.blocks} blocks of {p.warps} warps, each warp's "
            f"ring of word rows {p.span} columns wide; longest walk {longest} "
            f"steps, {ms * 1e6 / max(longest, 1):.1f} ns a step of it; {stats[0]} rows "
            f"asked for, {stats[1]} refills, {stats[2]} rounds in all")


def replay_plan_line(wf, ms, n_steps, stats) -> str:
    """The replay walk's shape for one call (one warp, one launch), the ns a
    step of it, and its rows asked for and refilled."""
    return (f"one warp, one launch a call, its ring of word rows {wf.REPLAY_SPAN} "
            f"columns wide; {n_steps} steps, {ms * 1e6 / max(n_steps, 1):.1f} ns "
            f"a step; {stats[0]} rows asked for, {stats[1]} refills, {stats[2]} rounds "
            f"({ms * 1e6 / max(stats[2], 1):.1f} ns a round)")


def timed_replay(wf, words, start, **kw):
    """The replay walk from copies of ``start`` (state, steps) on the card,
    timed queued (the copies are device-to-device); returns the walk's
    (state, steps), its ms and its (rows asked for, refills)."""
    from aligner_tpu_torch.ops.walk_probe import queued_ms

    def run(stats=None):
        st = start[0].clone(), start[1].clone()
        wf.replay_walk(words, *st, stats=stats, **kw)
        return st

    ms = queued_ms(run, 5)
    stats = torch.zeros(3, dtype=torch.int32, device=words.device)
    got = run(stats)
    torch.cuda.synchronize()
    return got, ms, stats.tolist()


def timed_walk(device_walk, words, sy, sx, S, dev):
    """K4 on the card, timed queued, with its rows asked for and refills;
    then its plain version, timed once."""
    from aligner_tpu_torch.ops.walk_probe import queued_ms

    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    ms = queued_ms(lambda: device_walk.walk(words, sy, sx, S=S, mode="local"), 20)
    got = device_walk.walk(words, sy, sx, S=S, mode="local", stats=stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = device_walk.walk_plain(words, sy, sx, S=S, mode="local")
    torch.cuda.synchronize()
    return got, ms, want, (time.perf_counter() - t0) * 1e3, stats.tolist()


def walk_bound(sy, sx, wk) -> dict:
    """Bound of one batched walk from the steps this run's data took: a
    4-byte word read per step, the packed streams and the end cells
    written."""
    n = int(wk[1].sum())
    return bound(OPS_WALK_STEP * n, 4 * n + nbytes(sy, sx, *wk))


def phase_timing(dev, at, dp_fill, device_walk, scan_engine, q, t):
    """Each kernel's time beside its plain version's at the main path's
    shapes: the p-value launch (4,999 x ~400^2, scores only, no argmax),
    the full-mode batch (4,096 x 400^2, directions, then the walk) and the
    100k search's buckets."""
    from aligner_tpu_torch.align import pad_batch

    m = torch.as_tensor(np.array(at.blosum62()), dtype=torch.float32, device=dev)
    rows = []
    sh = shuffles_for_p_value(at, q, t, N_PVALUE)
    qq, qql = pad_batch([q] * len(sh))
    tt, ttl = pad_batch(sh)
    args = tensors(dev, qq, qql, tt, ttl)
    kw = dict(mode="local", track_argmax=False)
    got, ms, want, plain_ms = timed_pair(
        lambda: dp_fill.fill(*args, m, DEL, EXT, **kw),
        lambda: scan_engine.fill_batch(*args, m, DEL, EXT, **kw), 5)
    check(same_fill(got, want), "dp_fill != plain at the p-value shape")
    rows.append(dict(name="dp_fill (scores only, p-value launch)", route="cuda",
                     source="aligner_tpu_torch/csrc/dp_fill.cu",
                     replaces=REPLACES["dp_fill"], path=("pair", "service", "sharded"),
                     counter="scores",
                     max_abs_err=max_abs_err(got.fmax, want.fmax), ms=ms,
                     plain_ms=plain_ms,
                     shape=f"{len(sh)}x{tt.shape[1]}x{qq.shape[1]}",
                     plan=plan_line(dp_fill, len(sh), tt.shape[1], qq.shape[1], m, ms),
                     **fill_bound(int((qql.astype(np.int64) * ttl).sum()), OPS_FILL,
                                  args, m, got)))

    fq, ft = full_batch_pairs()
    qq, qql = pad_batch(fq)
    tt, ttl = pad_batch(ft)
    args = tensors(dev, qq, qql, tt, ttl)
    kw = dict(mode="local", with_dirs=True)
    got, ms, want, plain_ms = timed_pair(
        lambda: dp_fill.fill(*args, m, DEL, EXT, **kw),
        lambda: scan_engine.fill_batch(*args, m, DEL, EXT, **kw), 3)
    check(same_fill(got, want), "dp_fill != plain at the full-mode shape")
    rows.append(dict(name="dp_fill (directions, full-mode batch)", route="cuda",
                     source="aligner_tpu_torch/csrc/dp_fill.cu",
                     replaces=REPLACES["dp_fill"], path=("pair", "service", "sharded"),
                     counter="dirs",
                     max_abs_err=max(max_abs_err(got.fmax, want.fmax),
                                     max_abs_err(got.words, want.words)),
                     ms=ms, plain_ms=plain_ms,
                     shape=f"{N_FULL}x{tt.shape[1]}x{qq.shape[1]}",
                     plan=plan_line(dp_fill, N_FULL, tt.shape[1], qq.shape[1], m, ms),
                     **fill_bound(int((qql.astype(np.int64) * ttl).sum()),
                                  OPS_FILL_DIRS, args, m, got)))

    S = tt.shape[1] + qq.shape[1] + 1
    wk, ms, wp, plain_ms, stats = timed_walk(device_walk, got.words, got.fy, got.fx, S, dev)
    check(all(torch.equal(a, b) for a, b in zip(wk, wp)),
          "device_walk != plain at the full-mode shape")
    rows.append(dict(name="device_walk (full-mode batch)", route="cuda",
                     source="aligner_tpu_torch/csrc/walk_core.cuh",
                     replaces=REPLACES["device_walk"], path=("pair", "service", "sharded"),
                     counter="walk",
                     max_abs_err=max(max_abs_err(a, b) for a, b in zip(wk, wp)),
                     ms=ms, plain_ms=plain_ms, shape=f"{N_FULL}x{S} steps",
                     plan=walk_plan_line(device_walk, dev, got.words, wk, ms, stats),
                     **walk_bound(got.fy, got.fx, wk)))
    rows.append(search_buckets(dev, at, dp_fill, scan_engine, q, m))
    print_rows(rows)
    return rows


def search_buckets(dev, at, dp_fill, scan_engine, query, m):
    """The fill on every length bucket of the 100k search, as
    ``search_database`` launches it (local, argmax tracked), timed one
    launch each with its plan; then the tallest bucket, whose columns do
    not fit on chip, held whole against its plain version (about a minute
    and a half of plain run)."""
    from aligner_tpu_torch.align import pad_batch
    from aligner_tpu_torch.search import length_buckets

    codes = search_db(at)[1]
    qq, qql = pad_batch([query])
    total = 0.0
    for bucket in length_buckets([len(c) for c in codes]):
        tt, ttl = pad_batch([codes[i] for i in bucket])
        B = len(bucket)
        args = tensors(dev, np.repeat(qq, B, 0), np.repeat(qql, B), tt, ttl)
        ms = gpu_ms(lambda: dp_fill.fill(*args, m, DEL, EXT), 1)
        total += ms
        print(f"  search bucket {B} x {tt.shape[1]} x {qq.shape[1]}: {ms:.3f} ms; "
              f"{plan_line(dp_fill, B, tt.shape[1], qq.shape[1], m, ms)}", flush=True)
    print(f"  search buckets in all: {total:.3f} ms", flush=True)
    B, R8 = len(bucket), tt.shape[1]
    check(dp_fill.launch_plan(B, R8, m).rows_on_chip < R8 + 1,
          "the tallest search bucket keeps its whole column on chip")
    args = tensors(dev, np.repeat(qq, B, 0), np.repeat(qql, B), tt, ttl)
    got, ms, want, plain_ms = timed_pair(
        lambda: dp_fill.fill(*args, m, DEL, EXT),
        lambda: scan_engine.fill_batch(*args, m, DEL, EXT), 3)
    check(same_fill(got, want), "dp_fill != plain on the tallest search bucket")
    cells = int((args[1].cpu().numpy().astype(np.int64) * ttl).sum())
    return dict(name="dp_fill (scores only, tallest search bucket, spilled rows)",
                route="cuda", source="aligner_tpu_torch/csrc/dp_fill.cu",
                replaces=REPLACES["dp_fill"], path="pair", counter="spilled",
                max_abs_err=max_abs_err(got.fmax, want.fmax), ms=ms, plain_ms=plain_ms,
                shape=f"{B}x{R8}x{qq.shape[1]}",
                plan=plan_line(dp_fill, B, R8, qq.shape[1], m, ms),
                **fill_bound(cells, OPS_FILL, args, m, got))


def scan_pwm(at, rng):
    """A PWM as the repeat search's first cycle makes it (calc.rs:156-164)."""
    return at.transform_matrix(at.random_pwm(PWM_W, rng), 0.0, PWM_DEL * PWM_EXT,
                               np.full(4, 0.25))


def phase_pwm_timing(dev, at, dp_fill, device_walk, scan_engine, repeat, seq):
    """K3's time beside its plain version's at the repeat search's shapes:
    one scan chunk of windows (336 x 300, f64, scores only, no argmax), and
    a survivor batch with directions plus the walk.  Then the scan chunk:
    the kernel per chunk and a whole cycle's scan of the 10 Mb chromosome
    at each chunk size."""
    rng = np.random.default_rng(SEED + 5)
    pwm64 = torch.as_tensor(scan_pwm(at, rng), device=dev)
    win = PWM_W + OFFSET
    n_max = max(*SCAN_CHUNKS, repeat.SCAN_CHUNK)
    q, ql = tensors(dev, rng.integers(0, 4, (n_max, win)), np.full(n_max, win))
    B = repeat.SCAN_CHUNK  # one chunk of the engine's scan
    qb, qlb = q[:B], ql[:B]
    rows, lines = [], []
    kw = dict(track_argmax=False)
    got, ms, want, plain_ms = timed_pair(
        lambda: dp_fill.fill_pwm(qb, qlb, pwm64, PWM_DEL, PWM_EXT, **kw),
        lambda: scan_engine.fill_pwm_batch(qb, qlb, pwm64, PWM_DEL, PWM_EXT, **kw), 3)
    check(same_fill(got, want), "PWM dp_fill != plain at the scan shape")
    R8 = -(-win // 8) * 8
    rows.append(dict(name="dp_fill PWM (scores only, window scan)", route="cuda",
                     source="aligner_tpu_torch/csrc/dp_fill.cu",
                     replaces=REPLACES["dp_fill"], path=("pwm", "sharded"),
                     counter="pwm_scores",
                     max_abs_err=max_abs_err(got.fmax, want.fmax), ms=ms,
                     plain_ms=plain_ms, shape=f"{B}x{R8}x{PWM_W} f64",
                     plan=plan_line(dp_fill, B, R8, PWM_W, pwm64, ms),
                     **fill_bound(B * win * PWM_W, OPS_FILL, (qb, qlb), pwm64, got)))
    pwm32 = pwm64.float()
    ms32 = gpu_ms(lambda: dp_fill.fill_pwm(qb, qlb, pwm32, PWM_DEL, PWM_EXT, **kw), 3)
    gcups = lambda ms, n: n * win * PWM_W / ms / 1e6  # noqa: E731
    lines.append(f"scan shape {B}x{R8}x{PWM_W}: f64 {ms:.3f} ms "
                 f"({gcups(ms, B):.1f} GCUPS), f32 {ms32:.3f} ms "
                 f"({gcups(ms32, B):.1f} GCUPS), plain f64 {plain_ms:.1f} ms")
    lines.append(f"f32 {plan_line(dp_fill, B, R8, PWM_W, pwm32, ms32)}")

    for c in SCAN_CHUNKS:
        ms_c = gpu_ms(lambda: dp_fill.fill_pwm(q[:c], ql[:c], pwm64, PWM_DEL, PWM_EXT,
                                               **kw), 3)
        lines.append(f"chunk {c}: kernel {ms_c:.3f} ms per launch, "
                     f"{ms_c * 1e6 / c:.1f} ns per window ({gcups(ms_c, c):.1f} GCUPS)")
    opts = repeat.SearchOptions(repeat_length=PWM_W, query_offset=OFFSET,
                                deletions=PWM_DEL, extension=PWM_EXT, device=DEVICE)
    wins = repeat.windows_of(len(seq), opts, OFFSET)
    pwm_np = pwm64.cpu().numpy()
    ref_scores = None
    for c in SCAN_CHUNKS + ((repeat.SCAN_CHUNK,) if repeat.SCAN_CHUNK
                            not in SCAN_CHUNKS else ()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs = repeat._scan_scores(seq, wins, pwm_np, opts, chunk=c)
        wall = time.perf_counter() - t0
        if ref_scores is None:
            ref_scores = fs
        check(np.array_equal(fs, ref_scores), f"scan scores depend on the chunk ({c})")
        lines.append(f"cycle scan, {len(wins)} windows, chunk {c}: {wall:.3f} s")

    # one align_pwm of a single window, the card against the host engine
    one = seq[:win]
    walls = {}
    for route in (DEVICE, "host"):
        res = at.align_pwm(one, pwm_np, PWM_DEL, PWM_EXT, device=route)  # warm-up
        t0 = time.perf_counter()
        for _ in range(5):
            res = at.align_pwm(one, pwm_np, PWM_DEL, PWM_EXT, device=route)
        walls[route] = ((time.perf_counter() - t0) / 5, res.alignment)
    check(np.array_equal(walls[DEVICE][1].numbered, walls["host"][1].numbered)
          and walls[DEVICE][1].f == walls["host"][1].f,
          "align_pwm on the card != the host engine")
    lines.append(f"align_pwm, one {win} x {PWM_W} problem, wall: {DEVICE} "
                 f"{walls[DEVICE][0] * 1e3:.3f} ms, host (native C++) "
                 f"{walls['host'][0] * 1e3:.3f} ms")

    qs, qls = q[:N_SURVIVORS].contiguous(), ql[:N_SURVIVORS].contiguous()
    kw = dict(with_dirs=True)
    got, ms, want, plain_ms = timed_pair(
        lambda: dp_fill.fill_pwm(qs, qls, pwm64, PWM_DEL, PWM_EXT, **kw),
        lambda: scan_engine.fill_pwm_batch(qs, qls, pwm64, PWM_DEL, PWM_EXT, **kw), 3)
    check(same_fill(got, want), "PWM dp_fill != plain at the survivor shape")
    rows.append(dict(name="dp_fill PWM (directions, survivors)", route="cuda",
                     source="aligner_tpu_torch/csrc/dp_fill.cu",
                     replaces=REPLACES["dp_fill"], path="pwm", counter="pwm_dirs",
                     max_abs_err=max(max_abs_err(got.fmax, want.fmax),
                                     max_abs_err(got.words, want.words)),
                     ms=ms, plain_ms=plain_ms,
                     shape=f"{N_SURVIVORS}x{R8}x{PWM_W} f64",
                     plan=plan_line(dp_fill, N_SURVIVORS, R8, PWM_W, pwm64, ms),
                     **fill_bound(N_SURVIVORS * win * PWM_W, OPS_FILL_DIRS, (qs, qls),
                                  pwm64, got)))
    S = win + PWM_W + 1
    wk, ms, wp, plain_ms, stats = timed_walk(device_walk, got.words, got.fy, got.fx, S, dev)
    check(all(torch.equal(a, b) for a, b in zip(wk, wp)),
          "device_walk != plain at the survivor shape")
    rows.append(dict(name="device_walk (PWM survivors)", route="cuda",
                     source="aligner_tpu_torch/csrc/walk_core.cuh",
                     replaces=REPLACES["device_walk"], path="pwm", counter="walk",
                     max_abs_err=max(max_abs_err(a, b) for a, b in zip(wk, wp)),
                     ms=ms, plain_ms=plain_ms, shape=f"{N_SURVIVORS}x{S} steps",
                     plan=walk_plan_line(device_walk, dev, got.words, wk, ms, stats),
                     **walk_bound(got.fy, got.fx, wk)))
    print_rows(rows)
    for line in lines:
        print(f"  {line}", flush=True)
    return rows


def phase_golden(at, read_fasta_file):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "fixtures", "examples_golden.json")) as fh:
        golden = json.load(fh)
    n = 0
    for example, cases in sorted(golden.items()):
        recs = read_fasta_file(os.path.join(here, "examples", f"{example}.fasta"))
        # every example, the DNA one included, is parsed as protein
        q = at.Protein.encode(recs[0].seq, strict=True)
        t = at.Protein.encode(recs[1].seq, strict=True)
        for key, want in cases.items():
            mode, d, e = key.split("_")
            (r,) = at.batch_align([q], [t], at.blosum62(), float(d[1:]),
                                  float(e[1:]), mode=mode, with_alignments=True,
                                  device=DEVICE)
            aln = r.alignment
            check(aln.f == want["f"], f"{example} {key}: f")
            check(tuple(map(tuple, aln.coords))
                  == tuple(map(tuple, want["coords"])), f"{example} {key}: coords")
            check(at.Protein.decode(aln.query) == want["query"], f"{example} {key}: query")
            check(at.Protein.decode(aln.target) == want["target"], f"{example} {key}: target")
            n += 1
    check(n == 12, f"expected 12 golden cases, ran {n}")
    return n


def held_p_value(at, native, q, t, f, del_, ext, m, shuffles, what):
    """K1's scores of the shuffles (``batch_align`` scores only, as
    ``calculate_p_value`` runs them) held against native C++ scores, bit
    for bit; returns the p-value of the fit on the native scores, with
    ``f`` the initial score."""
    got = at.batch_align([q] * len(shuffles), shuffles, m, del_, ext, track_argmax=False,
                         device=DEVICE).fmax.astype(np.float64)
    want = np.array([native.local_max_score_stream(q, s, m, del_, ext)[0]
                     for s in shuffles])
    check(np.array_equal(got, want), f"{what}: p-value shuffle scores != native C++")
    scores = np.concatenate([[f], want])
    lengths = np.concatenate([[len(t)], [len(s) for s in shuffles]])
    return at.statistics.calculate_distribution_params(
        len(q), lengths, scores).get_p_value(len(q), len(t), f)


def phase_p_value(at, native, q, t):
    m = at.blosum62()
    initial, _, _ = native.local_max_score_stream(q, t, m, DEL, EXT)
    t0 = time.perf_counter()
    p = at.calculate_p_value(q, t, initial, DEL, EXT, m, n_sequences=N_PVALUE,
                             rng=np.random.default_rng(SEED), device=DEVICE)
    wall = time.perf_counter() - t0
    sh = shuffles_for_p_value(at, q, t, N_PVALUE)
    p_native = held_p_value(at, native, q, t, initial, DEL, EXT, m, sh, "the pair")
    # bit-equal, NaN included: with h -> NaN the reference's fit returns NaN
    check(np.float64(p).tobytes() == np.float64(p_native).tobytes(),
          f"p-value {p!r} != native-score p-value {p_native!r}")
    print(f"  {len(sh)} shuffles, initial score {initial}, p = {p!r} "
          f"(calculate_p_value wall {wall:.3f} s)", flush=True)


def write_db(path, seqs, names):
    with open(path, "wb") as fh:
        for name, s in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n" + s + b"\n")


@functools.lru_cache(maxsize=1)
def search_db(at):
    """The seeded 100k-sequence protein database of the search phase: its
    records and their codes."""
    db = make_database(np.random.default_rng(SEED + 1))
    return db, [at.Protein.encode(s, strict=True) for s in db]


def make_database(rng):
    lengths = np.clip(np.round(rng.lognormal(np.log(300.0), 0.6, N_DB)), 30, 2000)
    lengths = lengths.astype(np.int64)
    letters = np.frombuffer(AMINO, np.uint8)[rng.integers(0, 20, int(lengths.sum()))]
    raw = letters.tobytes()
    ends = np.cumsum(lengths)
    return [raw[e - n:e] for e, n in zip(ends, lengths)]


def run_cli(main, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"aligner-search exited {rc}")
    hits = []
    for line in buf.getvalue().splitlines():
        if line.startswith("\tQ "):
            hits[-1]["q"] = line[3:]
        elif line.startswith("\tT "):
            hits[-1]["t"] = line[3:]
        else:
            rank, name, score = line.split("\t")
            hits.append(dict(name=name, score=float(score)))
    return hits, wall


def phase_search(at, native, host, cli_search, query, tmp):
    """aligner-search in-process: 100k-sequence database in local mode,
    its first 5,000 records in global mode."""
    from aligner_tpu_torch.backend import dtype_for
    from aligner_tpu_torch.observability import counters
    from aligner_tpu_torch.ops import dp_fill
    from aligner_tpu_torch.ops.scan_engine import round8
    from aligner_tpu_torch.search import length_buckets

    db, codes = search_db(at)
    names = [f"db{i}" for i in range(len(db))]
    m = at.blosum62()
    here = os.path.dirname(os.path.abspath(__file__))
    qfile = os.path.join(here, "examples", "protein.fasta")
    argvs = {}
    for mode, n in (("local", N_DB), ("global", N_DB_GLOBAL)):
        path = os.path.join(tmp, f"db_{mode}.fasta")
        write_db(path, db[:n], names[:n])
        argv = ["-q", qfile, "-i", path, "-k", "10", "--device", DEVICE]
        argv += ["--global"] if mode == "global" else []
        counters.reset()
        hits, wall = run_cli(cli_search.main, argv)
        kstats = counters.snapshot()
        check(len(hits) == 10, f"{mode}: expected 10 hits, got {len(hits)}")

        def native_score(i):
            if mode == "local":
                return native.local_max_score_stream(query, codes[i], m, DEL, EXT)[0]
            plane, _ = native.fill(query, codes[i], m, DEL, EXT, "global")
            return float(plane[len(codes[i]), len(query)])

        idx = [int(h["name"][2:]) for h in hits]
        for h, i in zip(hits, idx):
            check(h["score"] == native_score(i), f"{mode}: top hit {h['name']} score")
        # every score of the database from the port's search, against native
        # on a seeded sample
        allhits = at.search_database(query, codes[:n], m, DEL, EXT, k=n, mode=mode,
                                     with_alignments=False, device=DEVICE)
        scores = np.empty(n)
        for h in allhits:
            scores[h.index] = h.score
        check([h.index for h in allhits[:10]] == idx, f"{mode}: top-10 ranking")
        sample = np.random.default_rng(SEED + 2).choice(n, min(500, n), replace=False)
        for i in sample:
            check(scores[i] == native_score(int(i)), f"{mode}: db{i} score != native")
        # every record of the buckets whose columns spill off chip, which
        # the sample meets only by chance
        lens = [len(c) for c in codes[:n]]
        spilled = []
        for bucket in length_buckets(lens):
            R8 = round8(max(lens[i] for i in bucket))
            dt = dtype_for(DEVICE, m, DEL, EXT, lengths=(R8, len(query)))
            mt = torch.as_tensor(np.array(m), dtype=dt, device=DEVICE)
            if dp_fill.launch_plan(len(bucket), R8, mt).rows_on_chip <= R8:
                spilled.extend(int(i) for i in bucket)
        check(mode != "local" or spilled, "local: no search bucket spills")
        for i in spilled:
            check(scores[i] == native_score(i), f"{mode}: db{i} (spilled) score != native")
        # the winners' alignments: strings from the CLI, coords from the
        # port's batch path, both against the host engine
        res = at.batch_align([query] * 10, [codes[i] for i in idx], m, DEL, EXT,
                             mode=mode, with_alignments=True, device=DEVICE)
        align = host.align_local if mode == "local" else host.align_global
        for h, i, r in zip(hits, idx, res):
            ref = align(query, codes[i], m, DEL, EXT)
            check(h["q"] == at.Protein.decode(ref.query_aligned)
                  and h["t"] == at.Protein.decode(ref.target_aligned),
                  f"{mode}: {h['name']} strings != host")
            check(tuple(map(tuple, r.alignment.coords)) == tuple(map(tuple, ref.coords)),
                  f"{mode}: {h['name']} coords != host")
        cells = int(len(query) * sum(len(codes[i]) for i in range(n)))
        fill_s = sum(s.seconds for k, s in kstats.items())
        fill_cells = sum(s.cells for k, s in kstats.items())
        print(f"  {mode}: {n} records, {cells / 1e9:.3f} Gcells, CLI wall "
              f"{wall:.3f} s ({cells / wall / 1e9:.2f} GCUPS end to end), fills "
              f"{fill_s:.3f} s ({fill_cells / fill_s / 1e9:.2f} GCUPS), top score "
              f"{hits[0]['score']}; {len(spilled)} records of spilled buckets equal "
              f"native", flush=True)
        argvs[mode] = argv
    return argvs


def phase_trace(cli_search, argv, tmp):
    """The local search once more under ``torch.profiler``: device time by
    kernel and the device's idle share of the CLI's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hits, wall = run_cli(cli_search.main, argv)
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(tmp, "search_trace.json"))
    check(len(hits) == 10, "traced search: expected 10 hits")
    # device-side events only: a CPU op's self device time repeats the
    # copies and kernels it launched
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    top = ", ".join(
        f"{e.key.replace('void (anonymous namespace)::', '')[:60]} "
        f"{e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in rows[:4])
    print(f"  local search traced: CLI wall {wall:.3f} s, device busy {busy_s:.3f} s, "
          f"idle share {1.0 - busy_s / wall:.3f}; by device time: {top or 'none seen'}",
          flush=True)


def full_batch_pairs():
    """4,096 seeded pairs of 400 residues: each target is its query with a
    quarter of the positions substituted (homologous pairs, long walks)."""
    rng = np.random.default_rng(SEED + 3)
    qs = rng.integers(0, 20, (N_FULL, FULL_LEN)).astype(np.int8)
    ts = qs.copy()
    mask = rng.random(ts.shape) < 0.25
    ts[mask] = rng.integers(0, 20, int(mask.sum()))
    return list(qs), list(ts)


def phase_full_batch(at, native, host):
    m = at.blosum62()
    qs, ts = full_batch_pairs()
    sample = np.random.default_rng(SEED + 4).choice(N_FULL, min(256, N_FULL),
                                                   replace=False)
    for mode in ("local", "global"):
        t0 = time.perf_counter()
        res = at.batch_align(qs, ts, m, DEL, EXT, mode=mode, with_alignments=True,
                             device=DEVICE)
        wall = time.perf_counter() - t0
        if mode == "local":
            got = np.array([r.alignment.f for r in res])
            want = np.array([native.local_max_score_stream(q, t, m, DEL, EXT)[0]
                             for q, t in zip(qs, ts)])
        else:
            got = at.batch_align(qs, ts, m, DEL, EXT, mode="global",
                                 device=DEVICE).end.astype(np.float64)
            want = np.array([native.fill(q, t, m, DEL, EXT, "global")[0][-1, -1]
                             for q, t in zip(qs, ts)])
        check(np.array_equal(got, want), f"full batch {mode}: scores != native C++")
        align = host.align_local if mode == "local" else host.align_global
        for i in sample:
            ref = align(qs[i], ts[i], m, DEL, EXT)
            a = res[i].alignment
            check(np.array_equal(a.query, ref.query_aligned)
                  and np.array_equal(a.target, ref.target_aligned)
                  and tuple(map(tuple, a.coords)) == tuple(map(tuple, ref.coords)),
                  f"full batch {mode}: alignment {i} != host")
        print(f"  {mode}: {N_FULL} pairs of {FULL_LEN}, batch_align with alignments "
              f"{wall:.3f} s", flush=True)


def population_inputs(at, read_fasta_file):
    """One service request's population: the examples/protein.fasta pair,
    POP_M starting matrices and the pair's symbol frequencies, made by the
    service's own ``get_population`` and ``symbol_frequencies`` (the
    dispatcher's seed POP_SEED, an empty store)."""
    from aligner_tpu_torch.service.dispatcher import symbol_frequencies
    from aligner_tpu_torch.service.store import Store, get_population

    here = os.path.dirname(os.path.abspath(__file__))
    recs = read_fasta_file(os.path.join(here, "examples", "protein.fasta"))
    s1, s2 = recs[0].seq.decode(), recs[1].seq.decode()
    q = at.Protein.encode(s1, strict=False)
    t = at.Protein.encode(s2, strict=False)
    with tempfile.TemporaryDirectory() as tmp:
        mats = np.stack(get_population(Store(os.path.join(tmp, "population.db")), POP_DIM,
                                       POP_M, np.random.default_rng(POP_SEED)))
    h = at.Heuristics(kd=POP_KD, r_squared=POP_R2,
                      frequencies=symbol_frequencies(s1, s2, POP_DIM))
    return q, t, mats, h


def first_iteration(dev, at, dp_fill, device_walk, pop):
    """The population's first iteration up to its walk, as
    heuristic_align_population runs it: the numpy-transformed starting
    matrices, one batched fill with directions, one batched walk."""
    from aligner_tpu_torch.align import pad_batch

    q, t, mats, h = pop
    M = len(mats)
    trans = np.stack([at.transform_matrix(m, h.kd, h.r_squared, h.frequencies)
                      for m in mats])
    q2, ql = pad_batch([q] * M)
    t2, tl = pad_batch([t] * M)
    q2, ql, t2, tl = tensors(dev, q2, ql, t2, tl)
    trans = torch.as_tensor(trans, device=dev)
    r = dp_fill.fill(q2, ql, t2, tl, trans, POP_DEL, POP_DEL, mode="local", with_dirs=True)
    S = q2.shape[1] + t2.shape[1] + 1
    steps, n, _, _ = device_walk.walk(r.words, r.fy, r.fx, S=S, mode="local")
    return dict(q2=q2, ql=ql, t2=t2, tl=tl, trans=trans, r=r, steps=steps, n=n,
                alive=torch.ones(M, dtype=torch.bool, device=dev))


def counting_walk_cases(dev, dp_fill, device_walk, rng):
    """The counting walk's ragged cases as (name, args without S, S): words
    of the kernel fill from its argmax cells (per-problem f64 matrices, a
    share of the members done, n = 0 from (0, 0), and a share stale, not
    alive with a stream) and raw codes from random starts, some off the
    plane; M not a multiple of a block's warps, S not a multiple of 16, V =
    1, 24 and 55, a plane 16 columns wide (its ring smaller than its
    counts), a thousand members."""
    cases = []
    for M, R, C, V, kind, done_frac, stale_frac in (
            (POP_M, 344, 344, 24, "fill", 0.4, 0.1), (37, 45, 40, 24, "fill", 0.25, 0.2),
            (9, 30, 21, 1, "fill", 0.2, 0.2), (13, 40, 48, 55, "fill", 0.2, 0.3),
            (21, 64, 16, 24, "fill", 0.2, 0.2), (53, 48, 72, 24, "raw", 0.2, 0.2),
            (1_000, 344, 344, 24, "raw", 0.1, 0.1)):
        q, t = rng.integers(0, V, (M, C)), rng.integers(0, V, (M, R))
        done = rng.random(M) < done_frac
        alive = torch.as_tensor(~done & ~(rng.random(M) < stale_frac), device=dev)
        if kind == "fill":
            t[: M // 2, : min(R, C)] = q[: M // 2, : min(R, C)]
            qd, ql, td, tl = tensors(dev, q, np.where(done, 0, C), t, np.where(done, 0, R))
            mats = torch.as_tensor(rng.normal(0.0, 2.0, (M, V, V)) + 3.0 * np.eye(V),
                                   device=dev)
            r = dp_fill.fill(qd, ql, td, tl, mats, 5.0, 2.0, mode="local", with_dirs=True)
            words, sy, sx = r.words, r.fy, r.fx
        else:
            R8 = -(-R // 8) * 8
            codes = rng.choice([0, 1, 2, 3], size=(M, R8, C), p=[0.3, 0.3, 0.38, 0.02])
            words = device_walk.pack_codes(codes, 8).to(dev)
            sy, sx = rng.integers(1, R8 + 1, M), rng.integers(1, C + 1, M)
            sy[:4], sx[:4] = [R8 + 3, R8 + 9, 20, -1], [30, C + 5, C + 17, 5]
            sy[done], sx[done] = 0, 0
            qd, td, sy, sx = tensors(dev, q, t, sy, sx)
        S = words.shape[1] * 8 + C + 1
        cases.append((f"M={M}, {R}x{C}, V={V}, {kind}", (words, sy, sx, qd, td, alive, V), S))
    return cases


def counts_vs_plain(dev, at, dp_fill, device_walk, freq_count, pop) -> int:
    """The frequency count against its plain version, torch.equal, on the
    population's first iteration and on ragged cases (done members, walks
    of the full S, walks on the plane into a second round, M not a multiple
    of a block's warps, V = 4, a thousand members); the counting walk
    against its plain version on the population's first iteration and on
    counting_walk_cases; then the batched transform on the card against
    numpy's on the population's first-iteration counts, bit for bit."""
    from aligner_tpu_torch.matrices import transform_matrix_torch

    it = first_iteration(dev, at, dp_fill, device_walk, pop)
    args = (it["steps"], it["n"], it["r"].fy, it["r"].fx, it["q2"], it["t2"], it["alive"])
    counts = freq_count.count_pairs(*args, POP_DIM)
    check(torch.equal(counts, freq_count.count_pairs_plain(*args, POP_DIM)),
          "freq_count != plain at the population's shape")
    rng = np.random.default_rng(SEED + 22)
    cases = [(POP_M, 344, 344, 24, "random", 0.4), (POP_M, 344, 344, 24, "full", 0.0),
             (POP_M, 344, 344, 24, "in-plane", 0.2), (7, 40, 56, 24, "full", 0.3),
             (33, 120, 100, 4, "random", 0.2), (1_000, 344, 344, 24, "random", 0.1)]
    for M, R, C, V, kind, done in cases:
        args = [a.to(dev) for a in freq_count.ragged_streams(rng, M, R, C, V, kind=kind,
                                                            done_frac=done)]
        check(torch.equal(freq_count.count_pairs(*args, V),
                          freq_count.count_pairs_plain(*args, V)),
              f"freq_count != plain (M={M}, {R}x{C}, V={V}, {kind}, done={done})")
    r = it["r"]
    walk_args = (r.words, r.fy, r.fx, it["q2"], it["t2"], it["alive"], POP_DIM)
    S = it["q2"].shape[1] + it["t2"].shape[1] + 1
    walked = device_walk.walk_counts(*walk_args, S=S)
    check(torch.equal(walked, device_walk.walk_counts_plain(*walk_args, S=S))
          and torch.equal(walked, counts),
          "the counting walk != plain (or != walk + count) at the population's shape")
    walk_cases = counting_walk_cases(dev, dp_fill, device_walk, rng)
    for name, a, S in walk_cases:
        check(torch.equal(device_walk.walk_counts(*a, S=S),
                          device_walk.walk_counts_plain(*a, S=S)),
              f"the counting walk != plain ({name})")
    h = pop[3]
    got = transform_matrix_torch(counts.double(), h.kd, h.r_squared,
                                 h.frequencies).cpu().numpy()
    c = counts.cpu().numpy().astype(np.float64)
    for m in range(len(c)):
        try:
            want = at.transform_matrix(c[m], h.kd, h.r_squared, h.frequencies)
        except at.WrongMatrixSpecified:
            check(np.isnan(got[m]).all(), f"transform of member {m}: numpy raised, not NaN")
            continue
        check(np.array_equal(got[m], want),
              f"transform_matrix_torch != numpy on member {m}'s first counts")
    return 3 + len(cases) + len(walk_cases)


def population_count_rows(dev, at, dp_fill, device_walk, freq_count, pop):
    """The standalone count's row and the counting walk's at the
    population's shape: each kernel's time queued behind a busy kernel (a
    call is as short as its launch), its plain version's, its bound from
    this run's walks; walk + count (the earlier build of the population's
    path) and the counting walk timed in turns, earlier, counting,
    counting, earlier; and one population iteration split by CUDA events
    both ways, in turns: fill, walk, count, transform with the state
    update, the host's read of ``done``; and fill, counting walk, transform,
    read."""
    from aligner_tpu_torch.matrices import transform_matrix_torch
    from aligner_tpu_torch.ops.walk_probe import queued_ms

    it = first_iteration(dev, at, dp_fill, device_walk, pop)
    r = it["r"]
    q2, t2, alive = it["q2"], it["t2"], it["alive"]
    S = q2.shape[1] + t2.shape[1] + 1
    args = (it["steps"], it["n"], r.fy, r.fx, q2, t2, alive)
    walk_args = (r.words, r.fy, r.fx, q2, t2, alive, POP_DIM)

    def walk_then_count():
        steps, n, _, _ = device_walk.walk(r.words, r.fy, r.fx, S=S, mode="local")
        return freq_count.count_pairs(steps, n, r.fy, r.fx, q2, t2, alive, POP_DIM)

    def counting_walk():
        return device_walk.walk_counts(*walk_args, S=S)

    ms = queued_ms(lambda: freq_count.count_pairs(*args, POP_DIM), 20)
    turns = []
    for name, fn in (("walk + count", walk_then_count), ("counting walk", counting_walk),
                     ("counting walk", counting_walk), ("walk + count", walk_then_count)):
        turns.append((name, queued_ms(fn, 20)))
    walk_ms = queued_ms(lambda: device_walk.walk(r.words, r.fy, r.fx, S=S, mode="local"), 20)
    got = freq_count.count_pairs(*args, POP_DIM)
    got_w = counting_walk()
    got_wc = walk_then_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = freq_count.count_pairs_plain(*args, POP_DIM)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want_w = device_walk.walk_counts_plain(*walk_args, S=S)
    torch.cuda.synchronize()
    plain_w_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want), "freq_count != plain in the timing phase")
    check(torch.equal(got_w, want_w) and torch.equal(got_w, got) and torch.equal(got_wc, got),
          "the counting walk != plain (or != walk + count) in the timing phase")
    n_steps = int(it["n"].sum())
    pairs = int(got.sum())
    words = int(((it["n"] + 15) // 16).sum())
    count_ops = OPS_COUNT_STEP * n_steps
    count_bytes = 4 * words + 8 * pairs + nbytes(it["n"], r.fy, r.fx, alive) + nbytes(got)
    shape = f"{POP_M}x{it['steps'].shape[0] * 16} steps, V={POP_DIM}"
    row = dict(name="freq_count (standalone count, off the population's path)",
               route="cuda", source="aligner_tpu_torch/csrc/freq_count.cu",
               replaces=REPLACES["freq_count"], path=("population", "service"),
               counter="freq_count",
               max_abs_err=max_abs_err(got, want), ms=ms, plain_ms=plain_ms, shape=shape,
               plan=(f"one warp a member, blocks of 4 warps, {POP_DIM * POP_DIM * 4} B of "
                     f"counts a warp; {n_steps} steps, {pairs} pairs counted"),
               **bound(count_ops, count_bytes))
    wk = device_walk.walk(r.words, r.fy, r.fx, S=S, mode="local")
    p = device_walk.walk_plan(POP_M, r.words.shape[2], dev)
    ring = 4 * (8 * (p.span + 8) + 8)  # walk::ring_ints(WALK_DEPTH, span) ints
    w_ms = [t for name, t in turns if name == "counting walk"]
    # the counting walk's bound from its own traffic: a word read a step,
    # the two codes of each pair counted, the starts and ``alive`` read, the
    # counts written (its stream and end cells never leave the call)
    row_w = dict(name="walk_count (counting walk: K4 with the count, heuristic population)",
                 route="cuda", source="aligner_tpu_torch/csrc/walk_core.cuh",
                 replaces=REPLACES["walk_count"], path=("population", "service"),
                 counter="walk_count", max_abs_err=max_abs_err(got_w, want_w),
                 ms=sum(w_ms) / len(w_ms), plain_ms=plain_w_ms, shape=shape,
                 plan=(f"one warp a member, {p.blocks} blocks of {p.warps} warps, a ring "
                       f"of {ring} B a warp, then {POP_DIM * POP_DIM * 4} B of counts in "
                       f"its place; longest walk {int(wk[1].max())} steps"),
                 **bound(OPS_WALK_STEP * n_steps + count_ops,
                         4 * n_steps + 8 * pairs + nbytes(r.fy, r.fx, alive, got_w)))
    print("  walk + count against the counting walk at the population's shape, queued, "
          "in turns (ms): " + ", ".join(f"{name} {t!r}" for name, t in turns)
          + f"; K4 alone {walk_ms!r}, the count alone {ms!r}", flush=True)
    # one iteration, split, the two builds in turns
    h = pop[3]
    M = len(pop[2])
    max_f = torch.zeros(M, dtype=torch.float64, device=dev)
    done = torch.zeros(M, dtype=torch.bool, device=dev)
    freqs = torch.as_tensor(h.frequencies, device=dev)
    splits = {False: np.zeros(5), True: np.zeros(4)}
    reps = 5
    for rep in range(2 * (reps + 1)):
        fused = rep % 2 == 1
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6 if not fused else 5)]
        ev[0].record()
        ql = torch.where(done, 0, it["ql"])
        tl = torch.where(done, 0, it["tl"])
        rr = dp_fill.fill(q2, ql, t2, tl, it["trans"], POP_DEL, POP_DEL, mode="local",
                          with_dirs=True)
        ev[1].record()
        alive = ~done
        if fused:
            counts = device_walk.walk_counts(rr.words, rr.fy, rr.fx, q2, t2, alive, POP_DIM,
                                             S=S)
        else:
            steps, n, _, _ = device_walk.walk(rr.words, rr.fy, rr.fx, S=S, mode="local")
            ev[2].record()
            counts = freq_count.count_pairs(steps, n, rr.fy, rr.fx, q2, t2, alive, POP_DIM)
        ev[-3].record()
        newt = transform_matrix_torch(counts.double(), h.kd, h.r_squared, freqs)
        newly_dead = alive & ((rr.fy == 0) | (rr.fx == 0))
        improved = alive & ~newly_dead & (rr.fmax > max_f)
        trans = torch.where(improved[:, None, None], newt, it["trans"])
        after = done | (alive & ~improved)
        ev[-2].record()
        bool(after.all())
        ev[-1].record()
        torch.cuda.synchronize()
        if rep >= 2:
            splits[fused] += [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    del trans
    a, b = splits[False] / reps, splits[True] / reps
    plan = dp_fill.launch_plan(M, t2.shape[1], it["trans"])
    sms = dp_fill.card_limits(dev).sms
    print(f"  one population iteration ({M} members, {t2.shape[1]}x{q2.shape[1]} padded, "
          f"f64), CUDA events, mean of {reps}, in turns: walk + count: fill {a[0]:.4f} ms, "
          f"walk {a[1]:.4f} ms, count {a[2]:.4f} ms, transform and state {a[3]:.4f} ms, "
          f"read of done {a[4]:.4f} ms, {a.sum():.4f} ms in all; the counting walk: fill "
          f"{b[0]:.4f} ms, counting walk {b[1]:.4f} ms, transform and state {b[2]:.4f} ms, "
          f"read of done {b[3]:.4f} ms, {b.sum():.4f} ms in all; the fill occupies {M} "
          f"threads ({plan.threads} a block, {-(-M // plan.threads)} block(s)) of a card of "
          f"{sms} SMs", flush=True)
    return [row, row_w]


def host_heuristic(at, host, q, t, matrix, h):
    """heuristic_align's loop on the host engine (native C++ fill, Python
    walk) with numpy's transforms: ((alignment, matrix) or None for a
    member with no positive-scoring cell, the alignments it ran)."""
    r2 = h.r_squared if abs(h.r_squared) >= np.finfo(np.float64).eps \
        else float(matrix.shape[0] * matrix.shape[1])
    trans = at.transform_matrix(matrix, h.kd, r2, h.frequencies)
    max_f = 0.0
    for it in range(1, POP_MAX_ITERS + 1):
        cur = trans
        try:
            r = host.align_local(q, t, cur, POP_DEL, POP_DEL)
        except at.ResultIsEmpty:
            return None, it
        aln = at.Alignment(r.query_aligned, r.target_aligned, r.coords, r.f, at.Protein)
        if r.f > max_f:
            max_f = r.f
            trans = at.transform_matrix(aln.frequency_matrix(), h.kd, r2, h.frequencies)
        else:
            return (aln, cur), it
    return (aln, cur), POP_MAX_ITERS


def same_heuristic(got, want) -> bool:
    if want is None or got is None:
        return want is None and got is None
    aln, matrix = want
    a = got.alignment
    return (a.f == aln.f and np.array_equal(a.query, aln.query)
            and np.array_equal(a.target, aln.target)
            and tuple(map(tuple, a.coords)) == tuple(map(tuple, aln.coords))
            and np.array_equal(got.matrix, matrix))


def phase_population(at, host, pop) -> int:
    """The service worker's job: warmup_population, then
    heuristic_align_population of POP_M starting matrices on the card, every
    member held bit for bit against heuristic_align's loop on the host
    engine; then one heuristic_align of the pair from BLOSUM62 on the card,
    held the same way.  Returns the population's iterations (the longest
    member's loop on the host)."""
    q, t, mats, h = pop
    at.warmup_population(q, t, len(mats), POP_DEL, POP_DEL, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = at.heuristic_align_population(q, t, mats, POP_DEL, POP_DEL, h, device=DEVICE)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [host_heuristic(at, host, q, t, m, h) for m in mats]
    host_wall = time.perf_counter() - t0
    iters = max(k for _, k in want)
    for m, (res, (w, _)) in enumerate(zip(got, want)):
        check(same_heuristic(res, w), f"population member {m} != heuristic_align's loop on "
                                      f"the host")
    dead = sum(r is None for r in got)
    fs = [r.alignment.f for r in got if r is not None]
    print(f"  heuristic_align_population: {len(mats)} members of {len(t)}x{len(q)}, "
          f"V={mats.shape[-1]}, kd {h.kd}, r2 {h.r_squared:g}, del = ext = {POP_DEL}: "
          f"{wall:.3f} s, {iters} iterations; {dead} dead, f {min(fs, default=0):.4f}.."
          f"{max(fs, default=0):.4f}; the host loop {host_wall:.3f} s, every member "
          f"equal", flush=True)
    b62 = np.array(at.blosum62())
    t0 = time.perf_counter()
    one = at.heuristic_align(q, t, b62, POP_DEL, POP_DEL, h, device=DEVICE)
    wall = time.perf_counter() - t0
    w, k = host_heuristic(at, host, q, t, b62, h)
    check(same_heuristic(one, w), "heuristic_align from BLOSUM62 != its loop on the host")
    print(f"  heuristic_align from BLOSUM62: {wall:.3f} s, {k} iterations, f "
          f"{one.alignment.f:.4f}, equal to the host loop", flush=True)
    return iters


def service_fasta(at, read_fasta_file) -> str:
    """The service request's FASTA: the two records of examples/protein.fasta
    and a homolog of each, a quarter of its positions substituted (as
    full_batch_pairs makes its pairs), from SERVICE_SEED."""
    here = os.path.dirname(os.path.abspath(__file__))
    recs = read_fasta_file(os.path.join(here, "examples", "protein.fasta"))
    rng = np.random.default_rng(SERVICE_SEED)
    out = [(r.id, r.seq.decode()) for r in recs]
    for r in recs:
        t = at.Protein.encode(r.seq, strict=True)
        mask = rng.random(len(t)) < 0.25
        t[mask] = rng.integers(0, 20, int(mask.sum()))
        out.append((f"{r.id}_homolog", at.Protein.decode(t)))
    return "".join(f">{name}\n{seq}\n" for name, seq in out)


def sql_rows(db, sql, args=()):
    import sqlite3

    with contextlib.closing(sqlite3.connect(db, timeout=30.0)) as c:
        return c.execute(sql, args).fetchall()


def run_service_worker(db, n_batches, out_path):
    """Start one worker process on ``db``; its stdout and log go to
    ``out_path``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ALIGNER_DB=db, ALIGNER_LOG="info",
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("ALIGNER_QUEUE", None)
    with open(out_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-c", WORKER_RUNNER, "--device", DEVICE, "--warmup",
             "--batch", str(SERVICE_BATCH), "--poll-interval", str(SERVICE_POLL_S),
             "--max-batches", str(n_batches + SERVICE_IDLE_POLLS)],
            cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT, text=True)


def hold_subtasks(at, host, db, models):
    """Every stored subtask against heuristic_align's loop on the host
    engine for its job's pair and starting matrix: f as float64 bytes, the
    final matrix's JSON text, the result strings; a job whose member has no
    alignment stores no row.  Returns the subtask rows by task hash and the
    iterations of each task's population (its longest member's loop)."""
    jobs = {int(i): models.AlignJob.from_json(p)
            for i, p in sql_rows(db, "select id, payload from jobs")}
    got = {}
    by_task = {}
    for h, key, f, mj, rq, rt in sql_rows(db, """
            select t.hash, s.source_key, s.f_value, s.matrix_json,
                   s.result_query_sequence, s.result_target_sequence
            from align_subtasks s join align_tasks t on t.id = s.task_id"""):
        check(jobs[int(key)].hash == h, f"subtask of job {key} stored under task {h}")
        got[int(key)] = (np.float64(f).tobytes(), mj, rq, rt)
        by_task.setdefault(h, []).append((f, mj, rq, rt))
    iters = {}
    for job_id, job in sorted(jobs.items()):
        check(job.del_value == POP_DEL, f"job {job_id}: del {job.del_value}")
        h = at.Heuristics(kd=job.kd_value, r_squared=job.r_squared_value,
                          frequencies=job.frequences)
        res, k = host_heuristic(at, host, at.Protein.encode(job.sequence_1, strict=False),
                                at.Protein.encode(job.sequence_2, strict=False),
                                job.matrix, h)
        iters[job.hash] = max(iters.get(job.hash, 0), k)
        if res is None:
            check(job_id not in got, f"job {job_id}: a subtask for a member with no "
                                     f"alignment")
            continue
        aln, matrix = res
        want = (np.float64(aln.f).tobytes(), models.matrix_to_json(matrix), *aln.render())
        check(got.get(job_id) == want, f"job {job_id}: the stored subtask != "
                                       f"heuristic_align's loop on the host")
    return by_task, iters


def hold_p_values(at, native, store, ids, seed):
    """Each task's K1 scores of its shuffles against native C++ scores,
    and each stored p-value against the fit on those native scores, bit
    for bit, NaN stored as NULL: calc's one generator replayed over the
    tasks in the order calc took them."""
    rng = np.random.default_rng(seed)
    for task_id in ids:
        query, target, f, del_, matrix = store.get_result_matrix_by_task_id(task_id)
        q = at.Protein.encode(query, strict=False)
        t = at.Protein.encode(target, strict=False)
        sh = [at.statistics.shuffle_and_randomize_sequence(t, rng)
              for _ in range(N_PVALUE - 1)]
        want = held_p_value(at, native, q, t, f, del_, del_, matrix, sh, f"task {task_id}")
        (got,), = sql_rows(store.path, "select p_value from align_tasks where id = ?",
                           (task_id,))
        check((got is None and np.isnan(want))
              or (got is not None and np.float64(got).tobytes() == np.float64(want).tobytes()),
              f"task {task_id}: stored p-value {got!r} != native-score fit {want!r}")


def phase_service(at, native, host, read_fasta_file, tmp, launch_counts):
    """The service end to end (phase 8): returns the worker process's
    launch counts, this process's (``launch_counts()`` read just after
    calc, before the holds launch K1 again) and the iterations the
    worker's populations ran."""
    import re

    from aligner_tpu_torch.cli import calc
    from aligner_tpu_torch.service import models, updater
    from aligner_tpu_torch.service.dispatcher import TOPIC_JOBS, Dispatcher, serve
    from aligner_tpu_torch.service.queue import JobQueue
    from aligner_tpu_torch.service.store import Store

    db = os.path.join(tmp, "service.db")
    store, queue = Store(db), JobQueue(db)
    server = serve("127.0.0.1", 0, Dispatcher(store, queue,
                                             rng=np.random.default_rng(POP_SEED)),
                   sse_ticks=1)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    worker = None
    try:
        body = json.dumps({"sequences": service_fasta(at, read_fasta_file),
                           "kdValue": POP_KD, "rSquaredValue": POP_R2, "delValue": POP_DEL,
                           "dimValue": POP_DIM, "matricesVolumeValue": POP_M}).encode()
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{base}/validate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            hashes = json.loads(r.read())["hashes"]
        submit = time.perf_counter() - t0
        n_jobs = queue.pending(TOPIC_JOBS)
        check(len(hashes) == 6 and n_jobs == 6 * POP_M,
              f"the request made {len(hashes)} tasks and {n_jobs} jobs, not 6 and "
              f"{6 * POP_M}")
        log_path = os.path.join(tmp, "worker.log")
        t1 = time.perf_counter()
        worker = run_service_worker(db, n_jobs // SERVICE_BATCH, log_path)
        first_claim = None
        while queue.pending(TOPIC_JOBS) > 0:
            if first_claim is None and sql_rows(
                    db, "select count(1) from jobs where status != 'ready'")[0][0]:
                first_claim = time.perf_counter() - t1
            check(worker.poll() is None, f"the worker exited ({worker.returncode}) with "
                  f"jobs pending:\n{open(log_path).read()[-4000:]}")
            check(time.perf_counter() - t1 < SERVICE_DEADLINE_S,
                  "the queue did not drain in time")
            time.sleep(0.05)
        drained = time.perf_counter() - t0
        rc = worker.wait(timeout=SERVICE_IDLE_POLLS * SERVICE_POLL_S + 120)
        log_text = open(log_path).read()
        check(rc == 0, f"the worker exited {rc}:\n{log_text[-4000:]}")
        launches = re.findall(r"^launches (\{.*\})$", log_text, re.M)
        check(len(launches) == 1, "the worker printed no launch counts")
        pops = [float(x) for x in re.findall(r"population of \d+ job\(s\) in ([0-9.]+) s",
                                             log_text)]
        batches = [(int(n), float(x)) for n, x in re.findall(
            r"batch of (\d+) job\(s\): claim to commit ([0-9.]+) s", log_text)]
        check(len(pops) == len(hashes) and sum(n for n, _ in batches) == n_jobs,
              f"the worker logged {len(pops)} populations and {len(batches)} batches")
        t_hold = time.perf_counter()
        by_task, iters = hold_subtasks(at, host, db, models)
        hold_s = time.perf_counter() - t_hold
        for h in hashes:
            check(len(by_task.get(h, [])) == POP_M,
                  f"task {h}: {len(by_task.get(h, []))} subtasks, not {POP_M}")
        t2 = time.perf_counter()
        with urllib.request.urlopen(f"{base}/progress?hashes={','.join(hashes)}",
                                    timeout=120) as r:
            line = r.readline().decode()
        promote = time.perf_counter() - t2
        check(line.startswith("data: ") and set(json.loads(line[6:])["progress"].values())
              == {100.0}, f"/progress did not report every task done: {line!r}")
        check(updater.run_once(store) == 0, "the updater promoted a task /progress had not")
        results = sql_rows(db, """select t.hash, r.f_value, r.matrix_json,
                                         r.result_query_sequence, r.result_target_sequence
                                  from result_matrices r
                                  join align_tasks t on t.id = r.task_id""")
        check(sorted(h for h, *_ in results) == sorted(hashes), "not one result a task")
        for h, *best in results:
            top = max(f for f, *_ in by_task[h])
            check(best[0] == top and tuple(best) in set(by_task[h]),
                  f"task {h}: the promoted result is not its best subtask")
        ids = store.get_ids_with_null_p_value()
        check(len(ids) == len(hashes), f"{len(ids)} tasks wait for a p-value")
        t3 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            check(calc.main(["--db", db, "--seed", "0", "--device", DEVICE,
                             "--sequences", str(N_PVALUE)]) == 0,
                  "aligner-torch-calc failed")
        calc_wall = time.perf_counter() - t3
        calc_counts = launch_counts()
        check(out.getvalue().strip() == f"backfilled {len(ids)} p-value(s)",
              f"aligner-torch-calc: {out.getvalue()!r}")
        t4 = time.perf_counter()
        hold_p_values(at, native, store, ids, 0)
        p_hold_s = time.perf_counter() - t4
        nan = sql_rows(db, "select count(1) from align_tasks where p_value is null")[0][0]
    finally:
        server.shutdown()
        if worker is not None and worker.poll() is None:
            worker.kill()
            worker.wait(timeout=60)
    claim_s = sum(x for _, x in batches)
    print(f"  {n_jobs} jobs, {len(hashes)} tasks of {POP_M}: submit {submit:.3f} s; the "
          f"worker's first claim {first_claim:.3f} s after its start (process, library "
          f"load, warmup); queue drained {drained:.3f} s after the POST; /progress promoted "
          f"every task in {promote:.3f} s: time to promotion {drained + promote:.3f} s (the "
          f"host hold between them, {hold_s:.3f} s, not counted); claim to commit "
          f"{claim_s:.3f} s in {len(batches)} batches, {n_jobs / claim_s:.1f} jobs/s; "
          f"population a task {min(pops):.3f}..{max(pops):.3f} s (mean "
          f"{np.mean(pops):.3f}), {sum(iters.values())} iterations in all; every subtask "
          f"equal to the host loop, every task promoted its best; aligner-torch-calc "
          f"{calc_wall:.3f} s, {calc_wall / len(ids):.3f} s a p-value ({nan} NaN, stored as "
          f"NULL), every task's K1 scores equal to native C++ and every p-value equal to "
          f"the native-score fit (held in {p_hold_s:.3f} s)",
          flush=True)
    return json.loads(launches[0]), calc_counts, sum(iters.values())


def make_chromosome(bp: int, seed: int, n_planted: int):
    """Random DNA with ``n_planted`` mutated copies of one 330-base query
    at regular offsets (bench_chromosome.make_chromosome: the testing-mode
    construction, cmd/testing.rs:52-57, scaled up).  Returns the sequence
    as ASCII bytes and the planted positions."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ATCG", np.uint8)
    seq = letters[rng.integers(0, 4, bp)]
    query = letters[rng.integers(0, 4, PLANT_LEN)]
    stride = bp // (n_planted + 1)
    planted = []
    for i in range(n_planted):
        copy = query.copy()
        # every 4th position randomized, phase i (engine/mod.rs:17-47)
        idx = np.arange(i % 4, len(copy), 4)
        copy[idx] = letters[rng.integers(0, 4, len(idx))]
        pos = (i + 1) * stride
        seq[pos : pos + len(copy)] = copy
        planted.append(pos)
    return seq.tobytes(), planted


def write_chromosome(path, raw: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(b">chr_synthetic\n")
        for lo in range(0, len(raw), 80):
            fh.write(raw[lo : lo + 80] + b"\n")


class _ScanLog(logging.Handler):
    """Collects the engine's per-cycle scan records (windows, survivors)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.cycles = []

    def emit(self, record):
        if record.msg.startswith("repeat scan:"):
            self.cycles.append(record.args)


def phase_repeat_search(at, native, host, cli_repeat, repeat, raw, planted, tmp):
    """``aligner-repeat-search`` in-process, exploring mode with a
    checkpoint, at the reference defaults on the 10 Mb chromosome; then
    one more cycle from the completed checkpoint, held against native C++
    and the host engine."""
    from aligner_tpu_torch.observability import counters, log
    from aligner_tpu_torch.service.models import matrix_from_json

    fasta = os.path.join(tmp, "chrom.fasta")
    write_chromosome(fasta, raw)
    out = os.path.join(tmp, "output.csv")
    ck = os.path.join(tmp, "scan.ckpt")
    argv = ["-i", fasta, "-o", out, "--checkpoint", ck, "-r", str(PWM_W), "-q",
            str(OFFSET), "-d", str(int(PWM_DEL)), "-e", str(int(PWM_EXT)),
            "--repeats", str(REPEATS), "--seed", "0", "--device", DEVICE]
    scan_log = _ScanLog()
    log.addHandler(scan_log)
    # the CLI sets the package logger's level from ALIGNER_LOG
    level, env = log.level, os.environ.get("ALIGNER_LOG")
    os.environ["ALIGNER_LOG"] = "info"
    counters.reset()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_repeat.main(argv)
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(scan_log)
        log.setLevel(level)
        if env is None:
            del os.environ["ALIGNER_LOG"]
        else:
            os.environ["ALIGNER_LOG"] = env
    kstats = counters.snapshot()
    check(rc == 0, f"aligner-repeat-search exited {rc}")

    with open(out, newline="") as fh:
        rows = list(csv.DictReader(fh))
    check(all(r["name"] == "chr_synthetic" and np.isfinite(float(r["z_value"]))
              and 0 <= int(r["left_coord"]) < int(r["right_coord"]) <= len(raw)
              for r in rows), "output.csv is malformed")
    with open(out + ".matrices.json") as fh:
        mats = json.load(fh)
    check(list(mats) == ["chr_synthetic"], "matrices.json keys")
    m = mats["chr_synthetic"]
    check(m["v"] == 1 and m["dim"] == [4, PWM_W] and len(m["data"]) == 4 * PWM_W
          and np.isfinite(m["data"]).all(), "matrices.json is malformed")
    ck_rec = repeat._record_checkpoint_path(ck, "chr_synthetic")
    with open(ck_rec) as fh:
        state = json.load(fh)
    check("complete" in state, "the checkpoint is not marked complete")
    executed = state["cycle"]
    check(executed == len(scan_log.cycles) and 1 <= executed <= REPEATS,
          f"checkpoint records {executed} cycles, the engine ran "
          f"{len(scan_log.cycles)}")
    found = sum(any(int(r["left_coord"]) < p + PLANT_LEN and p < int(r["right_coord"])
                    for r in rows) for p in planted)
    fill_s = sum(st.seconds for st in kstats.values())
    fill_cells = sum(st.cells for st in kstats.values())
    print(f"  CLI wall {wall:.3f} s, {executed} of {REPEATS} cycles executed, "
          f"{len(rows)} sites in output.csv, {found} of {len(planted)} planted sites "
          f"found; fills {fill_s:.3f} s synchronised, {fill_cells / 1e9:.3f} Gcells "
          f"({fill_cells / fill_s / 1e9:.2f} GCUPS)", flush=True)
    for name, st in sorted(kstats.items()):
        print(f"    {name}: {st.launches} launches, {st.problems} problems, "
              f"{st.cells / 1e9:.3f} Gcells, {st.seconds:.3f} s", flush=True)
    print(f"  windows and survivors per cycle: {scan_log.cycles}", flush=True)

    # one more cycle on the card from the completed checkpoint's state
    seq, _, indices = at.DNA.encode_with_freqs_and_indices(raw)
    matrix = matrix_from_json(state["matrix"])
    mean, std = state["mean"], state["std"]
    opts = repeat.SearchOptions(repeat_length=PWM_W, query_offset=OFFSET,
                                deletions=PWM_DEL, extension=PWM_EXT, device=DEVICE)
    tasks = repeat.calculate_cycle(seq, matrix, indices, mean, std, opts)

    def native_f(lo, hi):
        plane, _ = native.fill(seq[lo:hi], None, matrix, PWM_DEL, PWM_EXT, "pwm")
        return float(plane.max())

    for t in tasks:
        f = native_f(t.left_coord, t.right_coord)
        check(t.f == f, f"task at {t.left_coord}: f {t.f!r} != native {f!r}")
        check(t.z == (f - mean) / std, f"task at {t.left_coord}: z")
    # the whole check scan: its z-filter gives exactly the returned tasks
    wins = repeat.windows_of(len(seq), opts, OFFSET)
    fs = repeat._scan_scores(seq, wins, matrix, opts)
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = np.flatnonzero((fs - mean) / std >= repeat.Z)
    check([wins[i] for i in keep] == [(t.left_coord, t.right_coord) for t in tasks],
          "the tasks are not the scan's z-filtered windows")
    pick = np.random.default_rng(SEED + 6).choice(len(wins), min(1000, len(wins)),
                                                  replace=False)
    pick[-2:] = len(wins) - 2, len(wins) - 1  # the clipped windows at the end
    sample = [wins[i] for i in pick]
    got = repeat._scan_scores(seq, sample, matrix, opts)
    want = np.array([native_f(lo, hi) for lo, hi in sample])
    check(np.array_equal(got, want), "1,000 sampled window scores != native C++")
    check(np.array_equal(fs[pick], got), "sampled scores differ from the full scan's")
    # survivors' alignments; when the scan keeps fewer than 256 windows,
    # the highest-scoring windows stand in for the rest
    kept = set(keep.tolist())
    top = [i for i in np.argsort(-fs, kind="stable")[:256 + len(kept)] if i not in kept]
    chosen = (list(keep) + top)[:256]
    surv = [seq[wins[i][0]:wins[i][1]] for i in chosen]
    for i, w in zip(chosen, surv):
        check(fs[i] == native_f(*wins[i]), f"window {wins[i]}: f != native C++")
    res = at.batch_align_pwm(surv, matrix, PWM_DEL, PWM_EXT, with_alignments=True,
                             device=DEVICE)
    for w, r in zip(surv, res):
        ref = host.align_pwm(w, matrix, PWM_DEL, PWM_EXT)
        a = r.alignment
        check(np.array_equal(a.numbered, ref.target_aligned.astype(np.int32))
              and np.array_equal(a.query, ref.query_aligned)
              and tuple(map(tuple, a.coords)) == tuple(map(tuple, ref.coords))
              and a.f == ref.f, "survivor alignment != host engine")
    print(f"  check cycle: {len(tasks)} tasks (the scan's z-filter), their f and z "
          f"equal native C++; {len(sample)} sampled windows equal native C++; "
          f"{len(surv)} alignments ({min(len(keep), 256)} survivors, the rest the "
          f"top-scoring windows) equal the host engine", flush=True)


def phase_wavefront_timing(dev, at, wf):
    """K5 and the replay walk at the huge pair's shape, 65,536 x 65,536:
    the tile sweep and the replay-block sweep, then each kernel's time
    beside its plain version's and its bound at the shipped sizes.  The
    plain versions run the whole checkpoint-and-replay once; their
    checkpoints and step stream are handed to the path phase."""
    m = torch.as_tensor(np.array(at.blosum62()).astype(np.int32), device=dev)
    q, t = homologous_pair(PAIR_SEED, PAIR_LEN, PAIR_LEN)
    C = R = PAIR_LEN
    cells = C * R
    TB, TR, K = wf.TB_ROWS, wf.TILE_ROWS, wf.COLS_PER_THREAD
    qd, td = padded_pair(dev, wf, q, t, max(TB_SWEEP))
    C_pad = qd.numel()
    lines, rows = [], []

    def forward(K, tr, ck=0):
        return wf.row_scan(qd, td, m, 11, 2, None, 0, C, R, with_dirs=False,
                           ckpt_every=ck, tile_rows=tr, cols_per_thread=K,
                           check_codes=False)

    def launched(before):
        return wf.launches.tile_launches - before

    for k, tr in TILE_SWEEP:
        before = wf.launches.tile_launches
        ms = gpu_ms(lambda: forward(k, tr), 2)
        lines.append(f"tile sweep, forward {R}x{C}: {k} columns a lane, {tr} rows: "
                     f"{ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS), "
                     f"{launched(before) / 3:g} launches a call; "
                     f"{strip_line(wf, dev, False, td.numel(), C_pad, False, ms, tr, k)}")
    before = wf.launches.tile_launches
    fwd, ms, fwd_p, plain_ms = timed_pair(
        lambda: forward(K, None, TB),
        lambda: wf.row_scan_plain(qd, td, m, 11, 2, None, 0, C, R, False, TB), 3)
    check(same_scan(fwd, fwd_p, C, R), "row_scan != plain at the huge pair's shape")
    n_launch = launched(before) / 5  # a warm-up, 3 timed, 1 held
    rows.append(dict(name="wavefront_row_scan (scores, checkpoints)", route="cuda",
                     source="aligner_tpu_torch/csrc/wavefront.cu",
                     replaces=REPLACES["row_scan"], path="huge", counter="row_scan",
                     max_abs_err=max(max_abs_err(fwd[0], fwd_p[0]),
                                     max_abs_err(fwd[2][:, :C], fwd_p[2][:, :C])),
                     ms=ms, plain_ms=plain_ms, shape=f"{R}x{C} int32",
                     **bound(OPS_SCAN * cells, nbytes(qd, td, m, fwd[0], fwd[2]))))
    lines.append(f"forward {R}x{C}, {K} columns a lane, "
                 f"{wf._strip_rows(td.numel(), TB, None, False)} rows, checkpoints every "
                 f"{TB}: {ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS), {n_launch:g} kernel "
                 f"launches a call; "
                 f"{strip_line(wf, dev, False, td.numel(), C_pad, False, ms, ck=TB)}")

    def block(j, tb, tr=TR):
        return wf.row_scan(qd, td[j * tb:(j + 1) * tb], m, 11, 2,
                           ckpts_of[tb][j - 1] if j else None, j * tb, C, R,
                           with_dirs=True, tile_rows=tr, cols_per_thread=K,
                           check_codes=False)

    ckpts_of = {TB: fwd[2]}
    for tb in TB_SWEEP:
        if tb not in ckpts_of:
            ckpts_of[tb] = forward(K, TR, tb)[2]
        j = (R - 1) // tb
        for tr in TB_TILE_ROWS:
            before = wf.launches.tile_launches
            ms_b = gpu_ms(lambda: block(j, tb, tr), 2)
            lines.append(f"replay-block sweep: {tb} rows with directions, {tr}-row "
                         f"strips: {ms_b:.3f} ms, {launched(before) / 3:g} launches a "
                         f"call, {tb * C_pad // 4 / 2**20:.0f} MiB of words; "
                         f"{j + 1} blocks a pair: {ms_b * (j + 1):.1f} ms")
    ckpts_of = {TB: fwd[2]}  # drop the sweep's rows

    # the shipped block: the kernels on the last block, then the plain
    # versions over every block of the pair
    j_last = (R - 1) // TB
    before = wf.launches.tile_launches
    blk = block(j_last, TB)
    ms_blk = gpu_ms(lambda: block(j_last, TB), 3)
    lines.append(f"one replay block, {TB} rows x {C} with directions: {ms_blk:.3f} ms, "
                 f"{launched(before) / 5:g} kernel launches a call; "
                 f"{strip_line(wf, dev, False, TB, C_pad, True, ms_blk)}")

    got, ms_walk, walk_stats = timed_replay(
        wf, blk[1], wf.new_walk(R, C, td.numel() + C_pad + 1, dev), row_base=j_last * TB)
    state_p, steps_p = wf.new_walk(R, C, td.numel() + C_pad + 1, dev)
    for j in range(j_last, -1, -1):
        args = (qd, td[j * TB:(j + 1) * TB], m, 11, 2, fwd_p[2][j - 1] if j else None,
                j * TB, C, R)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blk_p = wf.row_scan_plain(*args, True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wf.replay_walk_plain(blk_p[1], state_p, steps_p, row_base=j * TB)
        t2 = time.perf_counter()
        if j == j_last:
            check(same_scan(blk, blk_p, C, R - j * TB),
                  "row_scan != plain (directions, the pair's last block)")
            check(same_walk(got, (state_p, steps_p)),
                  "replay_walk != plain on the pair's last block")
            n_steps = int(got[0][2])
            rows.append(dict(
                name="wavefront_row_scan (directions, one replay block)", route="cuda",
                source="aligner_tpu_torch/csrc/wavefront.cu",
                replaces=REPLACES["row_scan"], path="huge", counter="row_scan_dirs",
                max_abs_err=max_abs_err(blk[1][:, :C], blk_p[1][:, :C]), ms=ms_blk,
                plain_ms=(t1 - t0) * 1e3, shape=f"{TB}x{C} int32",
                **bound(OPS_SCAN_DIRS * TB * C,
                        nbytes(qd, td[:TB], m, fwd[2][0], blk[0], blk[1]))))
            rows.append(dict(
                name="wavefront_replay_walk (one replay block)", route="cuda",
                source="aligner_tpu_torch/csrc/walk_core.cuh",
                replaces=REPLACES["replay_walk"], path="huge", counter="replay_walk",
                max_abs_err=max(max_abs_err(a, b) for a, b in
                                zip(got, (state_p, steps_p))),
                ms=ms_walk, plain_ms=(t2 - t1) * 1e3, shape=f"{n_steps} steps",
                plan=replay_plan_line(wf, ms_walk, n_steps, walk_stats),
                # a word read and 2 bits written per step, the cursor both ways
                **bound(OPS_WALK_STEP * n_steps, 4 * n_steps + n_steps // 4 + 24)))
    print_rows(rows)
    for line in lines:
        print(f"  {line}", flush=True)
    return rows, dict(q=q, t=t, ckpts=fwd_p[2], state=state_p, steps=steps_p)


def band_plan_line(wf, dev, args, kw, K, P, ms) -> str:
    """The band walk's launch plan for one call, and the ns a step of its
    critical path that the call's time works out to."""
    TB, D = args[0].numel(), args[1].numel()
    p = wf.band_plan(dev, TB, kw["Cb"], D, K, P, args[6].shape[0])
    return (f"{p.n_g} groups of {p.RW} rows, {p.blocks} blocks of {p.warps} warps "
            f"({p.copies} copies of the table, {p.smem_bytes} B shared memory a block), lag "
            f"{p.lag_steps} steps, {p.under_way} groups under way, critical path "
            f"{p.critical_steps} steps, {ms * 1e6 / p.critical_steps:.1f} ns a step of it")


def phase_band_timing(dev, at, wf, q, t):
    """K6 at the huge pair's shape, 65,536 x 65,536: the shape sweep (rows
    a lane, slots read ahead) on one band as tall as the pair, each with its
    launch plan, the band-height sweep over the whole band loop, then the
    kernel's time beside its plain version's and its bound at the shipped
    sizes.  Every call is one launch.  Returns the kernel's row and the plain
    version's end score."""
    m = np.array(at.blosum62())
    C, R = len(q), len(t)
    cells = C * R
    pp = wf._prep(q, t, m, DEL, EXT, dev)
    TB, TD, K, P = wf.BAND_ROWS, wf.BAND_TD, wf.BAND_ROWS_PER_LANE, wf.BAND_READ_AHEAD
    lines = []

    def band_loop(tb, trace=None):
        return wf._band_end_score(pp, tb, TD, K, trace=trace)

    def one_launch_each(before, calls, what):
        n_launch = wf.launches.band_tile_launches - before
        check(n_launch == calls, f"{what}: {n_launch} kernel launches in {calls} calls")

    tall = max(BAND_TB_SWEEP)
    bands = []
    band_loop(tall, trace=bands)
    args, kw, _ = bands[0]
    for k, p in BAND_SHAPE_SWEEP:
        before = wf.launches.band_tile_launches
        ms = gpu_ms(lambda: wf.run_block_band(*args, **kw, with_rc=False, read_ahead=p,
                                              rows_per_lane=k, check_codes=False), 2)
        one_launch_each(before, 3, "the band walk")
        lines.append(f"shape sweep, one band of {tall} rows, {R}x{C}: {k} rows a lane, "
                     f"{p} slots read ahead: {ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS); "
                     f"{band_plan_line(wf, dev, args, kw, k, p, ms)}")
    for tb in BAND_TB_SWEEP:
        before, calls = wf.launches.band_tile_launches, wf.launches.band
        ms = gpu_ms(lambda: band_loop(tb), 2)
        one_launch_each(before, wf.launches.band - calls, "the band loop")
        lines.append(f"band sweep, the whole band loop, {R}x{C}: bands of {tb} rows "
                     f"({-(-R // tb)} bands), {K} rows a lane, {P} slots read ahead: "
                     f"{ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS), one launch a band")

    pp_w = wf._prep(*homologous_pair(PAIR_SEED + 2, WIDE_LEN, WIDE_LEN), m, DEL, EXT, dev)
    for tb in BAND_TB_WIDE:
        ms = gpu_ms(lambda: wf._band_end_score(pp_w, tb, TD, K), 1)
        lines.append(f"band sweep at the width cap, {WIDE_LEN}x{WIDE_LEN}: bands of {tb} "
                     f"rows: {ms:.3f} ms ({WIDE_LEN * WIDE_LEN / ms / 1e6:.1f} GCUPS)")

    # the shipped sizes: the first band of the pair (the only one when the
    # band is as tall as the pair), kernel against plain
    bands = []
    band_loop(TB, trace=bands)
    args, kw, _ = bands[0]
    rows_b = args[0].numel()
    before = wf.launches.band_tile_launches
    got, ms, want, plain_ms = timed_pair(
        lambda: wf.run_block_band(*args, **kw, with_rc=False, check_codes=False),
        lambda: wf.run_block_band_plain(*args, **kw, with_rc=False), 3)
    one_launch_each(before, 5, "the band walk at the shipped shape")
    check(same_band(got, want, rows_b, C, with_rc=False),
          "run_block_band != plain at the huge pair's shape")
    row = dict(name="wavefront_band (scores, one band of the huge pair)", route="cuda",
               source="aligner_tpu_torch/csrc/wavefront_band.cu",
               replaces=REPLACES["band"], path=("end_score", "column_blocked", "engines",
                                                "sharded"),
               counter=("band", "band_sp"),
               max_abs_err=max(max_abs_err(got[0][rows_b - 1:rows_b - 1 + C],
                                           want[0][rows_b - 1:rows_b - 1 + C]),
                               max_abs_err(got[2], want[2])),
               ms=ms, plain_ms=plain_ms, shape=f"{rows_b}x{C} int32",
               **bound(OPS_BAND * rows_b * C, nbytes(*args[:7], *got)))
    lines.append(f"one band of {rows_b} rows by {C} columns, {K} rows a lane, {P} slots "
                 f"read ahead: {ms:.3f} ms ({rows_b * C / ms / 1e6:.1f} GCUPS), one kernel "
                 f"launch a call; {band_plan_line(wf, dev, args, kw, K, P, ms)}")
    print_rows([row])
    for line in lines:
        print(f"  {line}", flush=True)
    plain_end = int(want[2]) if rows_b >= R else None
    return [row], plain_end


def phase_block_timing(dev, at, wf, sp):
    """K7 and the replay walk with a column base at the column-blocked
    path's shapes, each held against its plain version on the very call
    that is timed: the last forward block of the 524,288 x 524,288 pair
    (262,144 rows from row 262,144 by 131,072 columns from column 393,216,
    scores with a checkpoint row every 32,768 rows; it owns the end cell),
    the pair's last replay tile (32,768 x 131,072, with directions), then
    the walk over that tile.  Then that pair's whole forward fill by the
    rows of a forward block and, on the 262,144 x 262,144 pair, a replay
    tile by its width and the whole forward fill by the rows of a forward
    block and the width of a column block.  Returns the kernels' rows and the
    engine pick's calibration points of the row-scan engine ((rows, width,
    GCUPS) of the scores-only forward at FORWARD_ROWS rows)."""
    m = np.array(at.blosum62())
    kw = dict(del_=int(DEL), ext=int(EXT))
    lines, rows = [], []

    def tile_of(pp, lb_hist, ckpts, j, d):
        Cb, TB = pp["Cb"], pp["tb"]
        h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, j, d)
        return (pp["q_dev"][d * Cb:(d + 1) * Cb], pp["t_dev"][j * TB:(j + 1) * TB],
                pp["m_dev"], h0, lb, d * Cb, j * TB, pp["C_real"], pp["R_real"])

    qa, ta = homologous_pair(PAIR_SEED + 5, BLOCKED_LEN, BLOCKED_LEN)
    pp = sp._prep_sharded(None, qa, ta, m, DEL, EXT, None, sp.TB_ROWS, "pallas", dev)
    end_a, lb_hist, ckpts = sp._forward(pp, True)
    d, Cb, TB, tr = pp["n"] - 1, pp["Cb"], pp["tb"], pp["tr"]
    y0 = (pp["J"] - 1) * tr  # the last row block starts on a checkpoint row
    check(y0 > 0 and y0 % TB == 0 and d > 0, "the wide pair's last forward block has a "
                                            "border for an edge")
    forward = (pp["q_dev"][d * Cb:], pp["t_dev"][y0:], pp["m_dev"],
               ckpts[y0 // TB - 1, d * Cb:].contiguous(), lb_hist[d, y0 - 1:].contiguous(),
               d * Cb, y0, pp["C_real"], pp["R_real"])
    tile = tile_of(pp, lb_hist, ckpts, pp["R_pad"] // TB - 1, d)
    for args, extra, ops, counter, what in (
            (forward, dict(ckpt_every=TB), OPS_SCAN, "block_cs", "scores, checkpoints"),
            (tile, dict(with_dirs=True), OPS_SCAN_DIRS, "block_cs_dirs", "directions")):
        R_b, C_b = args[1].numel(), args[0].numel()
        before = wf.launches.block_cs_tile_launches
        got, ms, want, plain_ms = timed_pair(
            lambda: wf.run_block_cs(*args, **kw, **extra, check_codes=False),
            lambda: wf.run_block_cs_plain(*args, **kw, **extra), 3)
        check(same_block(got, want, R_b, C_b),
              f"run_block_cs != plain at the path's shape ({R_b}x{C_b}, {what})")
        rows.append(dict(
            name=f"wavefront_block_cs ({what}, one {R_b} x {C_b} block at column "
                 f"{args[5]})", route="cuda",
            source="aligner_tpu_torch/csrc/wavefront_block.cu",
            replaces=REPLACES["block_cs"], path=("column_blocked", "engines", "sharded"),
            counter=counter,
            max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want) if a is not None),
            ms=ms, plain_ms=plain_ms, shape=f"{R_b}x{C_b} int32",
            **bound(ops * R_b * C_b, nbytes(*args[:5], *got))))
        n_launch = (wf.launches.block_cs_tile_launches - before) / 5
        plan = strip_line(wf, dev, True, R_b, C_b, what == "directions", ms,
                          ck=extra.get("ckpt_every", 0))
        lines.append(f"K7 {what}: {R_b}x{C_b} block {ms:.3f} ms ({R_b * C_b / ms / 1e6:.1f} "
                     f"GCUPS), {n_launch:g} kernel launches a call; plain "
                     f"{plain_ms / 1e3:.1f} s; {plan}")
    words = got[3]
    del want, forward
    # the pair's whole forward fill with its records by the rows of a block
    for rows_f in FORWARD_SWEEP:
        ppf = sp._prep_sharded(None, qa, ta, m, DEL, EXT, rows_f, sp.TB_ROWS, "pallas", dev)
        before = wf.launches.block_cs_tile_launches
        out = {}
        ms = gpu_ms(lambda: out.update(end=sp._forward(ppf, True)[0]), 1)
        check(torch.equal(out["end"], end_a),
              f"the end score depends on the blocks ({rows_f} rows)")
        lines.append(f"forward-block sweep, forward {BLOCKED_LEN}x{BLOCKED_LEN} with its "
                     f"records: blocks of {rows_f} rows x {Cb} columns ({ppf['J']} x "
                     f"{ppf['n']} blocks): {ms:.3f} ms "
                     f"({BLOCKED_LEN * BLOCKED_LEN / ms / 1e6:.1f} GCUPS), "
                     f"{(wf.launches.block_cs_tile_launches - before) // 2} launches")
    # the walk over that tile, from the pair's end cell
    size = pp["R_pad"] + pp["C_pad"] + 1

    start = wf.new_walk(BLOCKED_LEN, BLOCKED_LEN, size, dev)
    got, ms_walk, walk_stats = timed_replay(wf, words, start, row_base=tile[6],
                                            col_base=tile[5])
    want = start[0].clone(), start[1].clone()
    t0 = time.perf_counter()
    wf.replay_walk_plain(words, *want, row_base=tile[6], col_base=tile[5])
    plain_walk_ms = (time.perf_counter() - t0) * 1e3
    check(same_walk(got, want), "replay_walk != plain on the column-blocked path's tile")
    n_steps = int(got[0][2])
    rows.append(dict(
        name=f"wavefront_replay_walk (one replay tile, column base {tile[5]})",
        route="cuda", source="aligner_tpu_torch/csrc/walk_core.cuh",
        replaces=REPLACES["replay_walk"], path=("column_blocked", "engines", "sharded"),
        counter="replay_walk",
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)), ms=ms_walk,
        plain_ms=plain_walk_ms, shape=f"{n_steps} steps",
        plan=replay_plan_line(wf, ms_walk, n_steps, walk_stats),
        **bound(OPS_WALK_STEP * n_steps, 4 * n_steps + n_steps // 4 + 24)))
    del words, got, want, tile, lb_hist, ckpts, pp

    # a replay tile with directions by its width, and the tiles a diagonal
    # path through the 524,288 x 524,288 pair would cross at that width
    q, t = homologous_pair(PAIR_SEED + 2, WIDE_LEN, WIDE_LEN)
    for cb in TILE_CB_SWEEP:
        ppc = sp._prep_sharded(WIDE_LEN // cb, q, t, m, DEL, EXT, None, sp.TB_ROWS, "pallas",
                               dev)
        end_c, *records = sp._forward(ppc, True)
        tile = tile_of(ppc, *records, ppc["R_pad"] // ppc["tb"] - 1, ppc["n"] - 1)
        ms = gpu_ms(lambda: wf.run_block_cs(*tile, **kw, with_dirs=True,
                                            check_codes=False), 2)
        crossed = BLOCKED_LEN // sp.TB_ROWS + BLOCKED_LEN // cb - 1
        lines.append(f"replay-tile sweep: {sp.TB_ROWS} rows x {cb} columns with "
                     f"directions: {ms:.3f} ms, {sp.TB_ROWS * cb // 4 / 2**20:.0f} MiB of "
                     f"words; {crossed} tiles across {BLOCKED_LEN}x{BLOCKED_LEN}: "
                     f"{ms * crossed:.1f} ms")
    del tile, records
    # the whole forward fill by the rows of a forward block and the width
    # of a column block, scores only and with the alignment's records
    cells = WIDE_LEN * WIDE_LEN
    k7_points = []  # the engine pick's calibration: forward blocks of FORWARD_ROWS rows
    for tr in TR_SWEEP:
        for cb in CB_SWEEP:
            ppc = sp._prep_sharded(WIDE_LEN // cb, q, t, m, DEL, EXT, tr, sp.TB_ROWS, "pallas",
                                   dev)
            before = wf.launches.block_cs_tile_launches
            ms = gpu_ms(lambda: sp._forward(ppc, False), 1)
            launched = (wf.launches.block_cs_tile_launches - before) // 2
            out = {}
            ms_rec = gpu_ms(lambda: out.update(end=sp._forward(ppc, True)[0]), 1)
            check(torch.equal(out["end"], end_c),
                  f"the end score depends on the blocks ({tr} rows x {cb} columns)")
            lines.append(f"block sweep, forward {WIDE_LEN}x{WIDE_LEN}: blocks of {tr} rows "
                         f"x {cb} columns ({ppc['J']} x {ppc['n']} blocks): {ms:.3f} ms "
                         f"({cells / ms / 1e6:.1f} GCUPS), {launched} launches; with the "
                         f"boundary and checkpoint records {ms_rec:.3f} ms")
            if tr == sp.FORWARD_ROWS:
                k7_points.append((tr, cb, cells / ms / 1e6))
    print_rows(rows)
    for line in lines:
        print(f"  {line}", flush=True)
    return rows, k7_points


def forward_end_cell(dev, at, wf, q, t) -> int:
    """H[R, C] from K5's forward fill, an independent kernel."""
    m = torch.as_tensor(np.array(at.blosum62()).astype(np.int32), device=dev)
    qd, td = padded_pair(dev, wf, q, t, wf.TILE_ROWS)
    end, _, _ = wf.row_scan(qd, td, m, int(DEL), int(EXT), None, 0, len(q), len(t),
                            with_dirs=False, check_codes=False)
    return int(end)


def phase_end_score(dev, at, native, host, wf, q, t, plain_end, pq, pt):
    """The end score of one huge global pair through ``global_end_score``:
    65,536 x 65,536 against K5's forward end cell and the plain band
    engine, two smaller pairs against the host engine, the routes on a
    small pair, the width cap timed, and ``local_max_score``.  Returns the
    65,536 x 65,536 end score."""
    import warnings

    from aligner_tpu_torch.observability import counters

    m = at.blosum62()
    C, R = len(q), len(t)
    L = wf.launches
    counters.reset()
    before = (L.band, L.band_tile_launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = at.global_end_score(q, t, m, DEL, EXT, device=DEVICE)
    wall = time.perf_counter() - t0
    band = counters.snapshot()[f"{DEVICE}/wavefront-band"]
    calls, tiles = L.band - before[0], L.band_tile_launches - before[1]
    check(calls >= 1 and tiles == calls,
          f"global_end_score {R}x{C}: {tiles} kernel launches in {calls} band calls")
    # the device part alone, and how often it waits: the loop itself never
    # does, the call reads the end score once
    pp = wf._prep(q, t, np.asarray(m), DEL, EXT, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter("always")
        torch.as_tensor(np.zeros(8, np.int32), device=dev)
        per_upload = len(flagged)
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        end, info = wf._band_end_score(pp, wf.BAND_ROWS, wf.BAND_TD, wf.BAND_ROWS_PER_LANE)
        enqueued = time.perf_counter() - t0
        n_loop = len(flagged)
        end_host = int(end.item())
        device_s = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    n_read = len(flagged) - n_loop
    check(n_read <= 1 and n_loop <= 2 * per_upload,
          f"the band loop waited for the device {n_loop} times (2 uploads allowed) and "
          f"the read {n_read} times")
    k5 = forward_end_cell(dev, at, wf, q, t)
    check(score == end_host == k5, f"global_end_score {score} != K5's end cell {k5}")
    check(plain_end is None or score == plain_end,
          f"global_end_score {score} != the plain band engine's {plain_end}")
    print(f"  global_end_score {R}x{C}: wall {wall:.4f} s (band loop to the score "
          f"{band.seconds:.4f} s, {band.gcups:.1f} GCUPS), {calls} band calls of "
          f"{info['tb']} rows, {tiles} kernel launches, {n_read} wait for the device a "
          f"call; score {int(score)} equals K5's forward end cell"
          + ("" if plain_end is None else " and the plain band engine's"), flush=True)
    end_score = score
    print(f"  the band loop alone: enqueued in {enqueued:.4f} s, the score read after "
          f"{device_s:.4f} s; torch's sync debug mode flagged {n_loop} synchronising "
          f"calls while the loop was enqueued (it uploads the two sequences before its "
          f"first launch, and flags {per_upload} for one upload from host memory) and "
          f"{n_read} at the read", flush=True)

    for cq, ct in (CHUNKED_PAIR, DIRECT_PAIR):
        q2, t2 = homologous_pair(PAIR_SEED + cq, cq, ct)
        t0 = time.perf_counter()
        got = at.global_end_score(q2, t2, m, DEL, EXT, device=DEVICE)
        wall = time.perf_counter() - t0
        ref = host.align_global(q2, t2, m, DEL, EXT)
        check(got == ref.score[ct, cq], f"global_end_score {ct}x{cq} != the host engine")
        print(f"  global_end_score {ct}x{cq}: wall {wall:.4f} s, equals the host "
              f"engine's score[{ct}, {cq}] = {got}", flush=True)

    # the routes, on a small pair: diag and host by name, and a non-integral
    # matrix, which the band engine does not take: a batch of one in f64
    q5, t5 = homologous_pair(PAIR_SEED + 3, *SMALL_PAIR)
    ref = host.align_global(q5, t5, m, DEL, EXT).score[len(t5), len(q5)]
    for backend in ("diag", "host"):
        got = at.global_end_score(q5, t5, m, DEL, EXT, backend=backend, device=DEVICE)
        check(got == ref, f"global_end_score backend={backend} != the host engine")
    half = np.asarray(m) * 0.5
    before_fill = dp_fill_scores()
    got = at.global_end_score(q5, t5, half, 5.5, 1.25, device=DEVICE)
    ref = host.align_global(q5, t5, half, 5.5, 1.25).score[len(t5), len(q5)]
    check(got == ref and dp_fill_scores() == before_fill + 1,
          "global_end_score with a non-integral matrix != the host engine")
    print(f"  global_end_score {SMALL_PAIR[1]}x{SMALL_PAIR[0]}: backend diag and host "
          f"equal the host engine; a non-integral matrix runs as a batch of one on the "
          f"batched fill (f64) and equals it too ({got})", flush=True)

    # the width cap: timed, and held against K5's forward end cell
    q4, t4 = homologous_pair(PAIR_SEED + 2, WIDE_LEN, WIDE_LEN)
    counters.reset()
    before = (L.band, L.band_tile_launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    score = at.global_end_score(q4, t4, m, DEL, EXT, device=DEVICE)
    wall = time.perf_counter() - t0
    band = counters.snapshot()[f"{DEVICE}/wavefront-band"]
    peak = torch.cuda.max_memory_allocated() / 2**20
    calls, tiles = L.band - before[0], L.band_tile_launches - before[1]
    check(calls >= 1 and tiles == calls,
          f"global_end_score at the width cap: {tiles} kernel launches in {calls} calls")
    k5 = forward_end_cell(dev, at, wf, q4, t4)
    check(score == k5, f"global_end_score at the width cap {score} != K5's end cell {k5}")
    print(f"  global_end_score {WIDE_LEN}x{WIDE_LEN}: wall {wall:.4f} s (band loop to "
          f"the score {band.seconds:.4f} s, {band.gcups:.1f} GCUPS), {calls} "
          f"band calls, {tiles} kernel launches, peak device "
          f"memory {peak:.0f} MiB; score {int(score)} equals K5's forward end cell",
          flush=True)

    f, (my, mx) = at.local_max_score(pq, pt, m, DEL, EXT, device=DEVICE)
    check((f, my, mx) == tuple(native.local_max_score_stream(pq, pt, np.asarray(m), DEL,
                                                             EXT)),
          "local_max_score != native C++")
    print(f"  local_max_score on examples/protein.fasta: {f} at ({my}, {mx}), equals "
          f"native C++", flush=True)
    return end_score


def dp_fill_scores() -> int:
    from aligner_tpu_torch.ops import dp_fill

    return dp_fill.launches.scores


def spells(at, aln, q, t) -> bool:
    """Without their blanks the aligned strings are the sequences, each
    with its last character twice: the reference seeds the walk with the
    last pair and the walk emits the end cell again (simple/mod.rs:99-127)."""
    blank = at.alphabet.BLANK
    return (np.array_equal(aln.query[aln.query != blank], np.append(q, q[-1]))
            and np.array_equal(aln.target[aln.target != blank], np.append(t, t[-1])))


def phase_huge_pair(at, native, host, wf, cli_align, plain, tmp):
    """One huge global pair through the entry points: ``align_global`` at
    65,536 x 65,536 against the plain versions' checkpoints and step
    stream, at 8,000 x 9,000 and 3,000 x 4,000 against the host engine
    (native C++ fill, reference walk), the ``aligner-align -g`` CLI, and one
    timed ``align_global`` at the width cap."""
    from aligner_tpu_torch.observability import counters
    from aligner_tpu_torch.result import Alignment

    m = at.blosum62()
    q, t = plain["q"], plain["t"]
    C, R = len(q), len(t)
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = at.align_global(q, t, m, DEL, EXT, device=DEVICE)
    wall = time.perf_counter() - t0
    kstats = counters.snapshot()
    pp = wf._prep(q, t, np.asarray(m), DEL, EXT, DEVICE)
    infos = {}
    for sync in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end, ckpts, state, steps, info = wf._chunked_walk(pp, wf.TB_ROWS, wf.TILE_ROWS,
                                                          sync)
        torch.cuda.synchronize()
        infos[sync] = dict(info, wall=time.perf_counter() - t0)
        check(torch.equal(ckpts[:, :C], plain["ckpts"][:, :C]),
              "align_global's checkpoints != the plain version's")
        check(same_walk((state, steps), (plain["state"], plain["steps"])),
              f"align_global's step stream != the plain versions' (sync={sync})")
    qa, ta, coords = wf._assemble(pp, plain["state"], plain["steps"])
    a = res.alignment
    check(np.array_equal(a.query, qa) and np.array_equal(a.target, ta)
          and a.coords == coords == ((1, C), (1, R)) and a.f == 0.0,
          "align_global != the alignment of the plain versions' step stream")
    check(spells(at, a, q, t), "the aligned strings do not spell the pair")
    # the rescoring hold, proved here on a path that is held already: the
    # plain versions' step stream, and the same stream read back from the
    # aligned strings, both score the end cell
    n_steps = int(plain["state"][2])
    rescored = wf.rescore_steps(plain["steps"].cpu().numpy(), n_steps, q, t, m, DEL, EXT)
    back, n_back = wf.alignment_steps(a.query, a.target)
    check(rescored == int(end) and n_back == n_steps
          and wf.rescore_steps(back, n_back, q, t, m, DEL, EXT) == int(end),
          f"the rescored path {rescored} != the end score {int(end)}")
    fwd, rep = kstats[f"{DEVICE}/wavefront"], kstats[f"{DEVICE}/wavefront-replay"]
    i = infos[True]
    print(f"  align_global {R}x{C}: wall {wall:.3f} s (forward {fwd.seconds:.4f} s, "
          f"{fwd.gcups:.1f} GCUPS; replay and walks {rep.seconds:.4f} s), "
          f"{i['blocks']} of {i['n_blocks']} blocks of {i['tb_rows']} rows crossed, "
          f"{int(plain['state'][2])} steps, alignment length {len(a.query)}, end score "
          f"{int(end)}; checkpoints and step stream equal the plain versions'; the "
          f"path rescored on the host gives {rescored}", flush=True)
    for sync in (True, False):
        i = infos[sync]
        print(f"  block loop, cursor read after every block={sync}: device part "
              f"{i['wall']:.4f} s (forward {i['forward_s']:.4f}, replay "
              f"{i['replay_s']:.4f}), {i['blocks']} blocks, {i['syncs']} waits for the "
              f"device (+3 for the downloads)", flush=True)

    for (cq, ct), route in ((CHUNKED_PAIR, "checkpoint-and-replay"),
                            (DIRECT_PAIR, "one direction plane")):
        q2, t2 = homologous_pair(PAIR_SEED + cq, cq, ct)
        check((cq * ct > wf.DIRECT_PLANE_CELLS) == (route == "checkpoint-and-replay"),
              f"{ct}x{cq} does not take the {route} route")
        t0 = time.perf_counter()
        a = at.align_global(q2, t2, m, DEL, EXT, device=DEVICE).alignment
        wall = time.perf_counter() - t0
        ref = host.align_global(q2, t2, m, DEL, EXT)
        check(np.array_equal(a.query, ref.query_aligned)
              and np.array_equal(a.target, ref.target_aligned)
              and tuple(map(tuple, a.coords)) == tuple(map(tuple, ref.coords)),
              f"align_global {ct}x{cq} != the host engine")
        print(f"  align_global {ct}x{cq} ({route}): wall {wall:.3f} s, equals the host "
              f"engine (native C++ fill)", flush=True)

    q3, t3 = homologous_pair(PAIR_SEED + 1, CLI_PAIR_LEN, CLI_PAIR_LEN)
    fasta = os.path.join(tmp, "pair.fasta")
    write_db(fasta, [at.Protein.decode(q3).encode(), at.Protein.decode(t3).encode()],
             ["query", "target"])
    for extra in ([], ["--pretty"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_align.main(["-i", fasta, "-g", "--device", DEVICE] + extra)
        wall = time.perf_counter() - t0
        check(rc == 0, f"aligner-align exited {rc}")
        ref = host.align_global(q3, t3, m, DEL, EXT)
        aln = Alignment(ref.query_aligned, ref.target_aligned, ref.coords, ref.f,
                        at.Protein)
        render = cli_align.render_result if extra else cli_align.reference_debug_format
        check(buf.getvalue() == render(aln, m) + "\n",
              f"aligner-align -g {' '.join(extra)} stdout != the host engine's rendering")
        print(f"  aligner-align -g {' '.join(extra)}: {CLI_PAIR_LEN}-residue records, "
              f"wall {wall:.3f} s, stdout equals the host engine's rendering", flush=True)

    # the width cap: timed, and its path held by the rescoring: the walked
    # path's score under the fill's own rules equals the band fill's end score
    q4, t4 = homologous_pair(PAIR_SEED + 2, WIDE_LEN, WIDE_LEN)
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = at.align_global(q4, t4, m, DEL, EXT, device=DEVICE).alignment
    wall = time.perf_counter() - t0
    kstats = counters.snapshot()
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(spells(at, a, q4, t4),
          "the aligned strings at the width cap do not spell the pair")
    score = at.global_end_score(q4, t4, m, DEL, EXT, device=DEVICE)
    rescored = wf.rescore_steps(*wf.alignment_steps(a.query, a.target), q4, t4, m, DEL, EXT)
    check(rescored == score,
          f"the rescored path at the width cap {rescored} != global_end_score {score}")
    fwd, rep = kstats[f"{DEVICE}/wavefront"], kstats[f"{DEVICE}/wavefront-replay"]
    print(f"  align_global {WIDE_LEN}x{WIDE_LEN}: wall {wall:.3f} s (forward "
          f"{fwd.seconds:.4f} s, {fwd.gcups:.1f} GCUPS; replay and walks "
          f"{rep.seconds:.4f} s), alignment length {len(a.query)}, peak device memory "
          f"{peak:.0f} MiB; the path rescored on the host gives {rescored}, equal to "
          f"global_end_score", flush=True)
    return dict(q=q4, t=t4, alignment=a, score=score, pair_b=res.alignment)


def same_alignment(a, b) -> bool:
    return (np.array_equal(a.query, b.query) and np.array_equal(a.target, b.target)
            and tuple(map(tuple, a.coords)) == tuple(map(tuple, b.coords)))


def phase_column_blocked(at, wf, sp, plain, wide):
    """Drives the column-blocked path, and nothing else, so that the launch
    counts read after it are the path's own: the 65,536 x 65,536 pair as 4
    column blocks and the 262,144 x 262,144 pair as 2 through the module's
    entry points, 524,288 x 524,288 through ``align_global`` and
    ``global_end_score`` by its width alone, and ``backend="wavefront_sp"`` on
    a small pair.  Returns what it computed, for
    :func:`hold_column_blocked`."""
    import warnings

    from aligner_tpu_torch.observability import counters

    m = at.blosum62()
    m_np = np.asarray(m)
    L = wf.launches
    out = {}
    for name, n_blocks, q, t in (("B", BLOCKED_B, plain["q"], plain["t"]),
                                 ("C", 2, wide["q"], wide["t"])):
        t0 = time.perf_counter()
        res = sp.sharded_global_align(n_blocks, q, t, m_np, DEL, EXT, device=DEVICE)
        wall = time.perf_counter() - t0
        es = sp.sharded_global_end_score(n_blocks, q, t, m_np, DEL, EXT, device=DEVICE)
        out[name] = dict(q=q, t=t, n_blocks=n_blocks, res=res, es=es, wall=wall)

    # pair A: wider than one plane, through the entry points, no backend named
    q, t = homologous_pair(PAIR_SEED + 5, BLOCKED_LEN, BLOCKED_LEN)
    C = R = BLOCKED_LEN
    check(C > wf.MAX_WIDTH, "the wide pair is not wider than one plane")
    counters.reset()
    # forward blocks run on the engine the pick chose: K7 scores only, or K6
    before = (L.block_cs + L.band_sp, L.block_cs_dirs,
              L.block_cs_tile_launches + L.band_tile_launches, L.replay_walk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        a = at.align_global(q, t, m, DEL, EXT, device=DEVICE).alignment
        wall = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    peak = torch.cuda.max_memory_allocated() / 2**20
    kstats = counters.snapshot()
    blocks, tiles, launched, walks = (
        L.block_cs + L.band_sp - before[0], L.block_cs_dirs - before[1],
        L.block_cs_tile_launches + L.band_tile_launches - before[2],
        L.replay_walk - before[3])
    check(blocks > 0 and tiles > 0 and walks == tiles,
          f"align_global {R}x{C} did not take the column-blocked route ({blocks} blocks, "
          f"{tiles} tiles, {walks} walks)")
    check(launched == blocks + tiles, f"align_global {R}x{C}: {launched} launches for "
                                      f"{blocks + tiles} column-block calls")
    t0 = time.perf_counter()
    score = at.global_end_score(q, t, m, DEL, EXT, device=DEVICE)
    wall_es = time.perf_counter() - t0
    blocks_es = L.block_cs + L.band_sp - before[0] - blocks
    launched_es = L.block_cs_tile_launches + L.band_tile_launches - before[2] - launched
    engines = [sp._prep_sharded(None, q, t, m_np, DEL, EXT, None, tb, None, DEVICE)["engine"]
               for tb in (sp.TB_ROWS, None)]
    check(blocks_es > 0, f"global_end_score {R}x{C} did not take the column-blocked route")
    fwd = kstats[f"{DEVICE}/wavefront-sp"]
    rep = kstats[f"{DEVICE}/wavefront-sp-replay"]
    print(f"  align_global {R}x{C} (no backend named: by its width; forward engine "
          f"{engines[0]!r} by auto_shard_config): wall {wall:.3f} s "
          f"({R * C / wall / 1e9:.1f} GCUPS end to end; forward {fwd.seconds:.4f} s, "
          f"{fwd.gcups:.1f} GCUPS; replay and walks {rep.seconds:.4f} s), {blocks} forward "
          f"blocks run, {tiles} tiles replayed, {launched} kernel launches and {walks} "
          f"walks, {len(flagged)} synchronising calls flagged by torch's sync debug mode "
          f"(one after the forward fill, one cursor read a tile, the uploads and "
          f"downloads), peak device memory {peak:.0f} MiB, alignment length "
          f"{len(a.query)}", flush=True)
    print(f"  global_end_score {R}x{C} (engine {engines[1]!r}): wall {wall_es:.3f} s "
          f"({R * C / wall_es / 1e9:.1f} GCUPS), {blocks_es} forward blocks run, "
          f"{launched_es} kernel launches", flush=True)
    out["A"] = dict(q=q, t=t, alignment=a, score=score, engines=engines,
                    launches=dict(align=(blocks, tiles, walks), end=blocks_es))

    # backend="wavefront_sp" by name, on a small pair
    q5, t5 = homologous_pair(PAIR_SEED + 3, *SMALL_PAIR)
    out["small"] = dict(
        q=q5, t=t5,
        alignment=at.align_global(q5, t5, m, DEL, EXT, backend="wavefront_sp",
                                  device=DEVICE).alignment,
        score=at.global_end_score(q5, t5, m, DEL, EXT, backend="wavefront_sp",
                                  device=DEVICE))
    check(L.row_scan + L.row_scan_dirs + L.band == 0,
          "the column-blocked path launched a single-plane kernel")
    return out


def hold_column_blocked(dev, at, host, wf, sp, plain, wide, out):
    """What :func:`phase_column_blocked` computed against the other routes:
    the 4-block pair's strings, end score, checkpoint rows and step stream
    against the single-plane routes and the plain versions'; the 2-block
    pair's strings and end score against the single-plane run; the
    524,288 x 524,288 pair's end score against the band fill on a grid of
    262,144-column blocks (an independent kernel) and its path rescored;
    the small pair against the host engine."""
    from aligner_tpu_torch.result import Alignment

    m = at.blosum62()
    m_np = np.asarray(m)

    # pair B: every checkpoint value has passed through the right columns
    # of the blocks to its left
    b = out["B"]
    q, t = b["q"], b["t"]
    C, R = len(q), len(t)
    end, qa, ta, coords = b["res"]
    check(same_alignment(Alignment(qa, ta, coords, 0.0, at.Protein), wide["pair_b"]),
          f"{BLOCKED_B} column blocks: strings or coordinates != align_global's")
    k5 = forward_end_cell(dev, at, wf, q, t)
    k6 = at.global_end_score(q, t, m, DEL, EXT, device=DEVICE)
    check(end == b["es"] == k5 == k6,
          f"{BLOCKED_B} column blocks: end score {end} / {b['es']} != K5's end cell {k5} "
          f"or global_end_score {k6}")
    pp = sp._prep_sharded(BLOCKED_B, q, t, m_np, DEL, EXT, None, wf.TB_ROWS, None, DEVICE)
    _, _, ckpts, state, steps, info = sp._sharded_walk(pp)
    check(torch.equal(ckpts[:, :C], plain["ckpts"][:, :C]),
          "the column-blocked checkpoints != the plain row-scan fill's")
    check(same_walk((state, steps), (plain["state"], plain["steps"])),
          "the column-blocked step stream != the plain versions'")
    rescored = wf.rescore_steps(*wf.alignment_steps(qa, ta), q, t, m, DEL, EXT)
    check(rescored == end, f"the rescored path {rescored} != the end score {end}")
    print(f"  sharded_global_align {R}x{C}, {pp['n']} column blocks of {pp['Cb']}: wall "
          f"{b['wall']:.3f} s (forward {info['forward_s']:.4f} s in "
          f"{info['forward_blocks']} blocks, replay {info['replay_s']:.4f} s in "
          f"{info['tiles']} tiles, {info['syncs']} waits for the device); strings, "
          f"coordinates, end score, checkpoint rows and step stream equal the "
          f"single-plane routes' and the plain versions'", flush=True)

    # pair C: 2 column blocks of 131,072 against the single-plane run
    c = out["C"]
    q, t = c["q"], c["t"]
    end, qa, ta, coords = c["res"]
    check(same_alignment(Alignment(qa, ta, coords, 0.0, at.Protein), wide["alignment"]),
          "2 column blocks at the width cap: strings != align_global's single-plane run")
    rescored = wf.rescore_steps(*wf.alignment_steps(qa, ta), q, t, m, DEL, EXT)
    check(end == c["es"] == rescored == wide["score"],
          f"2 column blocks at the width cap: end score {end} / {c['es']} / rescored "
          f"{rescored} != global_end_score {wide['score']}")
    print(f"  sharded_global_align {len(t)}x{len(q)}, 2 column blocks of {len(q) // 2}: "
          f"wall {c['wall']:.3f} s; strings equal align_global's single-plane run, end "
          f"score {int(end)} equals global_end_score and the rescored path", flush=True)

    # pair A: the end score is held by the block engine the default did not
    # run (K7's forward, or the band engine's), and the path by its rescoring
    a = out["A"]
    q, t, aln, score = a["q"], a["t"], a["alignment"], a["score"]
    C, R = len(q), len(t)
    t0 = time.perf_counter()
    engine = "pallas" if a["engines"][1] == "band" else "band"
    other = {"pallas": "the \"pallas\" engine's K7 forward",
             "band": "the band engine's forward"}[engine]
    k_other = sp.sharded_global_end_score(None, q, t, m_np, DEL, EXT, engine=engine,
                                          device=dev)
    wall_other = time.perf_counter() - t0
    check(score == k_other, f"{R}x{C}: global_end_score {score} != {other}, {k_other}")
    rescored = wf.rescore_steps(*wf.alignment_steps(aln.query, aln.target), q, t, m, DEL,
                                EXT)
    check(rescored == score,
          f"{R}x{C}: the rescored path {rescored} != global_end_score {score}")
    check(spells(at, aln, q, t) and tuple(map(tuple, aln.coords)) == ((1, C), (1, R)),
          f"{R}x{C}: the aligned strings do not spell the pair")
    print(f"  {R}x{C}: global_end_score {int(score)} (engine {a['engines'][1]!r}) equals "
          f"{other} ({wall_other:.3f} s) and the rescored path of align_global; the strings "
          f"spell the pair", flush=True)

    s5 = out["small"]
    ref = host.align_global(s5["q"], s5["t"], m, DEL, EXT)
    check(np.array_equal(s5["alignment"].query, ref.query_aligned)
          and np.array_equal(s5["alignment"].target, ref.target_aligned)
          and tuple(map(tuple, s5["alignment"].coords)) == tuple(map(tuple, ref.coords))
          and s5["score"] == ref.score[len(s5["t"]), len(s5["q"])],
          "backend=wavefront_sp on a small pair != the host engine")
    print(f"  backend=wavefront_sp {SMALL_PAIR[1]}x{SMALL_PAIR[0]}: align_global and "
          f"global_end_score equal the host engine ({s5['score']})", flush=True)


def same_plane(a, b) -> bool:
    return (same_fill(a, b) and a.plane is not None and a.plane.dtype == b.plane.dtype
            and torch.equal(a.plane, b.plane))


def plane_vs_plain(dev, at, dp_fill, scan_engine) -> int:
    """The fill kernel with the score plane (K2/K3, ``PLANE``) against its
    plain version, bit for bit, plane and words: seeded ragged and dense
    batches, local and global, f32 and f64, a shared and per-problem
    matrices, PWM mode with shared and per-problem PWMs."""
    rng = np.random.default_rng(SEED + 31)
    b62 = np.array(at.blosum62())
    kw = dict(with_dirs=True, with_scores_plane=True)
    n = 0
    for dense in (False, True):
        q, ql, t, tl = tensors(dev, *random_batch(rng, 300, 40, 37, dense))
        for dtype in (torch.float32, torch.float64):
            m = torch.as_tensor(b62, dtype=dtype, device=dev)
            for mode in ("local", "global"):
                check(same_plane(dp_fill.fill(q, ql, t, tl, m, DEL, EXT, mode=mode, **kw),
                                 scan_engine.fill_batch(q, ql, t, tl, m, DEL, EXT,
                                                        mode=mode, **kw)),
                      f"dp_fill plane != plain ({dtype}, {mode}, dense={dense})")
                n += 1
    q, ql, t, tl = tensors(dev, *random_batch(rng, 130, 24, 29, False))
    mats = torch.as_tensor(rng.normal(0.0, 3.0, (130, 24, 24)), device=dev)
    for mode in ("local", "global"):
        check(same_plane(dp_fill.fill(q, ql, t, tl, mats, 3.5, 1.25, mode=mode, **kw),
                         scan_engine.fill_batch(q, ql, t, tl, mats, 3.5, 1.25, mode=mode,
                                                **kw)),
              f"dp_fill plane != plain (batched f64 matrix, {mode})")
        n += 1
    for batched in (False, True):
        for dtype in (torch.float32, torch.float64):
            q, ql, pwm = pwm_batch(rng, 300, 45, 37, batched, dtype, dev)
            check(same_plane(dp_fill.fill_pwm(q, ql, pwm, PWM_DEL, PWM_EXT, **kw),
                             scan_engine.fill_pwm_batch(q, ql, pwm, PWM_DEL, PWM_EXT, **kw)),
                  f"PWM dp_fill plane != plain ({dtype}, batched={batched})")
            n += 1
    return n


def plane_rows(dev, at, dp_fill, scan_engine, pq, pt):
    """The plane variant at its path's shape: the ``examples/protein.fasta``
    pair at B = 1 (``keep_planes``, one thread), global and local, each held
    against its plain version and timed beside it; the global one is the
    kernels line's row."""
    from aligner_tpu_torch.align import pad_batch

    m = torch.as_tensor(np.array(at.blosum62()), dtype=torch.float32, device=dev)
    qq, qql = pad_batch([pq])
    tt, ttl = pad_batch([pt])
    args = tensors(dev, qq, qql, tt, ttl)
    rows = []
    for mode in ("global", "local"):
        kw = dict(mode=mode, with_dirs=True, with_scores_plane=True)
        got, ms, want, plain_ms = timed_pair(
            lambda: dp_fill.fill(*args, m, DEL, EXT, **kw),
            lambda: scan_engine.fill_batch(*args, m, DEL, EXT, **kw), 3)
        check(same_plane(got, want), f"dp_fill plane != plain on the protein pair ({mode})")
        rows.append(dict(name=f"dp_fill (score plane, keep_planes pair, {mode})",
                         route="cuda", source="aligner_tpu_torch/csrc/dp_fill_core.cuh",
                         replaces=REPLACES["dp_fill"], path="simple", counter="planes",
                         max_abs_err=max(max_abs_err(got.plane, want.plane),
                                         max_abs_err(got.words, want.words)),
                         ms=ms, plain_ms=plain_ms,
                         shape=f"1x{tt.shape[1]}x{qq.shape[1]} f32",
                         plan=plan_line(dp_fill, 1, tt.shape[1], qq.shape[1], m, ms),
                         **fill_bound(len(pq) * len(pt), OPS_FILL_DIRS, args, m, got)))
    print_rows(rows)
    # the PWM plane (K3) on no path of the run: timed at the survivors' shape
    rng = np.random.default_rng(SEED + 32)
    win = PWM_W + OFFSET
    pwm = torch.as_tensor(scan_pwm(at, rng), device=dev)
    q, ql = tensors(dev, rng.integers(0, 4, (N_SURVIVORS, win)), np.full(N_SURVIVORS, win))
    kw = dict(with_dirs=True, with_scores_plane=True)
    got, ms, want, plain_ms = timed_pair(
        lambda: dp_fill.fill_pwm(q, ql, pwm, PWM_DEL, PWM_EXT, **kw),
        lambda: scan_engine.fill_pwm_batch(q, ql, pwm, PWM_DEL, PWM_EXT, **kw), 3)
    check(same_plane(got, want), "PWM dp_fill plane != plain at the survivors' shape")
    b = fill_bound(N_SURVIVORS * win * PWM_W, OPS_FILL_DIRS, (q, ql), pwm, got)
    print(f"  dp_fill PWM (score plane, survivors' shape {N_SURVIVORS}x{win}x{PWM_W} f64, "
          f"on no path): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}", flush=True)
    return rows[:1]


def phase_simple(at, native, read_fasta_file):
    """The simple aligners, the keep_planes path, on the card:
    ``SimpleGlobalAligner``/``SimpleLocalAligner.from_str_seqs`` on the three
    example FASTAs (strings, coords and f against the golden fixtures; the
    score plane as float64 and the directions against ``native.fill``), then
    ``perform_alignment`` in both modes on a seeded homologous pair of
    8,192 x 8,192, the most cells ``keep_planes`` takes: its planes against
    native C++ bit for bit, its strings against ``device="host"``, timed."""
    from aligner_tpu_torch.observability import counters
    from aligner_tpu_torch.ops import wavefront as wf

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "fixtures", "examples_golden.json")) as fh:
        golden = json.load(fh)
    classes = {"global": at.SimpleGlobalAligner, "local": at.SimpleLocalAligner}
    n = 0
    for example, cases in sorted(golden.items()):
        recs = read_fasta_file(os.path.join(here, "examples", f"{example}.fasta"))
        qs, ts = recs[0].seq.decode(), recs[1].seq.decode()
        q = at.Protein.encode(qs, strict=True)
        t = at.Protein.encode(ts, strict=True)
        for key, want in cases.items():
            mode, d, e = key.split("_")
            d, e = float(d[1:]), float(e[1:])
            r = classes[mode].from_str_seqs(qs, ts).perform_alignment(
                d, e, at.blosum62(), device=DEVICE)
            aln = r.alignment
            what = f"{example} {key}"
            check(aln.f == want["f"], f"{what}: f")
            check(tuple(map(tuple, aln.coords)) == tuple(map(tuple, want["coords"])),
                  f"{what}: coords")
            check(at.Protein.decode(aln.query) == want["query"], f"{what}: query")
            check(at.Protein.decode(aln.target) == want["target"], f"{what}: target")
            plane, dirs = native.fill(q, t, np.asarray(at.blosum62()), d, e, mode)
            check(r.score.shape == plane.shape
                  and np.array_equal(r.score.astype(np.float64), plane),
                  f"{what}: the score plane != native C++")
            check(np.array_equal(r.directions, dirs), f"{what}: the directions != native C++")
            n += 1
    check(n == 12, f"expected 12 golden cases, ran {n}")
    print(f"  the simple aligners on the example FASTAs: {n} of 12 equal the golden "
          f"fixtures, their planes native C++'s", flush=True)

    q, t = homologous_pair(PLANE_SEED, PLANE_LEN, PLANE_LEN)
    check(len(q) * len(t) == wf.DIRECT_PLANE_CELLS,
          "the plane pair is not the direct-plane budget")
    m = at.blosum62()
    for mode, cls in classes.items():
        aligner = cls.from_seqs(q, t)
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = aligner.perform_alignment(DEL, EXT, m, device=DEVICE)
        wall = time.perf_counter() - t0
        fill = counters.snapshot()[f"{DEVICE}/{mode}"]
        t0 = time.perf_counter()
        h = aligner.perform_alignment(DEL, EXT, m, device="host")
        host_wall = time.perf_counter() - t0
        check(r.score.shape == h.score.shape
              and np.array_equal(r.score.astype(np.float64), h.score),
              f"{mode} {PLANE_LEN}^2: the score plane != native C++")
        check(np.array_equal(r.directions, h.directions),
              f"{mode} {PLANE_LEN}^2: the directions != native C++")
        check(same_alignment(r.alignment, h.alignment) and r.alignment.f == h.alignment.f,
              f"{mode} {PLANE_LEN}^2: the alignment != device=\"host\"")
        cells = PLANE_LEN * PLANE_LEN
        # the fill's outputs written once: the plane and the words (8 rows a word)
        b = bound(OPS_FILL_DIRS * cells, cells * r.score.itemsize + cells // 2,
                  rate=PEAK_OPS_S)
        print(f"  {cls.__name__} {PLANE_LEN}x{PLANE_LEN} keep_planes: call wall "
              f"{wall:.3f} s, plane fill (one thread, synchronised) {fill.seconds:.3f} s "
              f"({fill.seconds * 1e9 / cells:.1f} ns a cell; bound {b['bound_ms']:.4f} ms "
              f"by {b['bound_by']}), the rest (planes to the "
              f"host, borders, the walk) {wall - fill.seconds:.3f} s; device=\"host\" "
              f"(native C++ fill and walk) {host_wall:.3f} s; planes equal native C++, "
              f"the score plane {r.score.dtype}, alignment length "
              f"{len(r.alignment.query)}, f {r.alignment.f}", flush=True)
        del r, h


def phase_host_walks(at, sp, plain, wide, blocked, launch_counts, reset_counts):
    """``walk="host"`` against the default walk on every route: the full
    batch (4,096 x 400^2, local and global), the 1,024 PWM survivors
    (330 x W 300), ``align_global`` at 65,536 x 65,536 and the column-blocked
    pipeline on that pair as 4 column blocks.  The default walks run first;
    the host walks are then this path's run, counted from zero: K4 and W
    must not launch.  Returns the path's launch counts."""
    m = at.blosum62()
    qs, ts = full_batch_pairs()
    rng = np.random.default_rng(SEED + 33)
    pwm = scan_pwm(at, rng)
    surv = list(rng.integers(0, 4, (N_SURVIVORS, PWM_W + OFFSET)).astype(np.int8))
    want, dev_walls = {}, {}
    for mode in ("local", "global"):
        t0 = time.perf_counter()
        want[mode] = at.batch_align(qs, ts, m, DEL, EXT, mode=mode, with_alignments=True,
                                    device=DEVICE)
        dev_walls[mode] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_pwm = at.batch_align_pwm(surv, pwm, PWM_DEL, PWM_EXT, with_alignments=True,
                                  device=DEVICE)
    dev_walls["pwm"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    got, walls = {}, {}
    for mode in ("local", "global"):
        t0 = time.perf_counter()
        got[mode] = at.batch_align(qs, ts, m, DEL, EXT, mode=mode, with_alignments=True,
                                   device=DEVICE, walk="host")
        walls[mode] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_pwm = at.batch_align_pwm(surv, pwm, PWM_DEL, PWM_EXT, with_alignments=True,
                                 device=DEVICE, walk="host")
    walls["pwm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    huge = at.align_global(plain["q"], plain["t"], m, DEL, EXT, device=DEVICE, walk="host")
    walls["huge"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk = sp.sharded_global_align(BLOCKED_B, plain["q"], plain["t"], np.asarray(m), DEL,
                                  EXT, device=DEVICE, walk="host")
    walls["blocked"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    for mode in ("local", "global"):
        check(all((a is None) == (b is None) and (a is None or (
            same_alignment(a.alignment, b.alignment) and a.alignment.f == b.alignment.f))
            for a, b in zip(got[mode], want[mode])),
            f"full batch {mode}: walk=\"host\" != the device walk")
    check(all(np.array_equal(a.alignment.numbered, b.alignment.numbered)
              and np.array_equal(a.alignment.query, b.alignment.query)
              and a.alignment.coords == b.alignment.coords
              and a.alignment.f == b.alignment.f for a, b in zip(got_pwm, want_pwm)),
          "PWM survivors: walk=\"host\" != the device walk")
    check(same_alignment(huge.alignment, wide["pair_b"]),
          "align_global 65,536^2: walk=\"host\" != the device walk")
    res_b = blocked["B"]["res"]
    check(blk[0] == res_b[0] and np.array_equal(blk[1], res_b[1])
          and np.array_equal(blk[2], res_b[2]) and blk[3] == res_b[3],
          "the column-blocked pipeline: walk=\"host\" != the device walk")
    check(counts["walk"] == 0 and counts["replay_walk"] == 0,
          f"walk=\"host\" launched a walk kernel ({counts['walk']} K4, "
          f"{counts['replay_walk']} W)")
    print(f"  walk=\"host\" equals the device walk: full batch local {walls['local']:.3f} s "
          f"(device walk {dev_walls['local']:.3f} s), global {walls['global']:.3f} s "
          f"({dev_walls['global']:.3f} s) ({N_FULL} pairs), PWM survivors "
          f"{walls['pwm']:.3f} s ({dev_walls['pwm']:.3f} s) ({N_SURVIVORS}), align_global "
          f"{PAIR_LEN}^2 "
          f"{walls['huge']:.3f} s, column-blocked {PAIR_LEN}^2 in {BLOCKED_B} blocks "
          f"{walls['blocked']:.3f} s; K4 and W launched {counts['walk']} and "
          f"{counts['replay_walk']} times", flush=True)
    return counts


def fit_rate(points):
    """Least squares of ``1 / rate = NS / tr + NS·L / cb``, relative to each
    point, over ``(tr, cb, GCUPS)`` points: the ``(NS, L)`` of the engine
    pick's rate model (``parallel/wavefront_sp.py``)."""
    a = np.array([[g / tr, g / cb] for tr, cb, g in points])
    (ns, ns_l), *_ = np.linalg.lstsq(a, np.ones(len(points)), rcond=None)
    return float(ns), float(ns_l / ns)


def engine_calibration(dev, at, wf, sp, k7_points=None):
    """The engine pick's calibration on the 262,144 x 262,144 pair: the band
    engine's scores-only forward by band height at CB_COLS-wide column
    blocks and at two other widths, and the row-scan engine's at
    FORWARD_ROWS rows by column width (the block sweep's, or measured here
    when not given) and at CB_COLS columns by the heights of K7_CAL_ROWS,
    each on a target of that many rows (a short target, one row block);
    each point beside the shipped model, the model's largest error, this
    run's least-squares constants, and the picks at 262,144^2, 524,288^2
    and 524,288 x SHORT_LEN with and without a traceback.  Returns the
    points."""
    m = np.array(at.blosum62())
    q, t = homologous_pair(PAIR_SEED + 2, WIDE_LEN, WIDE_LEN)

    def forward_gcups(cb, tr, engine, rows=WIDE_LEN):
        pp = sp._prep_sharded(WIDE_LEN // cb, q, t[:rows], m, DEL, EXT, tr, None, engine,
                              dev)
        check(pp["Cb"] == cb and pp["tr"] == tr and pp["engine"] == engine,
              f"the calibration's {engine} blocks came out {pp['tr']} x {pp['Cb']}")
        ms = gpu_ms(lambda: sp._forward(pp, False), 1)
        return (tr, cb, rows * WIDE_LEN / ms / 1e6)

    band = [forward_gcups(cb, tr, "band") for cb, heights in BAND_CAL for tr in heights]
    if k7_points is None:
        k7_points = [forward_gcups(cb, sp.FORWARD_ROWS, "pallas") for cb in CB_SWEEP]
    k7_points = list(k7_points) + [forward_gcups(sp.CB_COLS, tr, "pallas", rows=tr)
                                   for tr in K7_CAL_ROWS]
    for name, points, model in (
            ("band", band, sp.band_rate_model),
            ("row-scan", k7_points, lambda tr, cb: sp.rowscan_rate_model(cb, tr))):
        errs = []
        for tr, cb, g in points:
            p = model(tr, cb)
            errs.append(p / g - 1)
            print(f"  calibration, {name} engine, forward in blocks of {tr} rows x {cb} "
                  f"columns: {g:.1f} GCUPS, modelled {p:.1f} "
                  f"({errs[-1]:+.1%})", flush=True)
        ns, L = fit_rate(points)
        print(f"  calibration, {name} engine: the shipped model's largest error "
              f"{max(abs(e) for e in errs):.1%}; this run's fit: {ns:.2f} ns a column, "
              f"{L:.3f} columns a row", flush=True)
    for q_len, t_len in ((WIDE_LEN, WIDE_LEN), (BLOCKED_LEN, BLOCKED_LEN),
                         (BLOCKED_LEN, SHORT_LEN)):
        n = -(-q_len // sp.CB_COLS)
        for what, cap in (("an end score", wf.BAND_ROWS), ("an alignment", sp.TB_ROWS)):
            e, tr, g = sp.auto_shard_config(q_len, t_len, n, max_band_tr=cap)
            print(f"  engine pick at {t_len}x{q_len} in {n} column blocks, {what} (band "
                  f"height at most {cap}): {e!r} in blocks of {tr} rows, {g:.1f} GCUPS "
                  f"modelled", flush=True)
    return dict(band=band, rowscan=k7_points)


def phase_engines(at, wf, sp, cli_align, blocked, tmp):
    """Drives the column-blocked pipeline's engines, and nothing else, so
    that the launch counts read after it are the path's own: the band
    engine's end score and alignment of the 65,536 x 65,536 pair in 4
    column blocks and of the 524,288 x 524,288 pair, that pair's end score
    on the row-scan engine, its alignment and end score with BLOSUM62 x 20
    (del 220, ext 40) through ``align_global`` and ``global_end_score`` with
    no backend and no engine named (the "lax" engine, by the matrix), and
    ``aligner-align -g -m FILE`` with that matrix on a pair one COL_PAD
    wider than one plane.  Returns each run's result, wall, the module's
    counters and the arguments its engine and blocks follow from, for
    :func:`hold_engines`."""
    from aligner_tpu_torch.observability import counters

    m_np = np.asarray(at.blosum62())
    m20 = LAX_SCALE * m_np
    b, a = blocked["B"], blocked["A"]
    runs = {}

    def drive(name, fn, n_blocks, q, t, m, d, e, tb, engine):
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        runs[name] = dict(res=res, wall=time.perf_counter() - t0, stats=counters.snapshot(),
                          prep=(n_blocks, q, t, m, d, e, None, tb, engine))

    for pair, n_blocks, p in (("B", BLOCKED_B, b), ("A", None, a)):
        q, t = p["q"], p["t"]
        drive(f"{pair} band end", lambda: sp.sharded_global_end_score(
            n_blocks, q, t, m_np, DEL, EXT, engine="band", device=DEVICE),
            n_blocks, q, t, m_np, DEL, EXT, None, "band")
        drive(f"{pair} band align", lambda: sp.sharded_global_align(
            n_blocks, q, t, m_np, DEL, EXT, engine="band", device=DEVICE),
            n_blocks, q, t, m_np, DEL, EXT, sp.TB_ROWS, "band")
    q, t = a["q"], a["t"]
    drive("A pallas end", lambda: sp.sharded_global_end_score(
        None, q, t, m_np, DEL, EXT, engine="pallas", device=DEVICE),
        None, q, t, m_np, DEL, EXT, None, "pallas")
    drive("A lax align", lambda: at.align_global(q, t, m20, LAX_DEL, LAX_EXT,
                                                 device=DEVICE).alignment,
          None, q, t, m20, LAX_DEL, LAX_EXT, sp.TB_ROWS, None)
    drive("A lax end", lambda: at.global_end_score(q, t, m20, LAX_DEL, LAX_EXT,
                                                   device=DEVICE),
          None, q, t, m20, LAX_DEL, LAX_EXT, None, None)
    # the CLI on a matrix file, one COL_PAD past the width cap
    qc, tc = homologous_pair(PAIR_SEED + 7, *CLI_WIDE_PAIR)
    check(len(qc) > wf.MAX_WIDTH, "the CLI's pair is not wider than one plane")
    fasta, mfile = os.path.join(tmp, "wide.fasta"), os.path.join(tmp, "b62x20.txt")
    write_db(fasta, [at.Protein.decode(qc).encode(), at.Protein.decode(tc).encode()],
             ["query", "target"])
    with open(mfile, "w") as fh:
        fh.write("\n".join(" ".join(str(int(v)) for v in row) for row in m20) + "\n")
    buf = io.StringIO()
    argv = ["-i", fasta, "-g", "-m", mfile, "-d", str(LAX_DEL), "-e", str(LAX_EXT),
            "--device", DEVICE]

    def cli():
        with contextlib.redirect_stdout(buf):
            return cli_align.main(argv)

    drive("CLI", cli, None, qc, tc, m20, LAX_DEL, LAX_EXT, sp.TB_ROWS, None)
    runs["CLI"].update(stdout=buf.getvalue(), q=qc, t=tc)
    return runs


def hold_engines(dev, at, wf, sp, cli_align, blocked, runs, counts, k7_points):
    """What :func:`phase_engines` ran, against the plain versions and the
    other engines, and its launch counts against its blocks and tiles: K7
    with BLOSUM62 x 20 on ragged blocks and on the last replay tile of the
    524,288 x 524,288 pair, bit for bit against its plain version; the band
    engine's last block of the 524,288 x 524,288 alignment (32,768 x
    131,072 at its last column block, ending the last replay tile) against
    the plain band fill; the 65,536 x 65,536 pair's band records in 4
    column blocks and its step stream against the row-scan engine's, its
    strings against phase 12's; at 524,288 x 524,288 the band engine's end
    score against K7's and its rescored path, and the "lax" engine's
    strings against phase 12's BLOSUM62 alignment with 20 times its end
    score; the CLI's stdout against the rendering of the BLOSUM62
    alignment; then the engine pick's calibration.  Returns the kernels' rows."""
    m_np = np.asarray(at.blosum62())
    m20 = LAX_SCALE * m_np
    b, a = blocked["B"], blocked["A"]
    rows = []

    # the launch counts: one K6 launch a band-engine block, one K7 launch a
    # row-scan or lax forward block, one K7 launch with directions and one
    # walk a tile replayed, and no other kernel
    want = dict(band_sp=0, block_cs=0, tiles=0)
    for name, r in runs.items():
        pp = sp._prep_sharded(*r["prep"], DEVICE)
        blocks = pp["J"] * pp["n"]
        want["band_sp" if pp["engine"] == "band" else "block_cs"] += blocks
        rep = r["stats"].get(f"{DEVICE}/wavefront-sp-replay")
        tiles = rep.cells // (pp["tb"] * pp["Cb"]) if rep else 0
        want["tiles"] += tiles
        r.update(engine=pp["engine"], blocks=blocks, tiles=tiles, tr=pp["tr"], Cb=pp["Cb"])
    check(counts["band_sp"] == counts["band_tile_launches"] == want["band_sp"] > 0
          and counts["block_cs"] == want["block_cs"] > 0
          and counts["block_cs_dirs"] == counts["replay_walk"] == want["tiles"] > 0
          and counts["block_cs_tile_launches"] == want["block_cs"] + want["tiles"],
          f"the engines' path launched {counts}, its blocks and tiles ask for {want}")
    others = {k: v for k, v in counts.items()
              if k not in ("band_sp", "band_tile_launches", "block_cs", "block_cs_dirs",
                           "block_cs_tile_launches", "replay_walk") and v}
    check(not others, f"the engines' path launched other kernels: {others}")
    for name, r in runs.items():
        print(f"  {name}: engine {r['engine']!r}, {r['blocks']} forward blocks of {r['tr']} "
              f"rows x {r['Cb']} columns, {r['tiles']} tiles replayed, wall {r['wall']:.3f} s",
              flush=True)

    # K7 with entries beyond int8 on ragged blocks of the pipeline
    kw20 = dict(del_=LAX_DEL, ext=LAX_EXT)
    n_held = 0
    for C, R, cb, tb in ((513, 100, 256, 64), (700, 300, 512, 128), (260, 1000, 256, 128)):
        q, t = homologous_pair(SEED + 40 + C, C, R)
        pp = sp._prep_sharded(-(-C // cb), q, t, m20, LAX_DEL, LAX_EXT, tb, tb, None, dev)
        check(pp["engine"] == "lax", "BLOSUM62 x 20 did not take the \"lax\" engine")
        _, lb_hist, ckpts = sp._forward(pp, True)
        for j in range(pp["J"]):
            for d in range(pp["n"]):
                h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, j, d)
                args = (pp["q_dev"][d * cb:(d + 1) * cb], pp["t_dev"][j * tb:(j + 1) * tb],
                        pp["m_dev"], h0, lb, d * cb, j * tb, C, R)
                for dirs in (False, True):
                    ck = 0 if dirs else tb
                    got = wf.run_block_cs(*args, **kw20, with_dirs=dirs, ckpt_every=ck)
                    want_b = wf.run_block_cs_plain(*args, **kw20, with_dirs=dirs, ckpt_every=ck)
                    check(same_block(got, want_b, min(tb, R - j * tb), min(cb, C - d * cb)),
                          f"run_block_cs != plain with BLOSUM62 x 20 ({C}x{R}, block "
                          f"({j}, {d}), dirs={dirs})")
                    n_held += 1
    # ... and on the last replay tile of the 524,288 x 524,288 pair
    q, t = a["q"], a["t"]
    pp = sp._prep_sharded(None, q, t, m20, LAX_DEL, LAX_EXT, None, sp.TB_ROWS, None, dev)
    _, lb_hist, ckpts = sp._forward(pp, True)
    j, d, Cb, TB = pp["R_pad"] // pp["tb"] - 1, pp["n"] - 1, pp["Cb"], pp["tb"]
    h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, j, d)
    tile = (pp["q_dev"][d * Cb:(d + 1) * Cb], pp["t_dev"][j * TB:(j + 1) * TB], pp["m_dev"],
            h0, lb, d * Cb, j * TB, pp["C_real"], pp["R_real"])
    del lb_hist, ckpts
    got, ms, want_t, plain_ms = timed_pair(
        lambda: wf.run_block_cs(*tile, **kw20, with_dirs=True, check_codes=False),
        lambda: wf.run_block_cs_plain(*tile, **kw20, with_dirs=True), 3)
    check(same_block(got, want_t, TB, Cb),
          f"run_block_cs != plain with BLOSUM62 x 20 on the last replay tile ({TB}x{Cb})")
    n_held += 1
    rows.append(dict(
        name=f"wavefront_block_cs (directions, BLOSUM62 x {LAX_SCALE}, the \"lax\" engine's "
             f"last replay tile at column {d * Cb})", route="cuda",
        source="aligner_tpu_torch/csrc/wavefront_block.cu", replaces=REPLACES["block_cs"],
        path="engines", counter="block_cs_dirs",
        max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want_t) if x is not None),
        ms=ms, plain_ms=plain_ms, shape=f"{TB}x{Cb} int32",
        **bound(OPS_SCAN_DIRS * TB * Cb, nbytes(*tile[:5], *got))))
    del got, want_t, tile

    # the band engine's block that ends the last replay tile of pair A's
    # alignment at its last column block: x0 > 0, a streamed left boundary,
    # the end cell
    ppa = sp._prep_sharded(*runs["A band align"]["prep"], dev)
    trace = collections.deque(maxlen=1)  # the last band alone
    _, _, ck_a = sp._forward(ppa, True, trace=trace)
    Cb, tr, d = ppa["Cb"], ppa["tr"], ppa["n"] - 1
    check(tr == ppa["tb"] and d > 0, "the band engine's bands are not replay tiles")
    args, kw, _ = trace[-1]
    got, ms, want_k6, plain_ms = timed_pair(
        lambda: wf.run_block_band(*args, **kw),
        lambda: wf.run_block_band_plain(*args, Cb=Cb, ext=kw["ext"]), 3)
    khat = torch.arange(Cb, dtype=torch.int32, device=dev) * ppa["ext"]
    bottom = wf.band_handoff(got[0], tr, ppa["ext"])[:Cb] - khat
    bottom_p = wf.band_handoff(want_k6[0], tr, ppa["ext"])[:Cb] - khat
    check(same_band(got, want_k6, tr, Cb) and torch.equal(bottom, bottom_p)
          and torch.equal(bottom, ck_a[-1, d * Cb:(d + 1) * Cb])
          and int(got[2]) == a["score"],
          "run_block_band != plain on the band engine's last block (its de-hatted last "
          "row, its right column, the end cell)")
    n_held += 1
    rows.append(dict(
        name=f"wavefront_band (scores, the band engine's last block of {tr} rows at "
             f"column {d * Cb})",
        route="cuda", source="aligner_tpu_torch/csrc/wavefront_band.cu",
        replaces=REPLACES["band"], path=("column_blocked", "engines", "sharded"),
        counter="band_sp",
        max_abs_err=max(max_abs_err(bottom, bottom_p), max_abs_err(got[1], want_k6[1])),
        ms=ms, plain_ms=plain_ms, shape=f"{tr}x{Cb} int32",
        **bound(OPS_BAND * tr * Cb, nbytes(*args[:7], *got))))
    del got, want_k6, args, trace, ck_a
    print_rows(rows)
    print(f"  {n_held} column-block and band fills with the engines' operands bit-identical "
          f"to their plain versions", flush=True)

    # pair B: the band engine's records and walk are the row-scan engine's
    q, t = b["q"], b["t"]
    ppb = sp._prep_sharded(BLOCKED_B, q, t, m_np, DEL, EXT, None, sp.TB_ROWS, "band", dev)
    ppr = sp._prep_sharded(BLOCKED_B, q, t, m_np, DEL, EXT, None, sp.TB_ROWS, "pallas", dev)
    _, lb_b, ck_b, state_b, steps_b, info_b = sp._sharded_walk(ppb)
    _, lb_r, ck_r, state_r, steps_r, info_r = sp._sharded_walk(ppr)
    C = len(q)
    check(torch.equal(lb_b, lb_r) and torch.equal(ck_b[:, :C], ck_r[:, :C])
          and same_walk((state_b, steps_b), (state_r, steps_r)),
          "the band engine's boundary history, checkpoint rows or step stream != the "
          "row-scan engine's")
    end_bb, *aln_bb = runs["B band align"]["res"]
    check(end_bb == runs["B band end"]["res"] == b["es"]
          and all(np.array_equal(x, y) for x, y in zip(aln_bb[:2], b["res"][1:3]))
          and aln_bb[2] == b["res"][3],
          "the band engine's 4-block alignment != phase 12's")
    print(f"  {len(t)}x{C} in {ppb['n']} column blocks: the band engine ({ppb['J']} x "
          f"{ppb['n']} bands of {ppb['tr']} rows, forward {info_b['forward_s']:.4f} s) and the "
          f"row-scan engine ({ppr['J']} x {ppr['n']} blocks of {ppr['tr']} rows, forward "
          f"{info_r['forward_s']:.4f} s) record the same boundaries and checkpoint rows and "
          f"walk the same steps; the strings equal phase 12's", flush=True)

    # pair A: the band engine against K7's forward, the lax engine against
    # BLOSUM62's alignment
    q, t = a["q"], a["t"]
    end_ab, *aln_ab = runs["A band align"]["res"]
    es_band, es_k7 = runs["A band end"]["res"], runs["A pallas end"]["res"]
    rescored = wf.rescore_steps(*wf.alignment_steps(*aln_ab[:2]), q, t, m_np, DEL, EXT)
    check(end_ab == es_band == es_k7 == a["score"] == rescored,
          f"524,288^2 on the band engine: end score {end_ab} / {es_band}, K7's {es_k7}, "
          f"phase 12's {a['score']}, rescored {rescored}")
    check(np.array_equal(aln_ab[0], a["alignment"].query)
          and np.array_equal(aln_ab[1], a["alignment"].target),
          "524,288^2: the band engine's strings != phase 12's")
    lax_aln, es_lax = runs["A lax align"]["res"], runs["A lax end"]["res"]
    check(same_alignment(lax_aln, a["alignment"]) and es_lax == LAX_SCALE * a["score"],
          f"524,288^2 with BLOSUM62 x {LAX_SCALE}: end score {es_lax} or the strings != "
          f"{LAX_SCALE} x phase 12's")
    rescored20 = wf.rescore_steps(*wf.alignment_steps(lax_aln.query, lax_aln.target), q, t,
                                  m20, LAX_DEL, LAX_EXT)
    check(rescored20 == es_lax, f"the lax path rescored {rescored20} != its end score")
    r = runs
    print(f"  {len(t)}x{len(q)}: band engine end score {int(es_band)} in "
          f"{r['A band end']['wall']:.3f} s, alignment {r['A band align']['wall']:.3f} s; "
          f"K7's forward {r['A pallas end']['wall']:.3f} s, equal; the band path rescored "
          f"equals it and its strings phase 12's; BLOSUM62 x {LAX_SCALE} (del {LAX_DEL}, "
          f"ext {LAX_EXT}) on the {r['A lax align']['engine']!r} engine: align_global "
          f"{r['A lax align']['wall']:.3f} s, global_end_score {r['A lax end']['wall']:.3f} s "
          f"= {LAX_SCALE} x {int(a['score'])}, strings equal phase 12's", flush=True)

    # the CLI against the rendering of BLOSUM62's alignment of its pair
    c = runs["CLI"]
    ref_aln = at.align_global(c["q"], c["t"], m_np, DEL, EXT, device=DEVICE).alignment
    check(c["res"] == 0 and c["stdout"] == cli_align.reference_debug_format(ref_aln, m20)
          + "\n", "aligner-align -g -m FILE with BLOSUM62 x 20 != the rendering of the "
          "BLOSUM62 alignment")
    print(f"  aligner-align -g -m FILE (BLOSUM62 x {LAX_SCALE}, -d {LAX_DEL} -e {LAX_EXT}) on "
          f"{CLI_WIDE_PAIR[1]}x{CLI_WIDE_PAIR[0]}: engine {c['engine']!r}, wall "
          f"{c['wall']:.3f} s, stdout ({len(c['stdout'])} bytes) equals the rendering of the "
          f"BLOSUM62 alignment", flush=True)
    engine_calibration(dev, at, wf, sp, k7_points)
    return rows


@contextlib.contextmanager
def card_twice(align):
    """The auto-shard's shard list (``align._shard_devices``) given as the
    one card ``MESH_SHARDS`` times, for the duration: the sharded path on a
    one-card machine."""
    saved = align._shard_devices
    align._shard_devices = lambda device: [torch.device(DEVICE, 0)] * MESH_SHARDS
    try:
        yield
    finally:
        align._shard_devices = saved


def timed(fn):
    """(fn(), host wall in s with the card synchronised on both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_inputs(at, repeat, pq, pt, raw, service_text):
    """The multi-device phase's inputs (the ranks get them as an ``.npz``):
    the p-value's 4,999 shuffles padded as ``batch_align`` pads them, the
    10 Mb chromosome with its scan's window bounds padded with empty
    windows to a multiple of the ranks' 4 slots and a scan PWM, the
    service's 6 task pairs (every two of its 4 records) and 64 seeded
    {-1, 0, 1} matrices (V = 24, as ``service/store.py`` makes them)."""
    from aligner_tpu_torch.align import pad_batch

    sh = shuffles_for_p_value(at, pq, pt, N_PVALUE)
    sh_q, sh_ql = pad_batch([pq] * len(sh))
    sh_t, sh_tl = pad_batch(sh)
    seq = at.DNA.encode(raw)
    opts = repeat.SearchOptions(repeat_length=PWM_W, query_offset=OFFSET,
                                deletions=PWM_DEL, extension=PWM_EXT, device=DEVICE)
    wins = repeat.windows_of(len(seq), opts, OFFSET)
    pad = -len(wins) % (MESH_RANKS * MESH_SHARDS)
    recs = [at.Protein.encode(r.split("\n", 1)[1].replace("\n", ""), strict=True)
            for r in service_text.split(">")[1:]]
    pairs = [(a, b) for i, a in enumerate(recs) for b in recs[i + 1:]]
    pop_q, pop_ql = pad_batch([a for a, _ in pairs])
    pop_t, pop_tl = pad_batch([b for _, b in pairs])
    rng = np.random.default_rng(MESH_SEED)
    return dict(
        sh_q=sh_q, sh_ql=sh_ql, sh_t=sh_t, sh_tl=sh_tl, seq=seq, n_wins=len(wins),
        starts=np.array([a for a, _ in wins] + [0] * pad, np.int64),
        borders=np.array([b for _, b in wins] + [0] * pad, np.int64),
        pwm=scan_pwm(at, rng),
        mats=rng.integers(-1, 2, (POP_M, POP_DIM, POP_DIM)).astype(np.float64),
        pop_q=pop_q, pop_ql=pop_ql, pop_t=pop_t, pop_tl=pop_tl,
        b62=np.asarray(at.blosum62(), np.float64)), sh, wins, opts


def window_rows(seq, starts, borders):
    """(windows (B, R8) int32, lengths (B,)) of the given window bounds,
    as the scan gathers them (an empty window for bounds (0, 0))."""
    lens = (borders - starts).astype(np.int32)
    R8 = -(-int(lens.max(initial=1)) // 8) * 8
    cols = np.arange(R8, dtype=np.int64)
    idx = np.minimum(starts[:, None] + cols, len(seq) - 1)
    return np.where(cols < lens[:, None], seq[idx], 0).astype(np.int32), lens


def mesh_rank(in_path: str, out_prefix: str) -> int:
    """One rank of the multi-device phase, started by it as a copy of this
    script (``--mesh-rank IN OUT`` with ``ALIGNER_COORDINATOR``,
    ``ALIGNER_PROCESS_ID`` and ``ALIGNER_NUM_PROCESSES`` set): joins the
    gloo group, builds the global mesh with the card twice as its shards (a
    (2, 2) mesh over 2 ranks), runs the three mesh steps on its
    ``process_span`` blocks, gathers the results through the layouts into
    ``OUT.<rank>.npz``; then aligns and end-scores the 524,288 x 524,288 pair
    (made here from ``PAIR_SEED + 5``) on the column-blocked pipeline over
    the mesh's data axis (one slot a rank, 2 of the 4 column blocks each,
    the engines ``auto_shard_config`` picks for 2 slots), its end score,
    strings and coordinates into the same file; and prints its launch
    counts and walls (the pipeline's forward, hand-off wait, gather bytes
    and seconds and replay from the counters)."""
    import torch.distributed as dist

    from aligner_tpu_torch.observability import counters
    from aligner_tpu_torch.ops import _build, device_walk, dp_fill
    from aligner_tpu_torch.ops import wavefront as wf
    from aligner_tpu_torch.parallel import mesh as pm
    from aligner_tpu_torch.parallel import multihost
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    multihost.initialize_from_env("gloo")
    rank = dist.get_rank()
    _build.load()
    x = dict(np.load(in_path))
    mesh = multihost.global_mesh(devices=[torch.device(DEVICE, 0)] * MESH_SHARDS)
    check(mesh.shape == {"data": 2, "matrix": 2}, f"the ranks' mesh is {mesh.shape}")
    out, walls = {}, {}

    def step(name, fn):
        res, walls[name] = timed(fn)
        return res

    def blocks(rows, n, lo=0):
        """This rank's blocks of ``rows`` (its span from row ``lo`` of
        them) in a batch of ``n`` rows, and their layout."""
        a, b = multihost.process_span(n)
        got = [multihost.shard_local_batch(mesh, r[a - lo:b - lo], global_rows=n)
               for r in rows]
        return [g for g, _ in got], got[0][1]

    n = len(x["sh_ql"])
    (q, ql, t, tl), lay = blocks((x["sh_q"], x["sh_ql"], x["sh_t"], x["sh_tl"]), n)
    out["layout"] = np.array([*lay.spans[rank], len(q), lay.per_pad, lay.global_rows])
    res = step("sharded_scores", lambda: pm.sharded_scores(mesh, q, ql, t, tl, x["b62"],
                                                          DEL, EXT))
    got = step("gather of its 4 outputs", lambda: [lay.gather(r) for r in res])
    for f, g in zip(("fmax", "fy", "fx", "end"), got):
        out[f"scores_{f}"] = g.cpu().numpy()

    n = len(x["starts"])
    lo, hi = multihost.process_span(n)
    rows = step("window rows on the host", lambda: window_rows(
        x["seq"], x["starts"][lo:hi], x["borders"][lo:hi]))
    (ws, wl), lay = blocks(rows, n, lo)
    scan = step("window_scan_step", lambda: pm.window_scan_step(mesh, ws, wl, x["pwm"],
                                                               PWM_DEL, PWM_EXT))
    got = step("gather of scores and z", lambda: [lay.gather(g) for g in scan[:2]])
    out["scan_scores"], out["scan_z"] = (g.cpu().numpy() for g in got)
    out["scan_stats"] = np.array([float(scan[2]), float(scan[3])])
    partial = torch.zeros(3, dtype=torch.float64)
    dist.barrier()
    step("all_reduce of 3 float64 (the step's collective)",
         lambda: dist.all_reduce(partial))

    (q, ql, t, tl), lay = blocks((x["pop_q"], x["pop_ql"], x["pop_t"], x["pop_tl"]),
                                 len(x["pop_ql"]))
    best, win = step("matrix_population_step", lambda: pm.matrix_population_step(
        mesh, q, ql, t, tl, x["mats"], DEL, DEL))
    out["pop_best"], out["pop_win"] = (lay.gather(g).cpu().numpy() for g in (best, win))

    q, t = homologous_pair(PAIR_SEED + 5, BLOCKED_LEN, BLOCKED_LEN)
    b62 = np.asarray(x["b62"])
    name = f"{DEVICE}/wavefront-sp"
    dist.barrier()
    counters.reset()
    end, qa, ta, coords = step("sharded_global_align of the 524,288^2 pair", lambda: (
        sp.sharded_global_align(mesh, q, t, b62, DEL, EXT)))
    k = counters.snapshot()
    walls.update({
        "its forward": k[name].seconds, "its replay": k[f"{name}-replay"].seconds,
        "its hand-off wait": k[f"{name}-handoff"].seconds if rank else 0.0,
        "its hand-offs": k[f"{name}-handoff"].cells if rank else 0,
        "its gather": k[f"{name}-gather"].seconds,
        "its gather bytes": k[f"{name}-gather"].cells})
    dist.barrier()
    score = step("sharded_global_end_score of the 524,288^2 pair", lambda: (
        sp.sharded_global_end_score(mesh, q, t, b62, DEL, EXT)))
    out.update(pipe_end=np.array([end, score]), pipe_qa=qa, pipe_ta=ta,
               pipe_coords=np.array(coords))
    np.savez(f"{out_prefix}.{rank}.npz", **out)
    L = wf.launches
    print("launches " + json.dumps(dict(
        scores=dp_fill.launches.scores, dirs=dp_fill.launches.dirs,
        pwm_scores=dp_fill.launches.pwm_scores, pwm_dirs=dp_fill.launches.pwm_dirs,
        walk=device_walk.launches.walk, block_cs=L.block_cs,
        block_cs_dirs=L.block_cs_dirs, block_cs_tile_launches=L.block_cs_tile_launches,
        band_sp=L.band_sp, band_tile_launches=L.band_tile_launches,
        replay_walk=L.replay_walk)), flush=True)
    print("walls " + json.dumps(walls), flush=True)
    dist.destroy_process_group()
    return 0


def run_mesh_ranks(in_path: str, out_prefix: str, tmp: str):
    """Start the ranks (copies of this script) on a free local port, wait
    for them (at most ``RANK_DEADLINE_S``, then kill them) and return each
    rank's (stdout lines, results); a rank that fails fails the phase."""
    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs, procs = [], []
    for rank in range(MESH_RANKS):
        env = dict(os.environ, ALIGNER_COORDINATOR=f"127.0.0.1:{port}",
                   ALIGNER_NUM_PROCESSES=str(MESH_RANKS), ALIGNER_PROCESS_ID=str(rank),
                   PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        logs.append(os.path.join(tmp, f"rank{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank", in_path,
                 out_prefix], cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"the ranks did not finish within {RANK_DEADLINE_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as fh:
            text = fh.read()
        check(p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{text[-4000:]}")
        out.append((text.splitlines(), dict(np.load(f"{out_prefix}.{rank}.npz"))))
    return out


def tagged(lines, tag: str) -> dict:
    """The JSON of a rank's last stdout line that starts with ``tag``."""
    return json.loads([ln for ln in lines if ln.startswith(tag + " ")][-1][len(tag) + 1:])


def same_results(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None) == (y is None) and (x is None or (
            np.array_equal(x.alignment.query, y.alignment.query)
            and np.array_equal(x.alignment.target, y.alignment.target)
            and tuple(map(tuple, x.alignment.coords)) == tuple(map(tuple, y.alignment.coords))
            and x.alignment.f == y.alignment.f)) for x, y in zip(a, b))


def pipeline_on_the_card(at, sp, wf, align, pipe) -> dict:
    """The column-blocked pipeline on the card given twice: a (2, 1) mesh of
    it, ``sharded_global_align`` and ``sharded_global_end_score`` of phase
    12's 524,288 x 524,288 pair on the engine and block height the one-card
    route picked (4 column blocks, 2 a slot, the boundary copied to the
    second slot, which is the same card), bit-equal to phase 12's results
    with its launch counts; then ``align_global`` and ``global_end_score``
    of the 65,536 x 65,536 pair under :func:`card_twice`, which send that
    huge pair to the pipeline over the two (2 column blocks of 32,768, the
    engines ``auto_shard_config`` picks for 2 slots), bit-equal to phase
    10's alignment and phase 11's end score.  Returns the walls."""
    from aligner_tpu_torch.observability import counters
    from aligner_tpu_torch.parallel import mesh as pm
    from aligner_tpu_torch.result import Alignment

    L = wf.launches

    def launched():
        return (L.block_cs + L.band_sp, L.block_cs_dirs, L.replay_walk,
                L.row_scan + L.row_scan_dirs + L.band)

    a, m = pipe["A"], at.blosum62()
    m_np = np.asarray(m)
    q, t = a["q"], a["t"]
    mesh = pm.make_mesh(MESH_SHARDS, devices=[torch.device(DEVICE, 0)] * MESH_SHARDS)
    walls = {}
    for what, tb, fn in (("align", sp.TB_ROWS, sp.sharded_global_align),
                         ("end", None, sp.sharded_global_end_score)):
        one = sp._prep_sharded(None, q, t, m_np, DEL, EXT, None, tb, None, DEVICE)
        counters.reset()
        before = launched()
        res, walls[f"{what}, 524,288^2 on a (2, 1) mesh"] = timed(lambda: fn(
            mesh, q, t, m_np, DEL, EXT, engine=one["engine"], tr=one["tr"]))
        got = [b - a0 for a0, b in zip(before, launched())]
        hand = counters.snapshot()[f"{DEVICE}/wavefront-sp-handoff"]
        walls[f"{what}: hand-offs received"] = hand.cells
        walls[f"{what}: hand-off wait"] = hand.seconds
        if what == "align":
            end, qa, ta, coords = res
            check(end == a["score"] and same_alignment(
                Alignment(qa, ta, coords, 0.0, at.Protein), a["alignment"]),
                "the 524,288^2 alignment on two slots of the card != the one-card route's")
            check(tuple(got[:3]) == a["launches"]["align"] and got[3] == 0,
                  f"the 524,288^2 alignment on two slots launched {got}, the one-card "
                  f"route {a['launches']['align']}")
        else:
            check(res == a["score"],
                  f"the 524,288^2 end score on two slots {res} != {a['score']}")
            check(got[0] == a["launches"]["end"] and got[1:] == [0, 0, 0],
                  f"the 524,288^2 end score on two slots launched {got}, the one-card "
                  f"route {a['launches']['end']} blocks")

    q, t = pipe["q65"], pipe["t65"]
    with card_twice(align):
        before = launched()
        aln, walls["align_global 65,536^2, card twice"] = timed(
            lambda: at.align_global(q, t, m, DEL, EXT, device=DEVICE).alignment)
        score, walls["global_end_score 65,536^2, card twice"] = timed(
            lambda: at.global_end_score(q, t, m, DEL, EXT, device=DEVICE))
    got = [b - a0 for a0, b in zip(before, launched())]
    check(got[0] > 0 and got[1] > 0 and got[2] == got[1] and got[3] == 0,
          f"the huge 65,536^2 pair with the card twice did not take the pipeline: {got}")
    check(same_alignment(aln, pipe["aln65"]) and score == pipe["end65"],
          "the 65,536^2 pair on the pipeline != phase 10's alignment or phase 11's score")
    return walls


def phase_multi_device(at, repeat, x, sh, wins, opts, pq, tmp, launch_counts,
                       reset_counts, sp, wf, pipe):
    """Phase 15: the sharded path on the one card, two shards of it.  The
    auto-shard's fills (``align._fill_sharded`` through ``batch_align``,
    its shard list the card twice) on the p-value batch (K1, no argmax) and
    the full batch with alignments, local and global (K2 and K4 a shard),
    and one scan of the chromosome's windows (``_scan_scores``, K3 a shard
    a chunk), each equal bit for bit to the unsharded call and timed beside
    it in turns (unsharded, sharded | sharded, unsharded); the column-blocked
    pipeline on the card twice (:func:`pipeline_on_the_card`); then two
    ranks, copies of this script, on a (2, 2) mesh with the card twice each
    (gloo), whose gathered mesh steps equal the one-process ones and whose
    pipeline on the 524,288 x 524,288 pair equals phase 12's results.
    Returns the launch counts of the sharded runs and the ranks (the counts
    start at zero just before the first sharded run)."""
    from aligner_tpu_torch.result import Alignment
    from aligner_tpu_torch import align
    from aligner_tpu_torch.backend import dtype_for
    from aligner_tpu_torch.parallel import mesh as pm

    dev = torch.device(DEVICE)
    m = x["b62"]
    fq, ft = full_batch_pairs()
    fb = align.pad_batch(fq) + align.pad_batch(ft)
    fb_dtype = dtype_for(dev, m, DEL, EXT, lengths=(fb[2].shape[1], fb[0].shape[1]))
    walls = collections.defaultdict(list)
    scan = f"scan of {len(wins):,} windows"

    def run(sharded: bool) -> dict:
        ctx = card_twice(align) if sharded else contextlib.nullcontext()
        tag = "sharded" if sharded else "one shard"
        r = {}
        with ctx:
            for name, fn in (
                    ("p-value batch", lambda: at.batch_align(
                        [pq] * len(sh), sh, m, DEL, EXT, track_argmax=False,
                        device=DEVICE)),
                    ("full batch fill, local", lambda: align._fill(
                        *fb, m, DEL, EXT, "local", True, dev, fb_dtype)),
                    ("full batch fill, global", lambda: align._fill(
                        *fb, m, DEL, EXT, "global", True, dev, fb_dtype)),
                    ("full batch with alignments, local", lambda: at.batch_align(
                        fq, ft, m, DEL, EXT, mode="local", with_alignments=True,
                        device=DEVICE)),
                    ("full batch with alignments, global", lambda: at.batch_align(
                        fq, ft, m, DEL, EXT, mode="global", with_alignments=True,
                        device=DEVICE)),
                    (scan, lambda: repeat._scan_scores(
                        x["seq"], wins, x["pwm"], opts))):
                r[name], wall = timed(fn)
                walls[(name, tag)].append(wall)
        return r

    # the one-process references of the ranks' steps, then the unsharded runs
    ref_scores = align._fill(x["sh_q"], x["sh_ql"], x["sh_t"], x["sh_tl"], m, DEL, EXT,
                             "local", False, dev, dtype_for(
                                 dev, m, DEL, EXT, lengths=(x["sh_t"].shape[1],
                                                            x["sh_q"].shape[1])))
    ref_pop = pm.matrix_population_step(
        pm.make_mesh(1, devices=[dev]), x["pop_q"], x["pop_ql"], x["pop_t"], x["pop_tl"],
        x["mats"], DEL, DEL)
    one = run(False)
    reset_counts()
    two = run(True)
    piped = pipeline_on_the_card(at, sp, wf, align, pipe)
    in_path = os.path.join(tmp, "mesh_inputs.npz")
    np.savez(in_path, **x)
    ranks, rank_wall = timed(lambda: run_mesh_ranks(in_path, os.path.join(tmp, "mesh"),
                                                    tmp))
    counts = launch_counts()
    for lines, _ in ranks:
        for k, v in tagged(lines, "launches").items():
            counts[k] += v
    # the second pair of timed runs, in the other order
    run(True)
    run(False)

    pv1, pv2 = one["p-value batch"], two["p-value batch"]
    check(all(np.array_equal(getattr(pv1, f), getattr(pv2, f))
              for f in ("fmax", "fy", "fx", "end")), "p-value batch: two shards != one")
    for mode in ("local", "global"):
        a, b = one[f"full batch fill, {mode}"], two[f"full batch fill, {mode}"]
        check(isinstance(b.words, tuple) and len(b.words) == MESH_SHARDS
              and torch.equal(a.words, torch.cat(b.words))
              and all(torch.equal(getattr(a, f), getattr(b, f))
                      for f in ("fmax", "fy", "fx", "end")),
              f"full batch fill {mode}: two shards != one")
        check(same_results(one[f"full batch with alignments, {mode}"],
                           two[f"full batch with alignments, {mode}"]),
              f"full batch {mode}: the alignments of two shards != one")
    fs = one[scan]
    check(np.array_equal(fs, two[scan]), "scan: two shards != one")

    (lines0, r0), (lines1, r1) = ranks
    n = len(x["sh_ql"])
    per = -(-n // MESH_RANKS)
    for rank, r in enumerate((r0, r1)):
        check(r["layout"].tolist() == [rank * per, min((rank + 1) * per, n), per, per, n],
              f"rank {rank}'s layout of the {n} shuffles: {r['layout'].tolist()}")
    for f in ("fmax", "fy", "fx", "end"):
        want = getattr(ref_scores, f).cpu().numpy()
        check(np.array_equal(r0[f"scores_{f}"], want) and np.array_equal(
            r1[f"scores_{f}"], want), f"ranks' sharded_scores {f} != the one-process fill")
    check(np.array_equal(r0["scan_stats"], r1["scan_stats"])
          and np.array_equal(r0["scan_z"], r1["scan_z"])
          and np.array_equal(r0["scan_scores"], r1["scan_scores"]),
          "the ranks' window_scan_step differ")
    nw = x["n_wins"]
    check(np.array_equal(r0["scan_scores"][:nw], fs) and not r0["scan_scores"][nw:].any(),
          "ranks' window scores != the one-card scan")
    mean = fs.sum() / nw
    std = np.sqrt(max((fs * fs).sum() / nw - mean * mean, 0.0))
    z = (fs - mean) / max(std, np.finfo(np.float64).tiny)
    check(np.allclose(r0["scan_stats"], [mean, std], rtol=MESH_STATS_TOL, atol=0)
          and np.allclose(r0["scan_z"][:nw], z, rtol=MESH_STATS_TOL, atol=MESH_STATS_TOL),
          f"ranks' mean, std {r0['scan_stats'].tolist()} (or z) != the scan's "
          f"{[mean, std]} to {MESH_STATS_TOL}")
    for key, want in (("pop_best", ref_pop[0]), ("pop_win", ref_pop[1])):
        check(np.array_equal(r0[key], want.cpu().numpy())
              and np.array_equal(r1[key], r0[key]),
              f"ranks' matrix_population_step ({key}) != the one-process step")
    a = pipe["A"]
    for rank, r in enumerate((r0, r1)):
        check(r["pipe_end"].tolist() == [a["score"]] * 2 and same_alignment(
            Alignment(r["pipe_qa"], r["pipe_ta"], r["pipe_coords"], 0.0, at.Protein),
            a["alignment"]), f"rank {rank}'s column-blocked pipeline on the 524,288^2 "
                             f"pair != the one-card route's")

    for (name, tag), ws in walls.items():
        print(f"  {name}, {tag}: " + ", ".join(f"{w:.4f}" for w in ws) + " s", flush=True)
    print("  the column-blocked pipeline on the card twice (s; hand-offs received): "
          + json.dumps(piped), flush=True)
    for rank, (lines, _) in enumerate(ranks):
        print(f"  rank {rank} walls (s): {json.dumps(tagged(lines, 'walls'))}", flush=True)
        print(f"  rank {rank} launches: {json.dumps(tagged(lines, 'launches'))}", flush=True)
    print(f"  the ranks from start to exit: {rank_wall:.3f} s; the scan's mean "
          f"{float(mean)!r}, std {float(std)!r}, the ranks' "
          f"{r0['scan_stats'].tolist()}; population: best f "
          f"{r0['pop_best'].tolist()}, matrices {r0['pop_win'].tolist()}", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(*sys.argv[2:4])
    import aligner_tpu_torch as at
    from aligner_tpu_torch import host, native
    from aligner_tpu_torch.repeat import engine as repeat
    from aligner_tpu_torch.cli import align as cli_align
    from aligner_tpu_torch.cli import repeat_search as cli_repeat
    from aligner_tpu_torch.cli import search as cli_search
    from aligner_tpu_torch.io import read_fasta_file
    from aligner_tpu_torch.ops import _build, device_walk, dp_fill, freq_count, scan_engine
    from aligner_tpu_torch.ops import wavefront as wf
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    dev = torch.device(DEVICE)
    print(card_line(), flush=True)  # "<name>, <power limit>" as nvidia-smi gives it
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    check(native.available(), "native C++ runtime did not build")

    with phase("build"):
        _build.load()
        print(f"  nvcc build of csrc/*.cu: {_build.build_seconds:.3f} s", flush=True)

    pop = population_inputs(at, read_fasta_file)
    with phase("kernel vs plain"):
        n = phase_kernels_vs_plain(dev, at, dp_fill, device_walk, scan_engine)
        n += counts_vs_plain(dev, at, dp_fill, device_walk, freq_count, pop)
        n += wavefront_vs_plain(dev, at, wf)
        n += band_vs_plain(dev, at, host, wf, sp)
        n += block_cs_vs_plain(dev, at, wf, sp)
        n += walks_that_refill(dev, wf, device_walk)
        print(f"  {n} variants bit-identical", flush=True)

    here = os.path.dirname(os.path.abspath(__file__))
    recs = read_fasta_file(os.path.join(here, "examples", "protein.fasta"))
    pq = at.Protein.encode(recs[0].seq, strict=True)
    pt = at.Protein.encode(recs[1].seq, strict=True)
    raw, planted = make_chromosome(CHROM_BP, CHROM_SEED, N_PLANTED)
    with phase("kernel timing"):
        rows = phase_timing(dev, at, dp_fill, device_walk, scan_engine, pq, pt)
        seq = at.DNA.encode(raw)
        rows += phase_pwm_timing(dev, at, dp_fill, device_walk, scan_engine, repeat,
                                 seq)
        wf_rows, plain = phase_wavefront_timing(dev, at, wf)
        rows += wf_rows
        band_rows, plain_end = phase_band_timing(dev, at, wf, plain["q"], plain["t"])
        rows += band_rows
        block_rows, k7_points = phase_block_timing(dev, at, wf, sp)
        rows += block_rows
        rows += population_count_rows(dev, at, dp_fill, device_walk, freq_count, pop)
        print_rows(rows[-2:])

    def launch_counts():
        return dict(scores=dp_fill.launches.scores, dirs=dp_fill.launches.dirs,
                    planes=dp_fill.launches.planes,
                    pwm_scores=dp_fill.launches.pwm_scores,
                    pwm_dirs=dp_fill.launches.pwm_dirs, spilled=dp_fill.launches.spilled,
                    walk=device_walk.launches.walk,
                    walk_count=device_walk.launches.walk_count,
                    freq_count=freq_count.launches.freq_count,
                    row_scan=wf.launches.row_scan,
                    row_scan_dirs=wf.launches.row_scan_dirs,
                    replay_walk=wf.launches.replay_walk,
                    tile_launches=wf.launches.tile_launches, band=wf.launches.band,
                    band_sp=wf.launches.band_sp,
                    band_tile_launches=wf.launches.band_tile_launches,
                    block_cs=wf.launches.block_cs,
                    block_cs_dirs=wf.launches.block_cs_dirs,
                    block_cs_tile_launches=wf.launches.block_cs_tile_launches)

    def reset_counts():
        dp_fill.launches.reset()
        device_walk.launches.reset()
        freq_count.launches.reset()
        wf.launches.reset()

    # each path's own run: its counts start at zero just before it and are
    # read just after it
    counts = {}
    reset_counts()
    with phase("golden fixtures"):
        print(f"  {phase_golden(at, read_fasta_file)} of 12 equal", flush=True)
    with phase("p-value"):
        phase_p_value(at, native, pq, pt)
    with tempfile.TemporaryDirectory() as tmp:
        with phase("search"):
            argvs = phase_search(at, native, host, cli_search, pq, tmp)
        with phase("search under torch.profiler"):
            phase_trace(cli_search, argvs["local"], tmp)
    with phase("full-mode batch"):
        phase_full_batch(at, native, host)
    counts["pair"] = launch_counts()
    reset_counts()
    with phase("heuristic population"):
        pop_iters = phase_population(at, host, pop)
    counts["population"] = launch_counts()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with phase("service"):
            worker_counts, calc_counts, service_iters = phase_service(
                at, native, host, read_fasta_file, tmp, launch_counts)
    # the worker's launches happen in its own process, calc's in this one
    counts["service"] = {k: v + worker_counts.get(k, 0) for k, v in calc_counts.items()}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with phase("repeat search"):
            phase_repeat_search(at, native, host, cli_repeat, repeat, raw, planted, tmp)
    counts["pwm"] = launch_counts()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with phase("huge global pair"):
            wide = phase_huge_pair(at, native, host, wf, cli_align, plain, tmp)
    counts["huge"] = launch_counts()
    reset_counts()
    with phase("huge-pair end score"):
        end_65k = phase_end_score(dev, at, native, host, wf, plain["q"], plain["t"],
                                  plain_end, pq, pt)
    counts["end_score"] = launch_counts()
    reset_counts()
    with phase("column-blocked pair"):
        blocked = phase_column_blocked(at, wf, sp, plain, wide)
    counts["column_blocked"] = launch_counts()
    with phase("column-blocked pair against the other routes"):
        hold_column_blocked(dev, at, host, wf, sp, plain, wide, blocked)
    with phase("simple aligners and host walks"):
        n = plane_vs_plain(dev, at, dp_fill, scan_engine)
        print(f"  {n} score-plane variants bit-identical", flush=True)
        rows += plane_rows(dev, at, dp_fill, scan_engine, pq, pt)
        reset_counts()
        phase_simple(at, native, read_fasta_file)
        counts["simple"] = launch_counts()
        counts["host_walk"] = phase_host_walks(at, sp, plain, wide, blocked,
                                               launch_counts, reset_counts)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        with phase("column-blocked engines"):
            runs = phase_engines(at, wf, sp, cli_align, blocked, tmp)
        counts["engines"] = launch_counts()
        with phase("column-blocked engines against the plain versions and each other"):
            rows += hold_engines(dev, at, wf, sp, cli_align, blocked, runs,
                                 counts["engines"], k7_points)
    with tempfile.TemporaryDirectory() as tmp:
        with phase("multi-device (one card)"):
            mesh_x = mesh_inputs(at, repeat, pq, pt, raw, service_fasta(at, read_fasta_file))
            pipe = dict(A=blocked["A"], q65=plain["q"], t65=plain["t"],
                        aln65=wide["pair_b"], end65=end_65k)
            counts["sharded"] = phase_multi_device(at, repeat, *mesh_x, pq, tmp,
                                                   launch_counts, reset_counts, sp, wf,
                                                   pipe)
    with phase("launch counts"):
        for path, phases, keys in (
                ("pair", "phases 3-6", ("scores", "dirs", "spilled", "walk")),
                ("population", "phase 7", ("dirs", "walk", "walk_count")),
                ("service", "phase 8", ("scores", "dirs", "walk", "walk_count")),
                ("pwm", "phase 9", ("pwm_scores", "pwm_dirs", "walk")),
                ("huge", "phase 10", ("row_scan", "row_scan_dirs", "replay_walk")),
                ("end_score", "phase 11", ("band",)),
                ("column_blocked", "phase 12", ("block_cs_dirs", "replay_walk")),
                ("simple", "phase 13", ("planes",)),
                ("host_walk", "phase 13",
                 ("dirs", "pwm_dirs", "row_scan_dirs", "block_cs_dirs")),
                ("engines", "phase 14",
                 ("band_sp", "block_cs", "block_cs_dirs", "replay_walk")),
                ("sharded", "phase 15", ("scores", "dirs", "pwm_scores", "walk",
                                         "block_cs_dirs", "replay_walk"))):
            print(f"  {path} path ({phases}): {counts[path]}", flush=True)
            for k in keys:
                check(counts[path][k] > 0,
                      f"{k} kernel was never launched on the {path} path")
            c = counts[path]
            # the strip walk and the band walk: one kernel launch a call
            check(c["tile_launches"] == c["row_scan"] + c["row_scan_dirs"]
                  and c["block_cs_tile_launches"] == c["block_cs"] + c["block_cs_dirs"]
                  and c["band_tile_launches"] == c["band"] + c["band_sp"],
                  f"the {path} path's row-scan, column-block or band calls made other "
                  f"than one launch each")
        # the column-blocked path's forward blocks ran on K7 or K6, as the
        # pick chose, and no single-plane kernel ran on it
        for path in ("column_blocked", "sharded"):
            c = counts[path]
            check(c["block_cs"] + c["band_sp"] > 0 and c["band"] == c["row_scan"] == 0,
                  f"the {path} path's forward blocks: {c}")
        for path in ("simple", "host_walk"):
            check(counts[path]["walk"] == 0 and counts[path]["replay_walk"] == 0,
                  f"the {path} path launched a walk kernel: the walks are the host's")
        # the population counts by the counting walk, once an iteration; the
        # standalone count is off its path
        for path, iters in (("population", pop_iters), ("service", service_iters)):
            c = counts[path]
            check(c["walk_count"] == iters and c["freq_count"] == 0,
                  f"the {path} path ran {iters} population iterations but launched the "
                  f"counting walk {c['walk_count']} times and the standalone count "
                  f"{c['freq_count']} times")

    kernels = []
    for r in rows:
        paths = r["path"] if isinstance(r["path"], tuple) else (r["path"],)
        names = r["counter"] if isinstance(r["counter"], tuple) else (r["counter"],)
        kernels.append(dict(name=r["name"], route=r["route"], source=r["source"],
                            replaces=r["replaces"],
                            launches=sum(counts[p][k] for p in paths for k in names),
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            # no single PyTorch call computes these recurrences,
                            # nor the count of pairs along step streams
                            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
