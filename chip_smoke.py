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
   words from the kernel fill, and each kernel's time beside its plain
   version's at the shapes the main path gives it, with the repeat
   scan's chunk size timed at 8,192 and 65,536 windows;
3. golden fixtures: ``batch_align`` on the three example FASTAs;
4. ``calculate_p_value`` with 5,000 sequences on ``examples/protein.fasta``;
5. ``aligner-search`` on a seeded 100,000-sequence protein database (local)
   and its first 5,000 records (global); then the local search once more
   under ``torch.profiler`` for the device's busy time and idle share;
6. a full-mode batch of 4,096 pairs of 400 residues, local and global;
7. ``aligner-repeat-search`` in exploring mode with a checkpoint on a
   seeded 10 Mb chromosome with 40 planted copies of one 330-base query,
   at the reference defaults (W = 300, window 330, offset 30, 10 cycles);
   then one more cycle from the completed checkpoint's state, held
   against native C++ (scores, z, sampled windows) and the host engine
   (survivor alignments);
8. the kernels' launch counts of each path: the pair path (phases 3-6)
   and the PWM path (phase 7), each counted from zero.

Every phase prints one line with its result and wall time; a failing
check raises and the script exits nonzero.  The line before the last is
a JSON object with one entry per kernel; the last line is the JSON
device record.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

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
REPLACES = {
    "dp_fill": "aligner_tpu/ops/pallas_dp.py:88",
    "device_walk": "aligner_tpu/ops/device_walk.py:34",
}


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
              f"plain {r['plain_ms']:.1f} ms, max_abs_err {r['max_abs_err']}",
              flush=True)


def phase_timing(dev, at, dp_fill, device_walk, scan_engine, q, t):
    """Each kernel's time beside its plain version's at the main path's
    shapes: the p-value launch (4,999 x ~400^2, scores only, no argmax)
    and the full-mode batch (4,096 x 400^2, directions, then the walk)."""
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
                     replaces=REPLACES["dp_fill"], path="pair", counter="scores",
                     max_abs_err=max_abs_err(got.fmax, want.fmax), ms=ms,
                     plain_ms=plain_ms,
                     shape=f"{len(sh)}x{tt.shape[1]}x{qq.shape[1]}"))

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
                     replaces=REPLACES["dp_fill"], path="pair", counter="dirs",
                     max_abs_err=max(max_abs_err(got.fmax, want.fmax),
                                     max_abs_err(got.words, want.words)),
                     ms=ms, plain_ms=plain_ms,
                     shape=f"{N_FULL}x{tt.shape[1]}x{qq.shape[1]}"))

    S = tt.shape[1] + qq.shape[1] + 1
    wk, ms, wp, plain_ms = timed_pair(
        lambda: device_walk.walk(got.words, got.fy, got.fx, S=S, mode="local"),
        lambda: device_walk.walk_plain(got.words, got.fy, got.fx, S=S, mode="local"), 5)
    check(all(torch.equal(a, b) for a, b in zip(wk, wp)),
          "device_walk != plain at the full-mode shape")
    rows.append(dict(name="device_walk (full-mode batch)", route="cuda",
                     source="aligner_tpu_torch/csrc/device_walk.cu",
                     replaces=REPLACES["device_walk"], path="pair", counter="walk",
                     max_abs_err=max(max_abs_err(a, b) for a, b in zip(wk, wp)),
                     ms=ms, plain_ms=plain_ms, shape=f"{N_FULL}x{S} steps"))
    print_rows(rows)
    return rows


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
                     replaces=REPLACES["dp_fill"], path="pwm", counter="pwm_scores",
                     max_abs_err=max_abs_err(got.fmax, want.fmax), ms=ms,
                     plain_ms=plain_ms, shape=f"{B}x{R8}x{PWM_W} f64"))
    pwm32 = pwm64.float()
    ms32 = gpu_ms(lambda: dp_fill.fill_pwm(qb, qlb, pwm32, PWM_DEL, PWM_EXT, **kw), 3)
    gcups = lambda ms, n: n * win * PWM_W / ms / 1e6  # noqa: E731
    lines.append(f"scan shape {B}x{R8}x{PWM_W}: f64 {ms:.3f} ms "
                 f"({gcups(ms, B):.1f} GCUPS), f32 {ms32:.3f} ms "
                 f"({gcups(ms32, B):.1f} GCUPS), plain f64 {plain_ms:.1f} ms")

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
                     shape=f"{N_SURVIVORS}x{R8}x{PWM_W} f64"))
    S = win + PWM_W + 1
    wk, ms, wp, plain_ms = timed_pair(
        lambda: device_walk.walk(got.words, got.fy, got.fx, S=S, mode="local"),
        lambda: device_walk.walk_plain(got.words, got.fy, got.fx, S=S, mode="local"), 5)
    check(all(torch.equal(a, b) for a, b in zip(wk, wp)),
          "device_walk != plain at the survivor shape")
    rows.append(dict(name="device_walk (PWM survivors)", route="cuda",
                     source="aligner_tpu_torch/csrc/device_walk.cu",
                     replaces=REPLACES["device_walk"], path="pwm", counter="walk",
                     max_abs_err=max(max_abs_err(a, b) for a, b in zip(wk, wp)),
                     ms=ms, plain_ms=plain_ms, shape=f"{N_SURVIVORS}x{S} steps"))
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


def phase_p_value(at, native, q, t):
    m = at.blosum62()
    initial, _, _ = native.local_max_score_stream(q, t, m, DEL, EXT)
    t0 = time.perf_counter()
    p = at.calculate_p_value(q, t, initial, DEL, EXT, m, n_sequences=N_PVALUE,
                             rng=np.random.default_rng(SEED), device=DEVICE)
    wall = time.perf_counter() - t0
    sh = shuffles_for_p_value(at, q, t, N_PVALUE)
    got = at.batch_align([q] * len(sh), sh, m, DEL, EXT, track_argmax=False,
                         device=DEVICE).fmax.astype(np.float64)
    want = np.array([native.local_max_score_stream(q, s, m, DEL, EXT)[0] for s in sh])
    check(np.array_equal(got, want), "p-value shuffle scores != native C++")
    scores = np.concatenate([[initial], want])
    lengths = np.concatenate([[len(t)], [len(s) for s in sh]])
    p_native = at.statistics.calculate_distribution_params(
        len(q), lengths, scores).get_p_value(len(q), len(t), initial)
    # bit-equal, NaN included: with h -> NaN the reference's fit returns NaN
    check(np.float64(p).tobytes() == np.float64(p_native).tobytes(),
          f"p-value {p!r} != native-score p-value {p_native!r}")
    print(f"  {len(sh)} shuffles, initial score {initial}, p = {p!r} "
          f"(calculate_p_value wall {wall:.3f} s)", flush=True)


def write_db(path, seqs, names):
    with open(path, "wb") as fh:
        for name, s in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n" + s + b"\n")


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
    from aligner_tpu_torch.observability import counters

    rng = np.random.default_rng(SEED + 1)
    db = make_database(rng)
    names = [f"db{i}" for i in range(len(db))]
    m = at.blosum62()
    here = os.path.dirname(os.path.abspath(__file__))
    qfile = os.path.join(here, "examples", "protein.fasta")
    codes = [at.Protein.encode(s, strict=True) for s in db]
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
              f"{hits[0]['score']}", flush=True)
        argvs[mode] = argv
    return argvs


def phase_trace(cli_search, argv, tmp):
    """The local search once more under ``torch.profiler``: device time by
    kernel and the device's idle share of the CLI's wall time."""
    from aligner_tpu_torch.observability import profile_trace

    with profile_trace(os.path.join(tmp, "search_trace.json")) as prof:
        hits, wall = run_cli(cli_search.main, argv)
        torch.cuda.synchronize()
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
    log.setLevel(logging.INFO)
    counters.reset()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_repeat.main(argv)
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(scan_log)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import aligner_tpu_torch as at
    from aligner_tpu_torch import host, native
    from aligner_tpu_torch.repeat import engine as repeat
    from aligner_tpu_torch.cli import repeat_search as cli_repeat
    from aligner_tpu_torch.cli import search as cli_search
    from aligner_tpu_torch.io import read_fasta_file
    from aligner_tpu_torch.ops import _build, device_walk, dp_fill, scan_engine

    dev = torch.device(DEVICE)
    print(card_line(), flush=True)  # "<name>, <power limit>" as nvidia-smi gives it
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    check(native.available(), "native C++ runtime did not build")

    with phase("build"):
        _build.load()
        print(f"  nvcc build of csrc/*.cu: {_build.build_seconds:.3f} s", flush=True)

    with phase("kernel vs plain"):
        n = phase_kernels_vs_plain(dev, at, dp_fill, device_walk, scan_engine)
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

    def launch_counts():
        return dict(scores=dp_fill.launches.scores, dirs=dp_fill.launches.dirs,
                    pwm_scores=dp_fill.launches.pwm_scores,
                    pwm_dirs=dp_fill.launches.pwm_dirs, walk=device_walk.launches.walk)

    # each path's own run: its counts start at zero just before it and are
    # read just after it
    counts = {}
    dp_fill.launches.reset()
    device_walk.launches.reset()
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
    dp_fill.launches.reset()
    device_walk.launches.reset()
    with tempfile.TemporaryDirectory() as tmp:
        with phase("repeat search"):
            phase_repeat_search(at, native, host, cli_repeat, repeat, raw, planted, tmp)
    counts["pwm"] = launch_counts()
    with phase("launch counts"):
        for path, keys in (("pair", ("scores", "dirs", "walk")),
                           ("pwm", ("pwm_scores", "pwm_dirs", "walk"))):
            print(f"  {path} path ({'phases 3-6' if path == 'pair' else 'phase 7'}): "
                  f"{counts[path]}", flush=True)
            for k in keys:
                check(counts[path][k] > 0,
                      f"{k} kernel was never launched on the {path} path")

    kernels = []
    for r in rows:
        kernels.append(dict(name=r["name"], route=r["route"], source=r["source"],
                            replaces=r["replaces"],
                            launches=counts[r["path"]][r["counter"]],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
