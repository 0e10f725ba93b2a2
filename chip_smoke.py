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
   batches (local/global, argmax on/off, directions on/off, f32/f64), the
   walk on words from the kernel fill, and each kernel's time beside its
   plain version's at the shapes the main path gives it;
3. golden fixtures: ``batch_align`` on the three example FASTAs;
4. ``calculate_p_value`` with 5,000 sequences on ``examples/protein.fasta``;
5. ``aligner-search`` on a seeded 100,000-sequence protein database (local)
   and its first 5,000 records (global); then the local search once more
   under ``torch.profiler`` for the device's busy time and idle share;
6. a full-mode batch of 4,096 pairs of 400 residues, local and global;
7. the kernels' launch counts over phases 3-6.

Every phase prints one line with its result and wall time; a failing
check raises and the script exits nonzero.  The line before the last is
a JSON object with one entry per kernel; the last line is the JSON
device record.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
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
    ms = gpu_ms(lambda: dp_fill.fill(*args, m, DEL, EXT, **kw), 5)
    got = dp_fill.fill(*args, m, DEL, EXT, **kw)
    t0 = time.perf_counter()
    want = scan_engine.fill_batch(*args, m, DEL, EXT, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_fill(got, want), "dp_fill != plain at the p-value shape")
    rows.append(dict(name="dp_fill (scores only, p-value launch)", route="cuda",
                     source="aligner_tpu_torch/csrc/dp_fill.cu",
                     replaces=REPLACES["dp_fill"], counter="scores",
                     max_abs_err=max_abs_err(got.fmax, want.fmax), ms=ms,
                     plain_ms=plain_ms,
                     shape=f"{len(sh)}x{tt.shape[1]}x{qq.shape[1]}"))

    fq, ft = full_batch_pairs()
    qq, qql = pad_batch(fq)
    tt, ttl = pad_batch(ft)
    args = tensors(dev, qq, qql, tt, ttl)
    kw = dict(mode="local", with_dirs=True)
    ms = gpu_ms(lambda: dp_fill.fill(*args, m, DEL, EXT, **kw), 3)
    got = dp_fill.fill(*args, m, DEL, EXT, **kw)
    t0 = time.perf_counter()
    want = scan_engine.fill_batch(*args, m, DEL, EXT, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_fill(got, want), "dp_fill != plain at the full-mode shape")
    rows.append(dict(name="dp_fill (directions, full-mode batch)", route="cuda",
                     source="aligner_tpu_torch/csrc/dp_fill.cu",
                     replaces=REPLACES["dp_fill"], counter="dirs",
                     max_abs_err=max(max_abs_err(got.fmax, want.fmax),
                                     max_abs_err(got.words, want.words)),
                     ms=ms, plain_ms=plain_ms,
                     shape=f"{N_FULL}x{tt.shape[1]}x{qq.shape[1]}"))

    S = tt.shape[1] + qq.shape[1] + 1
    ms = gpu_ms(lambda: device_walk.walk(got.words, got.fy, got.fx, S=S,
                                         mode="local"), 5)
    wk = device_walk.walk(got.words, got.fy, got.fx, S=S, mode="local")
    t0 = time.perf_counter()
    wp = device_walk.walk_plain(got.words, got.fy, got.fx, S=S, mode="local")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(wk, wp)),
          "device_walk != plain at the full-mode shape")
    rows.append(dict(name="device_walk (full-mode batch)", route="cuda",
                     source="aligner_tpu_torch/csrc/device_walk.cu",
                     replaces=REPLACES["device_walk"], counter="walk",
                     max_abs_err=max(max_abs_err(a, b) for a, b in zip(wk, wp)),
                     ms=ms, plain_ms=plain_ms, shape=f"{N_FULL}x{S} steps"))
    for r in rows:
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.1f} ms, max_abs_err {r['max_abs_err']}",
              flush=True)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import aligner_tpu_torch as at
    from aligner_tpu_torch import host, native
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
    with phase("kernel timing"):
        rows = phase_timing(dev, at, dp_fill, device_walk, scan_engine, pq, pt)

    # the main path's own run: counts start at zero here
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
    counts = dict(scores=dp_fill.launches.scores, dirs=dp_fill.launches.dirs,
                  walk=device_walk.launches.walk)
    with phase("launch counts"):
        print(f"  {counts}", flush=True)
        for k, v in counts.items():
            check(v > 0, f"{k} kernel was never launched on the main path")

    kernels = []
    for r in rows:
        kernels.append(dict(name=r["name"], route=r["route"], source=r["source"],
                            replaces=r["replaces"], launches=counts[r["counter"]],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
