"""The port's latent-repeat search against the JAX package: every case of
``tests/test_repeat.py`` that touches the repeat engine or the
``aligner-repeat-search`` CLI, run through the port on the CPU (the fill
kernel's plain version) and compared whole with the JAX package run with
``backend="xla"``: task coords, z and f, and the final matrices, bit for
bit.  Also: a checkpoint written by the JAX engine resumes in the port, a
killed scan resumes to the uninterrupted result, and the CLI's
writability pre-flight leaves no files behind.

Sizes follow ``tests/test_repeat.py`` (repeat_length 24-32).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aligner_tpu.repeat.engine as R
import aligner_tpu_torch.repeat.engine as P
from aligner_tpu.cli import repeat_search as ref_cli
from aligner_tpu_torch.cli import repeat_search as port_cli

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the JAX batch path would otherwise shard over conftest's 8 devices
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def test_pwm_modules_import_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['aligner_tpu'] = None\n"
        "import aligner_tpu_torch.cli.repeat_search, aligner_tpu_torch.repeat\n"
        "import aligner_tpu_torch.heuristic, aligner_tpu_torch.service.models\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _opts(**kw):
    """The same options for both packages: (port, reference)."""
    return P.SearchOptions(device="cpu", **kw), R.SearchOptions(backend="xla", **kw)


def _rows(tasks):
    return [(t.left_coord, t.right_coord, t.z, t.f) for t in tasks]


def _same_results(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in b:
        assert _rows(a[key].tasks) == _rows(b[key].tasks), key
        assert np.array_equal(a[key].matrix, b[key].matrix), key


def _dna(rng, n):
    return "".join("ATCG"[c] for c in rng.integers(0, 4, n))


def _task(mod, z, left, right, f=0.0):
    return mod.Task(alignment=None, left_coord=left, right_coord=right, z=z, f=f)


def test_filter_reference_golden():
    """Port of the reference's filter_test (engine/test.rs:5-64)."""
    spec = [(12.240966, 300, 630), (12.378159, 360, 690), (11.762683, 1080, 1410),
            (10.471823, 1740, 2070), (11.392030, 1860, 2190)]
    out = P.filter_tasks([_task(P, *s) for s in spec])
    assert [(t.z, t.left_coord, t.right_coord) for t in out] == [
        (12.378159, 360, 690),
        (11.762683, 1080, 1410),
        (11.392030, 1860, 2190),
    ]
    assert _rows(out) == _rows(R.filter_tasks([_task(R, *s) for s in spec]))


def test_filter_edge_cases():
    assert P.filter_tasks([]) == []
    one = [_task(P, 1.0, 0, 10)]
    assert P.filter_tasks(one) == one
    spec = [(1.0, 0, 100), (5.0, 10, 110), (2.0, 20, 120)]
    out = P.filter_tasks([_task(P, *s) for s in spec])
    assert 5.0 in sorted(t.z for t in out)
    assert _rows(out) == _rows(R.filter_tasks([_task(R, *s) for s in spec]))


def test_filter_tasks_tie_break_last_max():
    """Equal-z overlapping tasks: Rust Iterator::max_by keeps the *last*
    maximum (engine/mod.rs:93-99)."""
    for spec, want in (
        ([(0, 100, 5.0), (10, 110, 5.0), (20, 120, 5.0)], [20]),
        ([(0, 10, 1.0), (50, 150, 2.0), (60, 160, 2.0)], [0, 60]),
    ):
        out = P.filter_tasks([_task(P, z, lo, hi, z) for lo, hi, z in spec])
        assert [t.left_coord for t in out] == want
        assert _rows(out) == _rows(
            R.filter_tasks([_task(R, z, lo, hi, z) for lo, hi, z in spec]))


@pytest.mark.parametrize("seed", range(4))
def test_filter_tasks_matches_reference_on_random_tasks(seed):
    """Many overlapping windows, equal z's and repeated left coords: the
    same survivors as the JAX package's slice-by-slice filter."""
    rng = np.random.default_rng(seed)
    n = 400
    left = np.sort(rng.integers(0, 3000, n))
    width = rng.integers(5, 120, n)
    z = rng.integers(0, 6, n).astype(float)
    spec = [(float(z[i]), int(left[i]), int(left[i] + width[i])) for i in range(n)]
    order = rng.permutation(n)
    got = P.filter_tasks([_task(P, *spec[i]) for i in order])
    want = R.filter_tasks([_task(R, *spec[i]) for i in order])
    assert _rows(got) == _rows(want) and len(got) > 1


def test_windows_enumeration():
    opts = P.SearchOptions(repeat_length=30, query_offset=10, threads=1)
    wins = P.windows_of(100, opts, 10)
    assert wins[0] == (0, 40)
    assert wins[1] == (10, 50)
    assert all(b == 100 for (j, b) in wins if j + 40 >= 100)
    opts3 = P.SearchOptions(repeat_length=30, query_offset=10, threads=3)
    wins3 = P.windows_of(100, opts3, 10)
    assert sorted(wins3) == sorted(wins)
    for o, step in ((opts, 10), (opts3, 10), (opts3, 7)):
        ro = R.SearchOptions(repeat_length=30, query_offset=10, threads=o.threads)
        assert P.windows_of(100, o, step) == R.windows_of(100, ro, step)


def test_mutate_and_descendants():
    seq = np.zeros(20, dtype=np.int8)
    m = P.mutate(seq, 4, 1, np.random.default_rng(0))
    assert set(np.flatnonzero(m != 0)).issubset({1, 5, 9, 13, 17})
    assert np.array_equal(m, R.mutate(seq, 4, 1, np.random.default_rng(0)))
    ds = P.generate_descendants(seq, 10, 4, np.random.default_rng(1))
    assert len(ds) == 10 and all(len(d) == 20 for d in ds)
    for a, b in zip(ds, R.generate_descendants(seq, 10, 4, np.random.default_rng(1))):
        assert np.array_equal(a, b)


def test_testing_mode_finds_planted_repeats():
    kw = dict(repeat_length=24, query_offset=8, deletions=5.0, extension=2.0,
              rsquared=100.0, kd=0.0)
    po, ro = _opts(**kw)
    a = P.run_testing_cmd(po, np.random.default_rng(0), sequence_length=3000,
                          descendants_amount=6)
    b = R.run_testing_cmd(ro, np.random.default_rng(0), sequence_length=3000,
                          descendants_amount=6)
    assert a["test"].matrix.shape == (4, 24)
    assert len(a["test"].tasks) >= 1
    _same_results(a, b)


def _chromosome(rng):
    motif = rng.integers(0, 4, 40)
    chrom = []
    for _ in range(6):
        chrom.append(rng.integers(0, 4, 120))
        chrom.append(motif)
    raw = "".join("ATCG"[c] for arr in chrom for c in arr)
    return (raw[:200] + "NNNNN" + raw[200:]).encode()  # invalid run → Index records


def test_perform_calculation_per_sequence(rng):
    raw = _chromosome(rng)
    po, ro = _opts(repeat_length=32, query_offset=12, deletions=6.0, extension=2.0,
                   repeats=2, reverse=True)
    a = P.perform_calculation_per_sequence(po, raw, "chr", np.random.default_rng(1))
    b = R.perform_calculation_per_sequence(ro, raw, "chr", np.random.default_rng(1))
    assert "direct" in a and "inverse" in a
    for t in a["direct"].tasks:
        assert 0 <= t.left_coord < t.right_coord <= len(raw)
    _same_results(a, b)
    # the survivors' alignments, not only their scores
    for key in b:
        for x, y in zip(a[key].tasks, b[key].tasks):
            assert np.array_equal(x.alignment.numbered, y.alignment.numbered)
            assert np.array_equal(x.alignment.query, y.alignment.query)
            assert x.alignment.coords == y.alignment.coords
            assert x.alignment.f == y.alignment.f


def test_scan_scores_match_reference_and_ignore_the_chunk(rng, monkeypatch):
    """The on-device window gather gives the JAX package's scores, host
    path and device gather alike, including the clipped windows at the
    sequence end, whatever the chunk."""
    seq = rng.integers(0, 4, 3000).astype(np.int8)
    po, ro = _opts(repeat_length=40, query_offset=10, deletions=5.0, extension=2.0)
    wins = P.windows_of(len(seq), po, po.query_offset)
    pwm = rng.normal(0.0, 2.0, (4, 40))
    got = P._scan_scores(seq, wins, pwm, po)
    for chunk in (100, 257):  # 297 windows: ragged last chunks
        assert np.array_equal(P._scan_scores(seq, wins, pwm, po, chunk=chunk), got)
    for gather in ("0", "1"):
        monkeypatch.setenv("ALIGNER_SCAN_DEVICE_GATHER", gather)
        assert np.array_equal(R._scan_scores(seq, wins, pwm, ro), got)
    assert P._scan_scores(seq, [], pwm, po).shape == (0,)


def _cli_fasta(tmp_path, rng):
    motif = _dna(rng, 30)
    seq = "".join(_dna(rng, 80) + motif for _ in range(5))
    fasta = tmp_path / "in.fasta"
    fasta.write_text(">chrT\n" + seq + "\n")
    return fasta


def _run_both_clis(tmp_path, args):
    outs = []
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                             ("ref", ref_cli, ["--backend", "xla"])):
        out = tmp_path / name / "res.csv"
        out.parent.mkdir()
        assert cli.main([*args, "-o", str(out), *extra]) == 0
        outs.append((out.read_text(),
                     (tmp_path / name / "res.csv.matrices.json").read_text()))
    return outs


def test_cli_exploring(tmp_path, rng):
    fasta = _cli_fasta(tmp_path, rng)
    (csv_p, mats_p), (csv_r, mats_r) = _run_both_clis(tmp_path, [
        "-i", str(fasta), "-r", "24", "-q", "8", "-d", "6", "-e", "2",
        "--repeats", "2", "--seed", "0"])
    for v in json.loads(mats_p).values():
        assert v["v"] == 1 and v["dim"] == [4, 24] and len(v["data"]) == 4 * 24
    assert csv_p == csv_r and mats_p == mats_r


def test_cli_csv_mode(tmp_path, rng):
    fasta = _cli_fasta(tmp_path, rng)
    known = tmp_path / "known.csv"
    known.write_text("name,z_value,left_coord,right_coord\nchrT,3.0,10,40\n")
    (csv_p, mats_p), (csv_r, mats_r) = _run_both_clis(tmp_path, [
        "-i", str(fasta), "--csv", str(known), "-r", "24", "-q", "8", "-d", "6",
        "-e", "2", "--repeats", "2", "--seed", "3", "--reverse"])
    assert set(json.loads(mats_p)) == {"chrT", "chrT-reversed"}
    assert csv_p == csv_r and mats_p == mats_r


def test_cli_testing_mode(tmp_path):
    (csv_p, mats_p), (csv_r, mats_r) = _run_both_clis(tmp_path, [
        "-r", "24", "-q", "8", "-d", "5", "-e", "2", "--rsquared", "100",
        "--seed", "4"])
    assert list(json.loads(mats_p)) == ["test"]
    assert csv_p.count("\n") > 1  # the planted copies are found
    assert csv_p == csv_r and mats_p == mats_r


def test_cli_preflight_leaves_no_files(tmp_path, monkeypatch):
    """Divergence from the JAX package's CLI, whose pre-flight leaves empty
    output files behind when the run aborts: the port's removes what it
    created."""
    missing = str(tmp_path / "missing.fasta")
    for name, cli in (("port", port_cli), ("ref", ref_cli)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        with pytest.raises(FileNotFoundError):
            cli.main(["-i", missing])
    assert sorted(os.listdir(tmp_path / "port")) == []
    assert sorted(os.listdir(tmp_path / "ref")) == ["matrices.json", "output.csv"]
    # an existing output file is left as it was
    out = tmp_path / "port" / "keep.csv"
    out.write_text("old\n")
    with pytest.raises(FileNotFoundError):
        port_cli.main(["-i", missing, "-o", str(out)])
    assert out.read_text() == "old\n"
    assert sorted(os.listdir(tmp_path / "port")) == ["keep.csv"]
    # an unwritable path still fails before the scan
    with pytest.raises(SystemExit):
        port_cli.main(["-i", missing, "-o", str(tmp_path / "no" / "dir" / "x.csv")])


def _repeat_raw(rng):
    motif = _dna(rng, 40)
    return "".join(_dna(rng, 100) + motif for _ in range(6)).encode()


def test_checkpoint_resume(tmp_path, rng):
    raw = _repeat_raw(rng)
    ckpt = str(tmp_path / "state.json")
    po, ro = _opts(repeat_length=32, query_offset=12, deletions=6.0, extension=2.0,
                   repeats=3)
    res1 = P.perform_calculation_per_sequence(po, raw, "chr", np.random.default_rng(2),
                                              checkpoint=ckpt)
    _same_results(res1, R.perform_calculation_per_sequence(
        ro, raw, "chr", np.random.default_rng(2)))
    state = P._load_checkpoint(ckpt, "chr")
    assert isinstance(state, dict) and "direct" in state
    res2 = P.perform_calculation_per_sequence(po, raw, "chr",
                                              np.random.default_rng(999),
                                              checkpoint=ckpt)
    _same_results(res2, res1)
    assert P._load_checkpoint(ckpt, "other") is None

    # mid-run resume: rewrite the checkpoint as cycle-1 in-flight state
    mid = P._load_checkpoint(ckpt, "chr")["direct"]
    P._save_checkpoint(ckpt, "chr", 1, 10.0, 2.0, mid.matrix, mid.tasks)
    cycle, mean, std, matrix, tasks = P._load_checkpoint(ckpt, "chr")
    assert cycle == 1 and mean == 10.0 and matrix.shape == (4, 32)
    res3 = P.perform_calculation_per_sequence(po, raw, "chr", np.random.default_rng(7),
                                              checkpoint=ckpt)
    assert "direct" in res3
    assert isinstance(P._load_checkpoint(ckpt, "chr"), dict)


class _Killed(BaseException):
    pass


def _kill_after(monkeypatch, mod, n_cycles):
    """Make ``mod``'s engine die at the start of cycle ``n_cycles + 1``."""
    real = mod.calculate_cycle
    calls = []

    def cycle(*a, **kw):
        if len(calls) == n_cycles:
            raise _Killed
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(mod, "calculate_cycle", cycle)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_killed_scan_resumes_to_the_uninterrupted_result(tmp_path, rng, monkeypatch,
                                                         writer):
    """Kill + resume: a scan killed after cycle 2 and resumed from its
    checkpoint equals the uninterrupted scan — also when the JAX engine
    wrote the checkpoint and the port resumes it."""
    raw = _repeat_raw(rng)
    kw = dict(repeat_length=32, query_offset=12, deletions=6.0, extension=2.0,
              repeats=4, reverse=True)
    po, ro = _opts(**kw)
    full = R.perform_calculation_per_sequence(ro, raw, "chr", np.random.default_rng(4))
    ckpt = str(tmp_path / "state.json")
    mod, opts = (P, po) if writer == "port" else (R, ro)
    with monkeypatch.context() as m:
        _kill_after(m, mod, 2)
        with pytest.raises(_Killed):
            mod.perform_calculation_per_sequence(opts, raw, "chr",
                                                 np.random.default_rng(4),
                                                 checkpoint=ckpt)
    cycle, *_ = P._load_checkpoint(ckpt, "chr", P._input_fingerprint(raw, po))
    assert cycle == 2
    resumed = P.perform_calculation_per_sequence(po, raw, "chr",
                                                 np.random.default_rng(99),
                                                 checkpoint=ckpt)
    _same_results(resumed, full)
    # the completed checkpoint replays in the other package too
    _same_results(R.perform_calculation_per_sequence(ro, raw, "chr",
                                                     np.random.default_rng(5),
                                                     checkpoint=ckpt), full)


def test_exploring_per_record_checkpoints(tmp_path, rng):
    fa = tmp_path / "two.fasta"
    fa.write_text(f">recA\n{_dna(rng, 400)}\n>recB\n{_dna(rng, 400)}\n")
    base = str(tmp_path / "state.json")
    po, ro = _opts(repeat_length=24, query_offset=10, deletions=6.0, extension=2.0,
                   repeats=2)
    res1 = P.run_exploring_cmd(po, fa, np.random.default_rng(5), checkpoint=base)
    _same_results(res1, R.run_exploring_cmd(ro, fa, np.random.default_rng(5)))
    pa = P._record_checkpoint_path(base, "recA")
    pb = P._record_checkpoint_path(base, "recB")
    assert pa != pb and os.path.exists(pa) and os.path.exists(pb)
    assert (pa, pb) == (R._record_checkpoint_path(base, "recA"),
                        R._record_checkpoint_path(base, "recB"))
    res2 = P.run_exploring_cmd(po, fa, np.random.default_rng(999), checkpoint=base)
    _same_results(res2, res1)


def test_csv_mode_checkpoint_resume(tmp_path, rng):
    fa = tmp_path / "one.fasta"
    fa.write_text(f">recC\n{_dna(rng, 400)}\n")
    csv = tmp_path / "known.csv"
    csv.write_text("name,z_value,left_coord,right_coord\nrecC,3.0,10,40\n")
    base = str(tmp_path / "state.json")
    po, ro = _opts(repeat_length=24, query_offset=10, deletions=6.0, extension=2.0,
                   repeats=2)
    res1 = P.run_csv_cmd(po, fa, csv, np.random.default_rng(5), checkpoint=base)
    _same_results(res1, R.run_csv_cmd(ro, fa, csv, np.random.default_rng(5)))
    pc = P._record_checkpoint_path(base, "recC")
    assert os.path.exists(pc)
    assert isinstance(P._load_checkpoint(pc, "recC"), dict)
    res2 = P.run_csv_cmd(po, fa, csv, np.random.default_rng(999), checkpoint=base)
    _same_results(res2, res1)


def test_checkpoint_rejects_different_input(tmp_path, rng):
    raw = _repeat_raw(rng)
    masked = b"N" * 120 + raw[120:]
    po, ro = _opts(repeat_length=32, query_offset=12, deletions=6.0, extension=2.0,
                   repeats=2)
    fp = P._input_fingerprint
    assert fp(raw, po) != fp(masked, po)
    assert fp(raw, po) != fp(raw, P.SearchOptions(repeat_length=30, query_offset=12,
                                                  deletions=6.0, extension=2.0,
                                                  repeats=2))
    a1 = rng.integers(0, 4, 5000).astype(np.int8)
    a2 = a1.copy()
    a2[2500] = (a2[2500] + 1) % 4
    assert fp(a1, po) != fp(a2, po)
    # the same digest as the JAX package: checkpoints are shared
    for x in (raw, masked, a1):
        assert fp(x, po) == R._input_fingerprint(x, ro)

    ckpt = str(tmp_path / "state.json")
    P.perform_calculation_per_sequence(po, raw, "chr", rng, checkpoint=ckpt)
    assert isinstance(P._load_checkpoint(ckpt, "chr", fp(raw, po)), dict)
    assert P._load_checkpoint(ckpt, "chr", fp(masked, po)) is None
    res_masked = P.perform_calculation_per_sequence(
        po, masked, "chr", np.random.default_rng(3), checkpoint=ckpt)
    assert isinstance(P._load_checkpoint(ckpt, "chr", fp(masked, po)), dict)
    _same_results(res_masked, R.perform_calculation_per_sequence(
        ro, masked, "chr", np.random.default_rng(3)))


def test_seeded_resume_reproduces_uninterrupted_run(tmp_path, rng):
    motif = _dna(rng, 30)
    fasta = tmp_path / "two.fasta"
    fasta.write_text(
        ">chrA\n" + (_dna(rng, 80) + motif) * 4 + "\n"
        ">chrB\n" + (_dna(rng, 90) + motif) * 4 + "\n"
    )
    po, ro = _opts(repeat_length=24, query_offset=10, deletions=6.0, extension=2.0,
                   repeats=2)
    ck1 = str(tmp_path / "a" / "ck.json")
    ck2 = str(tmp_path / "b" / "ck.json")
    os.makedirs(os.path.dirname(ck1))
    os.makedirs(os.path.dirname(ck2))
    full = P.run_exploring_cmd(po, str(fasta), np.random.default_rng(77), checkpoint=ck1)
    P.run_exploring_cmd(po, str(fasta), np.random.default_rng(77), checkpoint=ck2)
    os.remove(P._record_checkpoint_path(ck2, "chrB"))
    resumed = P.run_exploring_cmd(po, str(fasta), np.random.default_rng(77),
                                  checkpoint=ck2)
    _same_results(resumed, full)
    _same_results(full, R.run_exploring_cmd(ro, str(fasta), np.random.default_rng(77)))
