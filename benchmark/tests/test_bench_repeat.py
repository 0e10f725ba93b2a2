"""The ``repeat.chromosome-10mb`` cell at small sizes on the CPU: a sound run
is correct, untraced and traced (where the span metrics read the program's
``repeat`` spans); the program broken underneath in each way the cell must
catch comes out not correct; a request's cells against a hand count; the
roofline's bounds against hand sums; the readers on synthetic spans, and
no number without them; and the reference one precision lower fails the
comparison.

The chromosomes are cut to 8,000 bases, the PWM to 30 positions and the
windows to 33 bases at a step of 3; set-up's request to a prefix of 2,000."""

import numpy as np
import pytest
import torch

import control
import run as R
from harness import manifest, program_spans, roofline, roofline_repeat
from harness.record import Run
from harness.trace import Trace

CELL = "repeat.chromosome-10mb"
SMALL = {"options": {"repeat_length": 30, "query_offset": 3}, "chromosome": {"bases": 8000},
         "pool": {"planted": 6, "planted_length": 33}}
SMALL_TRAFFIC = {"warm_up": {"bases": 2000}}
METRICS = ["device_idle_pct.repeat", "scan_roofline.repeat", "survivor_roofline.repeat",
           "host_ms_per_request.repeat", "survivor_ms_per_request.repeat"]
SEED = 2**31 + 77


def _run(trace=False, config=SMALL, seed=SEED):
    return R.run_cell(CELL, seed, 1.0, trace, torch.device("cpu"), config_overrides=config,
                      traffic_overrides=SMALL_TRAFFIC)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_sound_run_is_correct(trace):
    run = _run(trace)
    assert run.correct(), run.checks
    assert [name for name, _, _ in run.checks] == ["tasks_wrong", "matrix_wrong", "scans_wrong"]
    assert all(r["tasks"] for r in run.requests)
    if not trace:
        assert set(run.metrics) == {"gcups", "setup_s"}
        assert [r["pool"] for r in run.requests[:2]] in ([0, 1], [1, 0])
        assert len({r["gen"] for r in run.requests}) == len(run.requests)
        return
    assert len(run.requests) == 1
    assert run.metrics["host_ms_per_request.repeat"]["value"] > 0
    assert run.metrics["survivor_ms_per_request.repeat"]["value"] > 0
    # no kernel runs on the CPU: the device's shares stay unread
    assert "scan_roofline.repeat" not in run.metrics
    assert "survivor_roofline.repeat" not in run.metrics


def _engine():
    from aligner_tpu_torch.repeat import engine

    return engine


def _z_one_ulp(old):
    def f(*a, **kw):
        out = old(*a, **kw)
        for r in out.values():
            r.tasks[0].z = float(np.nextafter(r.tasks[0].z, np.inf))
        return out
    return f


def _best_dropped(old):
    """The overlap filter without the survivor of the largest z."""
    def f(left, right, z):
        best = max(range(len(z)), key=z.__getitem__)
        keep = old(*(v[:best] + v[best + 1:] for v in (left, right, z)))
        return [k + (k >= best) for k in keep]
    return f


def _one_more_scan(old):
    def f(*a, **kw):
        out = old(*a, **kw)
        for r in out.values():
            r.scans += 1
        return out
    return f


@pytest.mark.parametrize("fault", ["z-one-ulp", "survivor-dropped", "scan-float32",
                                   "scans-off-by-one"])
def test_a_broken_program_is_not_correct(fault, monkeypatch):
    eng = _engine()
    if fault == "z-one-ulp":
        monkeypatch.setattr(eng, "run_exploring_cmd", _z_one_ulp(eng.run_exploring_cmd))
    elif fault == "survivor-dropped":
        monkeypatch.setattr(eng, "_overlap_filter", _best_dropped(eng._overlap_filter))
    elif fault == "scan-float32":
        monkeypatch.setattr(eng, "dtype_for", lambda *a, **kw: torch.float32)
    else:
        monkeypatch.setattr(eng, "run_exploring_cmd", _one_more_scan(eng.run_exploring_cmd))
    run = _run()
    assert not run.correct(), run.checks


def test_a_requests_cells_against_a_hand_count():
    """100 bases, windows of 33 at a step of 3: the starts 0 ... 66 hold 33
    bases each (23 windows, 759); from 69 on, the record's end clips them to
    31, 28, ..., 1 (11 windows, 176); 935 bases a scan, x 30 positions."""
    drv = manifest.driver("repeat")
    cfg = R._merge(manifest.config(manifest.load(), "latent-repeat"),
                   dict(SMALL, chromosome={"bases": 100}))
    st = drv.inputs(Run(cell={}, config=cfg, traffic={}, seed=1, seconds=0.0, trace=False,
                        device=torch.device("cpu")))
    assert st.cells_per_scan == 935 * 30
    run = _run()
    per_scan = drv.inputs(run).cells_per_scan
    assert per_scan == sum(min(33, 8000 - j) for j in range(0, 8000, 3)) * 30
    for r in run.done():
        assert r["cells"] == r["scans"] * per_scan and r["scans"] >= 2


def test_roofline_bounds_against_hand_sums():
    # 2 windows of 10 bases in all against a (4, 3) PWM: 30 cells; the codes
    # 10 bytes, the table 4 x 3 x 8, a score and an argmax 16 a window
    f64, mem = roofline.PEAK_F64_S, roofline.PEAK_BYTES_S
    base = 10 + 96 + 32
    assert roofline_repeat.fill(2, 10, 3, dirs=False) == max(6 * 30 / f64, base / mem)
    assert roofline_repeat.fill(2, 10, 3, dirs=True) == max(10 * 30 / f64, (base + 7.5) / mem)
    # at the cell's size the operations bound a scan: 333,334 windows,
    # 109,999,890 bases
    bases = sum(min(330, 10_000_000 - j) for j in range(0, 10_000_000, 30))
    assert roofline_repeat.fill(333_334, bases, 300, dirs=False) == 6 * bases * 300 / f64


def test_the_kernels_are_told_apart_by_name():
    def name(*flags):
        return "void dpf::dp_fill_kernel<" + ", ".join(flags) + ">"
    scan = name("double", "false", "false", "false", "true", "false")
    survivors = name("double", "false", "true", "true", "true", "false")
    pair = name("double", "false", "true", "true", "false", "false")
    f32_scan = name("float", "false", "false", "false", "true", "false")
    assert roofline_repeat.SCAN_KERNEL(scan) and not roofline_repeat.SURVIVOR_KERNEL(scan)
    assert roofline_repeat.SURVIVOR_KERNEL(survivors) and not roofline_repeat.SCAN_KERNEL(survivors)
    for other in (pair, f32_scan):
        assert not roofline_repeat.SCAN_KERNEL(other)
        assert not roofline_repeat.SURVIVOR_KERNEL(other)


SCAN_NAME = "void dpf::dp_fill_kernel<double, false, false, false, true, false>"
SURVIVOR_NAME = "void dpf::dp_fill_kernel<double, false, true, true, true, false>"


def _traced_run():
    cfg = R._merge(manifest.config(manifest.load(), "latent-repeat"), SMALL)
    run = Run(cell={}, config=cfg, traffic={}, seed=1, seconds=1.0, trace=True,
              device=torch.device("cpu"),
              requests=[{"i": 0, "t0": 100.0, "t1": 101.0}, {"i": 1, "t0": 102.0, "t1": 103.0}])
    run.trace_summary = Trace(window_s=4.0, busy_s=1.0, kernels={
        SCAN_NAME: [0.5, 20], SURVIVOR_NAME: [0.2, 4], "Memcpy HtoD": [0.01, 30]}, idle={})
    run.work["scan_s"] = 0.05
    return run


def _spans(run):
    """One ``repeat`` root a request, 800 ms: ``repeat.start`` 0-100 with a
    scan 10-90; two cycles, 100-400 and 400-700, each with a scan (60 ms),
    a survivors' pass (100 ms; 7 and 5 tasks kept), a filter and a matrix;
    so the host's own 800 - 80 - 2 x 160 = 400 ms."""
    from aligner_tpu_torch.observability import SpanRecord

    out, ids = [], iter(range(1, 1000))
    for r in run.requests:
        base = int(r["t0"] * 1e9) + program_spans.offset_ns()

        def ms(v, base=base):
            return base + int(v * 1e6)
        root = next(ids)
        start = next(ids)
        out.append(SpanRecord("repeat.scan", ms(10), ms(90), next(ids), start, root,
                              {"windows": 10}))
        out.append(SpanRecord("repeat.start", ms(0), ms(100), start, root, root, {}))
        for lo, kept in ((100, 7), (400, 5)):
            cyc = next(ids)
            for name, a, b in (("repeat.scan", 0, 60), ("repeat.survivors", 60, 160),
                               ("repeat.filter", 160, 200), ("repeat.matrix", 200, 300)):
                out.append(SpanRecord(name, ms(lo + a), ms(lo + b), next(ids), cyc, root, {}))
            out.append(SpanRecord("repeat.cycle", ms(lo), ms(lo + 300), cyc, root, root,
                                  {"windows": 10, "survivors": 40, "kept": kept}))
        out.append(SpanRecord("repeat", ms(0), ms(800), root, None, root, {"scans": 3}))
    return out


def test_the_readers_on_synthetic_spans(monkeypatch):
    run = _traced_run()
    monkeypatch.setattr(program_spans, "_log", lambda: _spans(run))
    kept = 2 * (7 + 5)  # two requests' cycles
    want = {"device_idle_pct.repeat": 75.0, "scan_roofline.repeat": 10.0,
            "survivor_roofline.repeat":
                100.0 * roofline_repeat.fill(kept, kept * 33, 30, dirs=True) / 0.2,
            "host_ms_per_request.repeat": 400.0, "survivor_ms_per_request.repeat": 200.0}
    for name, value in want.items():
        assert manifest.reader(name).read(run) == pytest.approx(value, rel=1e-9), name


def test_the_readers_give_no_number_without_spans(monkeypatch):
    run = _traced_run()
    for log in (None, []):
        monkeypatch.setattr(program_spans, "_log", lambda: log)
        for name in METRICS:
            assert manifest.reader(name).read(run) is None, name


def test_the_control_fails_the_comparison():
    """The reference's fills in float32: the PWM's entries, the transform's
    non-integral output, round, so every window's score differs from its
    float64 score, and every task's f and z with it."""
    checks = dict((name, v) for name, v, _ in control.control_checks(
        CELL, SEED, torch.device("cpu"), config_overrides=SMALL,
        traffic_overrides=SMALL_TRAFFIC))
    assert checks["tasks_wrong"] > 0 and checks["matrix_wrong"] > 0, checks
