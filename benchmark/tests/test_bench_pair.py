"""The ``pair.wide-524288`` cell at small sizes on the CPU: a sound run is
correct, untraced and traced (where the span metrics read the program's
``pair`` spans); the program broken underneath in each way the cell must
catch comes out not correct; the roofline counts on a hand-worked 3 x 4
pair; the readers give no number without the program's spans; and the
reference one precision lower fails the comparison.

The pairs are cut to a few hundred bases and the program's wavefront
routes to the CPU's sizes: a query wider than 128 columns takes the
column-blocked pipeline (``ops.wavefront.MAX_WIDTH``), whose column block
is 256 columns and whose replay tile is 64 rows."""

import numpy as np
import pytest
import torch

import control
import run as R
from harness import manifest, program_spans, roofline, roofline_pair
from harness.record import Run
from harness.trace import Trace

CELL = "pair.wide-524288"
SMALL = {"lengths": {"query": 300, "target": 300}}
METRICS = ["device_idle_pct.pair", "strip_roofline.pair", "band_roofline.pair",
           "walk_roofline.pair", "host_ms_per_request.pair"]


@pytest.fixture
def small_routes(monkeypatch):
    from aligner_tpu_torch.ops import wavefront as wf
    from aligner_tpu_torch.parallel import wavefront_sp as sp

    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")
    monkeypatch.setattr(wf, "MAX_WIDTH", 128)
    monkeypatch.setattr(sp, "CB_COLS", 256)
    monkeypatch.setitem(sp.sharded_global_align.__kwdefaults__, "tb_rows", 64)
    return sp


def _run(config=SMALL, trace=False, seed=2**31 + 2207):
    return R.run_cell(CELL, seed, 0.8, trace, torch.device("cpu"), config_overrides=config)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_sound_run_is_correct(small_routes, trace):
    run = _run(trace=trace)
    assert run.correct(), run.checks
    assert [name for name, _, _ in run.checks] == ["path_wrong", "end_wrong"]
    kinds = [r["kind"] for r in run.requests]
    assert kinds[:4] == ["align", "score", "align", "score"]
    if not trace:
        assert set(run.metrics) == {"gcups", "setup_s"}
        return
    # the span metrics; no kernel runs on the CPU, so the device's shares
    # stay unread
    assert len(run.requests) <= run.traffic["trace_requests"]
    assert run.metrics["host_ms_per_request.pair"]["value"] > 0
    assert "strip_roofline.pair" not in run.metrics


def _one_step_changed(old):
    def f(*a, **kw):
        end, qa, ta, coords = old(*a, **kw)
        i = int(np.flatnonzero((qa != 98) & (ta != 98))[len(qa) // 3])
        # a diagonal step taken as a top step and a left step
        qa = np.concatenate([qa[:i], [qa[i], 98], qa[i + 1:]]).astype(np.int16)
        ta = np.concatenate([ta[:i], [98, ta[i]], ta[i + 1:]]).astype(np.int16)
        return end, qa, ta, coords
    return f


def _end_plus_one(old):
    def f(*a, **kw):
        return old(*a, **kw) + 1.0
    return f


def _left_before_top(old):
    """The alignment from the oracle's plane with the tie taken left before
    top, walked by the port's traceback."""
    from aligner_tpu_torch import oracle
    from aligner_tpu_torch.traceback import traceback_global

    def direction(top, left, diagonal):
        m = max(top, left, diagonal)
        return m, (oracle.LEFT if m == left else oracle.TOP if m == top else oracle.DIAG)

    def f(mesh, q, t, matrix, del_, ext, **kw):
        saved, oracle._direction = oracle._direction, direction
        try:
            a, d = oracle.fill_global(q, t, matrix, del_, ext)
        finally:
            oracle._direction = saved
        return (float(a[len(t), len(q)]), *traceback_global(d, q, t))
    return f


def _corner_kept(sp):
    """The pipeline's border cells without the far-corner overwrite."""
    def row(pp, x0, width, device=None):
        x = x0 + torch.arange(1, width + 1, dtype=torch.int32, device=device or pp["device"])
        return (-x * pp["del"]).to(torch.int32)

    def col(pp, y0, height, device=None):
        return row(pp, y0, height, device)

    def corner(pp, x0, device=None):
        return torch.full((1,), -x0 * pp["del"], dtype=torch.int32,
                          device=device or pp["device"])
    return {"_border_row": row, "_border_col": col, "_corner": corner}


# a scoring under which the far corners decide the answer: a mismatch
# costs more than going round it by the borders
CORNER_CONFIG = {"lengths": {"query": 1, "target": 1},
                 "pairs": {"substituted": [1.0, 1.0, 1.0, 1.0]},
                 "scoring": {"matrix": [[1, -20, -20, -20], [-20, 1, -20, -20],
                                        [-20, -20, 1, -20], [-20, -20, -20, 1]],
                             "del": 1, "ext": 1}}


@pytest.mark.parametrize("fault", ["one-step", "end-plus-one", "left-before-top",
                                   "corner-kept"])
def test_a_broken_program_is_not_correct(fault, small_routes, monkeypatch):
    sp = small_routes
    config = SMALL
    if fault == "one-step":
        monkeypatch.setattr(sp, "sharded_global_align",
                            _one_step_changed(sp.sharded_global_align))
    elif fault == "end-plus-one":
        monkeypatch.setattr(sp, "sharded_global_end_score",
                            _end_plus_one(sp.sharded_global_end_score))
    elif fault == "left-before-top":
        monkeypatch.setattr(sp, "sharded_global_align", _left_before_top(None))
        config = {"lengths": {"query": 200, "target": 200},
                  "pairs": {"substituted": [0.3, 0.3, 0.3, 0.3]}}
    else:
        from aligner_tpu_torch.ops import wavefront as wf

        monkeypatch.setattr(wf, "MAX_WIDTH", 0)
        for name, fn in _corner_kept(sp).items():
            monkeypatch.setattr(sp, name, fn)
        config = CORNER_CONFIG
    run = _run(config)
    assert not run.correct(), run.checks


def test_the_sound_program_passes_the_corner_scoring(small_routes, monkeypatch):
    """The corner case's scoring and pairs are passed by the sound program:
    what the fault test catches is the fault."""
    from aligner_tpu_torch.ops import wavefront as wf

    monkeypatch.setattr(wf, "MAX_WIDTH", 0)
    run = _run(CORNER_CONFIG)
    assert run.correct(), run.checks


def test_roofline_counts_on_a_hand_worked_pair():
    # 3 x 4 = 12 cells; codes 3 + 4 bytes, a 4 x 4 int32 table 64, a score 4
    inputs = 3 + 4 + 64 + 4
    i32, mem = roofline.PEAK_I32_S, roofline.PEAK_BYTES_S
    assert roofline_pair.alignment(3, 4, 4) == max(9 * 12 / i32, (inputs + 3) / mem)
    assert roofline_pair.end_score(3, 4, 4) == max(5 * 12 / i32, inputs / mem)
    assert roofline_pair.walk(6) == max(10 * 6 / i32, 3 / mem)
    # at the cell's size the operations bound both fills
    n = 524288
    assert roofline_pair.alignment(n, n, 4) == 9 * n * n / i32
    assert roofline_pair.end_score(n, n, 4) == 5 * n * n / i32


def _traced_run():
    run = Run(cell={}, config={}, traffic={}, seed=1, seconds=1.0, trace=True,
              device=torch.device("cpu"),
              requests=[{"i": 0, "t0": 100.0, "t1": 100.5}, {"i": 1, "t0": 101.0, "t1": 101.5}])
    run.trace_summary = Trace(window_s=2.0, busy_s=1.5, kernels={
        "void fill_strips_kernel<8, true, true>": [0.5, 4],
        "void band_walk_kernel<8, 2>": [0.25, 4],
        "void replay_walk_kernel<4>": [0.01, 16]}, idle={})
    run.work.update(strip_s=0.1, band_s=0.05)
    return run


def _spans(run):
    """One ``pair`` root a request: 400 ms, of which forward 100-300 and a
    replay 300-380 with two walks inside it (30 and 20 steps); so 120 ms of
    the root is the host's own."""
    from aligner_tpu_torch.observability import SpanRecord

    out, ids = [], iter(range(1, 1000))
    for r in run.requests:
        base = int(r["t0"] * 1e9) + program_spans.offset_ns()

        def ms(v, base=base):
            return base + int(v * 1e6)
        root = next(ids)
        kids = [("pair.forward", 100, 300, {"launches": 4}, root),
                ("pair.replay", 300, 380, {"tiles": 2, "cells": 9}, root)]
        for name, a, b, counts, parent in kids:
            out.append(SpanRecord(name, ms(a), ms(b), next(ids), parent, root, counts))
        replay = out[-1].id
        for a, b, steps in ((300, 340, 30), (340, 370, 20)):
            out.append(SpanRecord("pair.walk", ms(a), ms(b), next(ids), replay, root,
                                  {"steps": steps}))
        out.append(SpanRecord("pair", ms(0), ms(400), root, None, root, {"cells": 9}))
    return out


def test_the_readers_on_synthetic_spans(monkeypatch):
    run = _traced_run()
    monkeypatch.setattr(program_spans, "_log", lambda: _spans(run))
    want = {"device_idle_pct.pair": 25.0, "strip_roofline.pair": 20.0,
            "band_roofline.pair": 20.0,
            "walk_roofline.pair": 100.0 * roofline_pair.walk(100) / 0.01,
            "host_ms_per_request.pair": 120.0}
    for name, value in want.items():
        assert manifest.reader(name).read(run) == pytest.approx(value, rel=1e-9), name


def test_the_readers_give_no_number_without_spans(monkeypatch):
    run = _traced_run()
    for log in (None, []):
        monkeypatch.setattr(program_spans, "_log", lambda: log)
        for name in METRICS:
            assert manifest.reader(name).read(run) is None, name


def test_the_control_fails_the_comparison(small_routes):
    """The reference in int16 wraps.  Neighbouring cells differ by far less
    than 2^15, so its wrapped rows keep every comparison and the path; the
    end score, beyond int16, comes out wrong.  At the cell's size the end
    score of any of its pairs is beyond int16; here a match scores 1,000 so
    that a pair of 300 bases takes it there."""
    big = (np.where(np.eye(4, dtype=bool), 1000, -3)).tolist()
    config = dict(SMALL, scoring={"matrix": big})
    checks = dict((name, v) for name, v, _ in
                  control.control_checks(CELL, 11, torch.device("cpu"), config_overrides=config))
    assert checks["end_wrong"] == 1, checks
