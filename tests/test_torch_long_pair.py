"""One global DNA pair through ``align_global`` and ``global_end_score``
against the benchmark's plain reference (``benchmark/reference/global_pair.py``,
loaded by its path), on the CPU at small sizes: the column-blocked pipeline
(``backend="wavefront_sp"``, its column block cut to 256 and its replay
tile to 64 rows, with the CPU's engine and with the engines the card's pick
runs), the single-plane routes (the direct plane, and the chunked replay
with its tile cut to 128 rows), under the ``long-pair`` configuration's
scoring (+1 / -3, del 5, ext 2) and an asymmetric DNA table, on pairs made
as the benchmark's pool makes them (``benchmark/drivers/pair.py``), lengths
1 to 600; and the reference against the oracle on the same pairs.
Tolerance: none.  Every value is an integer, a code or a coordinate and is
compared for equality."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import aligner_tpu_torch as port
from aligner_tpu_torch import oracle
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.parallel import wavefront_sp as sp

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")


def _load(rel: str, name: str):
    """A module of the benchmark by its path, with the benchmark's own
    folder on the path while it loads (its modules import each other)."""
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, rel))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # dataclasses look their module up by name
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(BENCH)


REF = _load("reference/global_pair.py", "bench_reference_global_pair")
DRIVER = _load("drivers/pair.py", "bench_driver_pair")

CELL = (np.where(np.eye(4, dtype=bool), 1, -3).astype(np.float64), 5, 2)
DNA44 = (np.array([[5, -4, -3, -4], [-4, 6, -4, -2], [-3, -4, 7, -4], [-4, -2, -4, 4]],
                  np.float64), 5, 2)  # asymmetric on purpose: catches a transposed lookup
SCORING = {"cell": CELL, "dna44": DNA44}
CB, TB = 256, 64  # the pipeline's column block and replay tile in these tests

# (length, substituted, seed): the pool's construction from 1 base to a few
# hundred, over three column blocks at 600; "corner" is a pair identical
# over 512 bases, whose path is the diagonal through the corner (256, 256)
# of four pipeline blocks
PAIRS = {
    "one-base": (1, 0.30, 1), "two-bases": (2, 0.15, 2), "short": (17, 0.30, 3),
    "mid": (130, 0.05, 4), "wide": (300, 0.15, 5), "three-blocks": (600, 0.01, 6),
    "corner": (512, 0.0, 7),
}


def _pair(name):
    n, sub, seed = PAIRS[name]
    return DRIVER.homolog_pair(n, sub, 0.1, np.random.default_rng(seed))


def _card_pick(monkeypatch):
    """The engine pick the card makes, here on the CPU."""
    pick = sp._pick_engine
    monkeypatch.setattr(sp, "_pick_engine", lambda engine, tr, on_card, *a, **kw:
                        pick(engine, tr, True, *a, **kw))


ROUTES = ["pipeline", "pipeline-card-pick", "plane-direct", "plane-chunked"]


@pytest.fixture
def route(request, monkeypatch):
    name = request.param
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")
    if name.startswith("pipeline"):
        monkeypatch.setattr(sp, "CB_COLS", CB)
        monkeypatch.setitem(sp.sharded_global_align.__kwdefaults__, "tb_rows", TB)
        if name == "pipeline-card-pick":
            _card_pick(monkeypatch)
        return "wavefront_sp"
    if name == "plane-chunked":
        monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 0)
        monkeypatch.setitem(wf.align_single_global_chunked.__kwdefaults__, "tb_rows", 128)
    return None


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("scoring", sorted(SCORING))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_the_port_matches_the_plain_reference(route, scoring, pair):
    q, t = _pair(pair)
    m, d, e = SCORING[scoring]
    end, qa, ta, coords = REF.global_pair(q, t, m, d, e, device="cpu", block_rows=32,
                                          window=40, chunk=16)
    got = port.align_global(q, t, m, d, e, alphabet=port.DNA, backend=route, device="cpu")
    a = got.alignment
    assert np.array_equal(a.query, qa) and np.array_equal(a.target, ta)
    assert a.query.dtype == qa.dtype and a.coords == coords
    score = port.global_end_score(q, t, m, d, e, alphabet=port.DNA, backend=route,
                                  device="cpu")
    assert score == end


def _cells(qa, ta, y: int, x: int):
    """The cells the path enters from [y, x] = [R, C] back: every column
    before the seeded last one, read backwards, is a step."""
    out = [(y, x)]
    for a, b in zip(qa[-2::-1], ta[-2::-1]):
        y -= int(b != REF.BLANK)
        x -= int(a != REF.BLANK)
        out.append((y, x))
    return out


def test_the_corner_pair_crosses_a_block_corner():
    q, t = _pair("corner")
    _, qa, ta, _ = REF.global_pair(q, t, *CELL, device="cpu", block_rows=32, window=40,
                                   chunk=16)
    assert (256, 256) in _cells(qa, ta, len(t), len(q))


@pytest.mark.parametrize("scoring", sorted(SCORING))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_the_reference_matches_the_oracle(scoring, pair):
    q, t = _pair(pair)
    m, d, e = SCORING[scoring]
    o = oracle.align_global(q, t, m, d, e)
    for block_rows, window, chunk in ((2048, 8192, 1024), (1, 1, 1), (7, 5, 3)):
        end, qa, ta, coords = REF.global_pair(q, t, m, d, e, device="cpu",
                                              block_rows=block_rows, window=window,
                                              chunk=chunk)
        assert end == o.score[len(t), len(q)]
        assert np.array_equal(qa, o.query_aligned) and np.array_equal(ta, o.target_aligned)
        assert coords == o.coords
