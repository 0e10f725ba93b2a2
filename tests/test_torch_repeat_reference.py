"""The latent-repeat search through ``run_exploring_cmd`` (a one-record FASTA
file) and ``perform_calculation_per_sequence`` against the benchmark's
plain reference (``benchmark/reference/repeat.py``, loaded by its path), on
the CPU at small sizes: chromosomes made as the benchmark's driver makes
them (``benchmark/drivers/repeat.py``: uniform bases, mutated copies of one
query planted at regular offsets), a PWM of W 30 positions, windows of 33
bases at a step of 3, del 30, ext 7, so that cycles run and windows
survive; a chromosome whose first cycle keeps no window, so that the loop
ends after two scans; a search whose cycles all run (``repeats`` 2); and a
chromosome with a planted copy at its very end, whose windows there are
clipped by the record's end.  Every task's left, right, z and f, every
entry of the final PWM and the number of scans are compared bit for bit.
Tolerance: none."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from aligner_tpu_torch.repeat import engine

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


REF = _load("reference/repeat.py", "reference.repeat")  # its package: it imports .fill
DRIVER = _load("drivers/repeat.py", "bench_driver_repeat")

W, OFFSET, DEL, EXT = 30, 3, 30.0, 7.0


def _chromosome(bases, seed, planted, at_end=False):
    raw = DRIVER.make_chromosome(bases, seed, planted, W + OFFSET, 4)
    if at_end:  # the first planted copy again as the record's last bases
        stride = bases // (planted + 1)
        raw = raw[:-(W + OFFSET)] + raw[stride:stride + W + OFFSET]
    return raw


# name: (bases, chromosome seed, planted copies, generator seed, repeats,
# entry, copy at the end); the scans each takes are in ``SCANS``
CASES = {
    "3kb": (3000, 1, 4, 5, 10, "exploring", False),
    "8kb-per-sequence": (8000, 2, 6, 6, 10, "per-sequence", False),
    "20kb": (20000, 3, 8, 7, 10, "exploring", False),
    "20kb-every-cycle": (20000, 3, 8, 8, 2, "per-sequence", False),
    "first-cycle-empty": (600, 40, 1, 0, 10, "exploring", False),
    "copy-at-the-end": (3000, 53, 4, 3, 10, "exploring", True),
}
SCANS = {"3kb": 4, "8kb-per-sequence": 4, "20kb": 4, "20kb-every-cycle": 3,
         "first-cycle-empty": 2, "copy-at-the-end": 4}


def _port(raw, gen, repeats, entry, tmp_path):
    opts = engine.SearchOptions(repeat_length=W, query_offset=OFFSET, deletions=DEL,
                                extension=EXT, repeats=repeats, device="cpu")
    rng = np.random.default_rng(gen)
    if entry == "exploring":
        path = tmp_path / "chromosome.fasta"
        DRIVER.write_fasta(str(path), raw)
        out = engine.run_exploring_cmd(opts, str(path), rng)
        assert list(out) == [DRIVER.HEAD]
    else:
        # run_exploring_cmd's per-record generator, handed over directly
        out = engine.perform_calculation_per_sequence(opts, raw, DRIVER.HEAD,
                                                      engine._record_rng(rng))
        assert list(out) == ["direct"]
    (res,) = out.values()
    return res


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_search_is_the_plain_reference(case, tmp_path):
    bases, cseed, planted, gen, repeats, entry, at_end = CASES[case]
    raw = _chromosome(bases, cseed, planted, at_end)
    res = _port(raw, gen, repeats, entry, tmp_path)
    want = REF.search(raw, REF.Options(W, OFFSET, DEL, EXT, repeats), gen,
                      device=torch.device("cpu"))
    got = [(t.left_coord, t.right_coord, t.z, t.f) for t in res.tasks]
    assert res.scans == want.scans == SCANS[case]
    assert len(got) == len(want.tasks)
    for a, b in zip(got, want.tasks):
        assert a[:2] == b[:2]
        assert np.float64(a[2]).tobytes() == np.float64(b[2]).tobytes(), (a, b)
        assert np.float64(a[3]).tobytes() == np.float64(b[3]).tobytes(), (a, b)
    assert np.array_equal(res.matrix.view(np.int64), want.matrix.view(np.int64))
    assert DRIVER.wrong({"tasks": got, "matrix": res.matrix, "scans": res.scans},
                        want) == (0, 0, 0)
    if case == "first-cycle-empty":
        assert got == []
    else:
        assert got
    if at_end:
        assert any(t[1] == bases for t in got)
