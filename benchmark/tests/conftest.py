"""The benchmark's CPU tests: its manifest, generators and reference, and
runs of each cell at small sizes on the CPU with faults planted.  Run from
the repository's root:

    python -m pytest benchmark/tests -q

Nothing here needs a card; the controls at the cells' own sizes run on the
card by ``python3 benchmark/control.py``.
"""

import os
import sys

import pytest
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

torch.set_num_threads(1)

# the cells at sizes a CPU test can hold: the program's plain fill on the
# CPU is a Python loop over cell rows
SMALL_CONFIG = {
    "protein-search": {"database": {"sequences": 40,
                                    "length": {"median": 20, "min": 8, "max": 40},
                                    "homologs": {"max_length": 200}}},
    "align-service": {"records": [{"id": "a", "seq": "MRLCLIPWNTTPHRVLPPVVWSAPSRKKPV"},
                                  {"id": "b", "seq": "MRLCLIPQNTGTPQRVLPPVVWSPPSRKKPM"}],
                      "request": {"matricesVolumeValue": 4}, "pvalue": {"n_sequences": 30}},
}
SMALL_TRAFFIC = {
    "search.long-queries": {"queries": {"lengths": [60, 90, 75]}},
    "search.typical-queries": {"queries": {"count": 4, "length": {"median": 15, "min": 8,
                                                                  "max": 30}},
                               "check_requests": 2},
    "service.population": {"check_requests": 3, "trace_requests": 3},
    "service.pvalue": {"check_requests": 3},
}


@pytest.fixture
def small():
    from harness import manifest

    bench = manifest.load()

    def over(cell):
        return dict(config_overrides=SMALL_CONFIG[manifest.cell(bench, cell)["config"]],
                    traffic_overrides=SMALL_TRAFFIC[cell])
    return over
