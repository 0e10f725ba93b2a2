"""The control of a cell's comparison: the plain reference, computed one
precision below the configuration's (``control_dtype`` in its file),
put in the program's place on the requests a window answers first, and
compared as a run compares the program.  Each number must come out above
its limit (the comparison fails it), or the comparison could not tell a
lower precision from the program.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

Prints one JSON line a seed: the numbers compared with their limits.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import manifest  # noqa: E402
from harness.record import Run  # noqa: E402


def control_checks(cell_name: str, seed: int, device, *, config_overrides=None,
                   traffic_overrides=None) -> list:
    import torch

    from run import _merge

    bench = manifest.load()
    cell = manifest.cell(bench, cell_name)
    cfg = _merge(manifest.config(bench, cell["config"]), config_overrides or {})
    traffic = _merge(manifest.traffic(cell["traffic"]), traffic_overrides or {})
    drv = manifest.driver(traffic["driver"])
    run = Run(cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=0.0, trace=False,
              device=device)
    st = drv.inputs(run)
    return drv.control(st, run, getattr(torch, cfg["control_dtype"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seed:
        t0 = time.perf_counter()
        checks = control_checks(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
                          "failed_as_it_must": any(v > lim for _, v, lim in checks)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
