"""``aligner-torch-calc`` — p-value backfill worker.

Equivalent of aligner-core/src/bin/calc/main.rs: for every task with a
NULL p-value, load its promoted result (query, target, f, del, matrix)
and compute a Karlin-Altschul p-value with (del, del) gap params, then
store it.  The 5,000 shuffled alignments per task run as one batched
scores-only launch on the card (``--device cuda``, the default, raises
without one) or on its plain PyTorch version (``--device cpu``).

The device is resolved before the first task, and only a task's data
errors (:func:`~aligner_tpu_torch.errors.is_data_error`) skip it: no card,
a failed kernel build or a CUDA error ends the run with an error, where
the reference's copy would log it per task and report 0 p-values
backfilled as a finished pass.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..alphabet import Protein
from ..backend import resolve_device
from ..errors import is_data_error
from ..observability import configure_logging, log
from ..service.store import Store, open_store
from ..statistics import calculate_p_value


def run_once(store: Store, *, rng=None, device=None, n_sequences=5000) -> int:
    device = resolve_device(device)
    done = 0
    for task_id in store.get_ids_with_null_p_value():
        row = store.get_result_matrix_by_task_id(task_id)
        if row is None:
            continue  # not promoted yet
        query, target, f_value, del_value, matrix = row
        try:
            # strict=False matches how the dispatcher/worker treated
            # these sequences (unknown characters skipped) — strict
            # encoding would crash the whole backfill on one task the
            # rest of the pipeline accepted, and the same task would
            # starve every later one on every pass
            p = calculate_p_value(
                Protein.encode(query, strict=False),
                Protein.encode(target, strict=False),
                f_value, del_value, del_value, matrix,
                rng=rng or np.random.default_rng(), device=device,
                n_sequences=n_sequences,
            )
        except Exception as e:
            if not is_data_error(e):
                raise
            log.warning("task %s: p-value failed (%s: %s); skipping",
                        task_id, type(e).__name__, e)
            continue
        store.add_p_value_by_id(p, task_id)
        done += 1
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aligner-torch-calc", description=__doc__)
    ap.add_argument("--db", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda: the kernels (raises without a card); "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--sequences", type=int, default=5000)
    args = ap.parse_args(argv)
    configure_logging()
    store = open_store(args.db)
    n = run_once(
        store, rng=np.random.default_rng(args.seed), device=args.device,
        n_sequences=args.sequences,
    )
    print(f"backfilled {n} p-value(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
