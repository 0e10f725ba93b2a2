"""BLAST p-value comparison harness.

Covers the reference's validation tooling:
* ``load_blast_results`` — CSV loader equivalent of
  insert_blast_results.py:9-17 (rows: query_id, target_id, blast_p with
  comma decimal separators);
* ``run_cmp`` — equivalent of aligner-web/src/bin/blast_p_value_cmp.rs:
  for each blast_cmp row with a NULL p-value, resolve the sequences by
  identifier from align_tasks, SW-align with BLOSUM62 (del=11, ext=1),
  compute the Karlin-Altschul p-value and store it.

The port's copy of ``aligner_tpu/service/blast_cmp.py``, on the port's
``align_local`` and ``calculate_p_value`` with ``device`` in place of
``backend``.  The device is resolved before the first row, and only a
row's data errors (:func:`~aligner_tpu_torch.errors.is_data_error`) skip
it: no card, a failed kernel build or a CUDA error propagates, where the
reference's copy would log it per row and report the rows it skipped as a
finished pass.
"""

from __future__ import annotations

import csv

import numpy as np

from ..align import align_local
from ..backend import resolve_device
from ..errors import is_data_error
from ..matrices import blosum62
from ..statistics import calculate_p_value
from .store import Store


def load_blast_results(store: Store, csv_path: str) -> int:
    from ..observability import log

    n = 0
    with open(csv_path, newline="") as fh:
        for i, row in enumerate(csv.reader(fh)):
            if len(row) < 3:
                continue
            try:
                p = float(row[2].replace(",", "."))
            except ValueError:
                # header lines and malformed values must not abort the
                # load mid-file: inserts already committed would
                # duplicate on a rerun (blast_cmp has no unique key)
                log.warning("%s row %d: unparsable p-value %r — skipped",
                            csv_path, i + 1, row[2])
                continue
            store.insert_blast_result(row[0], row[1], p)
            n += 1
    return n


def run_cmp(
    store: Store, *, rng=None, device=None, n_sequences: int = 5000
) -> int:
    """Backfill our p-values next to BLAST's (blast_p_value_cmp.rs:16-58)."""
    from ..alphabet import Protein
    from ..observability import log

    device = resolve_device(device)
    m = blosum62()
    done = 0
    for row_id, query_id, target_id in store.get_cmp_rows_with_null_p_value():
        query = store.get_sequence_by_identifier(query_id)
        target = store.get_sequence_by_identifier(target_id)
        if query is None or target is None:
            log.warning(
                "blast_cmp row %s: unknown identifier %r; skipping",
                row_id, query_id if query is None else target_id,
            )
            continue
        try:
            # strict=False: same treatment the rest of the pipeline
            # gives these sequences (skip unknown characters)
            q = Protein.encode(query, strict=False)
            t = Protein.encode(target, strict=False)
            res = align_local(q, t, m, 11.0, 1.0, device=device)
            p = calculate_p_value(
                q, t, res.alignment.f, 11.0, 1.0, m,
                rng=rng or np.random.default_rng(), device=device,
                n_sequences=n_sequences,
            )
        except Exception as e:
            if not is_data_error(e):
                raise
            log.warning("blast_cmp row %s failed (%s: %s); skipping",
                        row_id, type(e).__name__, e)
            continue
        store.add_cmp_p_value_by_id(p, row_id)
        done += 1
    return done
