"""Paths of the port that place work on several devices and processes.

* the problem batch (shuffled alignments, chromosome windows, sequence
  pairs) shards over a mesh's ``data`` axis, the candidate-matrix
  population over its ``matrix`` axis (:mod:`.mesh`: :func:`make_mesh`,
  :func:`sharded_scores`, :func:`window_scan_step`,
  :func:`matrix_population_step`), one launch per shard on its device;
* several processes join one ``torch.distributed`` group (:mod:`.multihost`),
  each feeding its own block of a batch, the window statistics summed
  across them by ``all_reduce``;
* every batched fill of :mod:`aligner_tpu_torch.align` shards over this
  process's cards by itself.

The column-blocked pipeline for one huge global pair (:mod:`.wavefront_sp`)
still runs its column blocks on one card: placing them on several cards and
ranks (the right boundary handed on by send/recv, the trace records
gathered) comes later.
"""

from .mesh import make_mesh, matrix_population_step, sharded_scores, window_scan_step
from .wavefront_sp import sharded_global_align, sharded_global_end_score

__all__ = [
    "make_mesh",
    "sharded_scores",
    "window_scan_step",
    "matrix_population_step",
    "sharded_global_align",
    "sharded_global_end_score",
]
