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
  process's cards by itself;
* the column-blocked pipeline for one huge global pair
  (:mod:`.wavefront_sp`: :func:`sharded_global_end_score`,
  :func:`sharded_global_align`) takes a mesh: its column blocks are placed
  in contiguous runs on the slots of the ``data`` axis
  (:func:`~.mesh.data_slots`), across this process's cards and across the
  processes of the group, each row block's right boundary handed to the
  next slot (a copy within a process, ``isend``/``irecv`` between
  processes), the end score reduced and the trace records gathered to
  every process, which walks the same traceback; ``align_global`` and
  ``global_end_score`` send a huge pair there over an (n, 1) mesh of this
  process's cards when they see several.
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
