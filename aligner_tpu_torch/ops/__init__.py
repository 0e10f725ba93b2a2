"""Device compute kernels of the port and their plain versions.

``dp_fill`` (CUDA, ``csrc/dp_fill.cu``) is the batched DP fill, with
``scan_engine`` as its plain PyTorch version; ``device_walk`` (CUDA,
``csrc/device_walk.cu``) is the batched traceback walk with its plain
version beside it, and the counting walk (``walk_counts``: the walk with
the heuristic population's count as its epilogue, the population's path);
``wavefront`` (CUDA, ``csrc/wavefront.cu``,
``csrc/wavefront_band.cu``, ``csrc/wavefront_block.cu``) is one huge global
pair: the row-scan fill and the walk over its replayed blocks, the band
fill of its end score, and the column-block fill of the column-blocked
pipeline, each with its plain version.  Kernels are built with ``nvcc`` at
first use (``_build``), never at import.
"""

from .scan_engine import FillResult, fill_batch

__all__ = ["FillResult", "fill_batch"]
