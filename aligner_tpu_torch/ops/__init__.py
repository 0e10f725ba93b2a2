"""Device compute kernels of the port and their plain versions.

``dp_fill`` (CUDA, ``csrc/dp_fill.cu``) is the batched DP fill, with
``scan_engine`` as its plain PyTorch version; ``device_walk`` (CUDA,
``csrc/device_walk.cu``) is the batched traceback walk with its plain
version beside it.  Kernels are built with ``nvcc`` at first use
(``_build``), never at import.
"""

from .scan_engine import FillResult, fill_batch

__all__ = ["FillResult", "fill_batch"]
