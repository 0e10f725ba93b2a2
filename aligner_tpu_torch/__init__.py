"""aligner_tpu_torch — the PyTorch and CUDA port of aligner-tpu.

Same capabilities and bit-exact semantics as ``aligner_tpu`` (the JAX
package, which stays the reference), with hand-written CUDA kernels for
NVIDIA Hopper in place of the Pallas TPU kernels.  Ported so far: the
main path, batched exact DP (:func:`batch_align`) with on-device
traceback, one-vs-many search and p-values; and the PWM path,
query-vs-PWM alignment (:func:`align_pwm`, :func:`batch_align_pwm`), the
heuristic PWM aligner and the latent-repeat search (:mod:`.repeat`).

The package imports ``torch`` and never ``jax``; its framework-free
modules (alphabets, matrices, I/O, oracle, native runtime) are copies of
the JAX package's.
"""

from .alphabet import DNA, Index, Protein, index_coord, rotate_indices
from .errors import (
    AlignerError,
    CalculationError,
    CharIsNotMatchable,
    MatrixShapeError,
    MissingArgument,
    ResultIsEmpty,
    UnnecessaryArgument,
    ValidationError,
    WrongMatrixSpecified,
)
from .matrices import blosum50, blosum62, get_threshold, random_pwm, transform_matrix
from .result import Alignment, AlignmentResult, PWMAlignment
from . import align, native, observability, search, statistics  # noqa: E402
from .align import BatchScores, PWMAligner, align_pwm, batch_align, batch_align_pwm
from .heuristic import HeuristicPWMAligner, Heuristics, heuristic_align_pwm
from . import repeat  # noqa: E402
from .search import SearchHit, search_database
from .statistics import (
    DistributionParams,
    calculate_distribution_params,
    calculate_p_value,
)

__version__ = "0.1.0"

__all__ = [
    "align",
    "native",
    "observability",
    "search",
    "statistics",
    "repeat",
    "BatchScores",
    "batch_align",
    "align_pwm",
    "batch_align_pwm",
    "PWMAligner",
    "Heuristics",
    "heuristic_align_pwm",
    "HeuristicPWMAligner",
    "SearchHit",
    "search_database",
    "DistributionParams",
    "calculate_distribution_params",
    "calculate_p_value",
    "DNA",
    "Protein",
    "Index",
    "index_coord",
    "rotate_indices",
    "blosum50",
    "blosum62",
    "get_threshold",
    "random_pwm",
    "transform_matrix",
    "Alignment",
    "PWMAlignment",
    "AlignmentResult",
    "AlignerError",
    "CharIsNotMatchable",
    "UnnecessaryArgument",
    "MissingArgument",
    "ResultIsEmpty",
    "CalculationError",
    "ValidationError",
    "MatrixShapeError",
    "WrongMatrixSpecified",
]
