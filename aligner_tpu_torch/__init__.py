"""aligner_tpu_torch — the PyTorch and CUDA port of aligner-tpu.

Same capabilities and bit-exact semantics as ``aligner_tpu`` (the JAX
package, which stays the reference), with hand-written CUDA kernels for
NVIDIA Hopper in place of the Pallas TPU kernels.  Ported so far: the
main path, batched exact DP (:func:`batch_align`) with on-device
traceback, one-vs-many search and p-values; and the PWM path,
query-vs-PWM alignment (:func:`align_pwm`, :func:`batch_align_pwm`), the
heuristic PWM aligner and the latent-repeat search (:mod:`.repeat`); and
single pairs (:func:`align_global`, :func:`align_local`, with their
planes under ``keep_planes``, and the simple aligners
:class:`SimpleGlobalAligner`, :class:`SimpleLocalAligner`), a huge global
pair on the row-scan fill with checkpoint-and-replay traceback; and the
scores of one pair without a traceback (:func:`global_end_score` on the
band fill, :func:`local_max_score`); and a global pair wider than one plane
on the column-blocked pipeline (:mod:`.parallel`, the column-block fill);
and the heuristic aligners, pairwise (:func:`heuristic_align`) and a whole
population of starting matrices on the card (:func:`heuristic_align_population`).

``device=None`` means the CUDA card everywhere and raises
:class:`DeviceUnavailable` without one; ``device="cpu"`` asks for the
kernels' plain PyTorch versions.

The package imports ``torch`` and never ``jax``; its framework-free
modules (alphabets, matrices, I/O, oracle, native runtime) are copies of
the JAX package's.
"""

from .alphabet import DNA, Index, Protein, index_coord, rotate_indices
from .errors import (
    AlignerError,
    CalculationError,
    CharIsNotMatchable,
    DeviceUnavailable,
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
from .align import (
    BatchScores,
    PWMAligner,
    SimpleGlobalAligner,
    SimpleLocalAligner,
    align_global,
    align_local,
    align_pwm,
    batch_align,
    batch_align_pwm,
    global_end_score,
    local_max_score,
)
from .heuristic import (
    HeuristicAligner,
    HeuristicPWMAligner,
    Heuristics,
    heuristic_align,
    heuristic_align_population,
    heuristic_align_pwm,
    warmup_population,
)
from . import parallel, repeat  # noqa: E402
from .parallel import sharded_global_align, sharded_global_end_score
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
    "parallel",
    "sharded_global_align",
    "sharded_global_end_score",
    "BatchScores",
    "batch_align",
    "align_global",
    "align_local",
    "global_end_score",
    "local_max_score",
    "align_pwm",
    "batch_align_pwm",
    "PWMAligner",
    "SimpleGlobalAligner",
    "SimpleLocalAligner",
    "Heuristics",
    "HeuristicAligner",
    "heuristic_align",
    "heuristic_align_population",
    "warmup_population",
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
    "DeviceUnavailable",
    "UnnecessaryArgument",
    "MissingArgument",
    "ResultIsEmpty",
    "CalculationError",
    "ValidationError",
    "MatrixShapeError",
    "WrongMatrixSpecified",
]
