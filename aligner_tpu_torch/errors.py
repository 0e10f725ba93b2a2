"""Error hierarchy of the framework.

Mirrors the reference's error enums (aligner-core/src/lib.rs:47-59,
aligner-helpers/src/lib.rs:11-16) as Python exceptions.
"""


class AlignerError(Exception):
    """Base class for all aligner-tpu errors."""


class CharIsNotMatchable(AlignerError):
    """A character cannot be encoded in the requested alphabet."""


class UnnecessaryArgument(AlignerError):
    """An argument was supplied that this aligner does not accept."""


class MissingArgument(AlignerError):
    """A required argument (e.g. heuristics params) was not supplied."""


class ResultIsEmpty(AlignerError):
    """An operation produced no result."""


class CalculationError(AlignerError):
    """A numerical routine failed to produce a finite answer."""


class ValidationError(AlignerError):
    """Inputs failed validation (shape/length mismatch, bad FASTA, ...)."""


class MatrixShapeError(AlignerError):
    """A scoring matrix has the wrong shape for the requested aligner."""


class WrongMatrixSpecified(AlignerError):
    """transform_matrix could not project the matrix (no real roots)."""


class DeviceUnavailable(AlignerError):
    """The requested device (the CUDA card, by default) is not present."""


def is_data_error(exc: BaseException) -> bool:
    """True for an error that a job's own inputs raise, so that running it
    again raises it again: an :class:`AlignerError` other than
    :class:`DeviceUnavailable`, a ``ValueError`` or a ``TypeError``.  The
    service drops such a job or row; anything else (no card, a failed
    kernel build, a CUDA error) is the machine's, and is never taken for
    the job's."""
    return (isinstance(exc, (AlignerError, ValueError, TypeError))
            and not isinstance(exc, DeviceUnavailable))
