"""Device and dtype defaults.

The port has two places a batched fill can run, both with the exact
reference semantics (SURVEY.md §2.3):

* ``cuda`` — the hand-written CUDA kernels under ``csrc/`` (the
  counterpart of the JAX package's Pallas route on a TPU);
* ``cpu``  — the plain PyTorch versions beside each kernel, vectorised
  over the batch.

A wrapper picks by where its tensors live: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.  ``device=None``
resolves to ``cuda`` when a card is present, mirroring
``aligner_tpu.backend.pick_backend``, which picks pallas on a TPU.

The dtype follows the data (:func:`dtype_for`): float32 on CUDA only when
the matrix (or PWM) and both penalties are integer-valued — every score
is then a small sum of integers, exact in f32 — and float64 otherwise,
which is what the reference computes in (native C++, and the JAX package
on the CPU with x64).  The CPU always runs float64.
"""

from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` → :func:`default_device`; anything else as given."""
    if device is None:
        return default_device()
    return torch.device(device)


def integral_params(matrix, del_: float, ext: float) -> bool:
    """True when the matrix and both penalties are integer-valued
    (``aligner_tpu.align._integral_params``)."""
    m = np.asarray(matrix)
    return bool(np.all(m == np.round(m)) and float(del_) == int(del_)
                and float(ext) == int(ext))


def dtype_for(device, matrix, del_: float, ext: float) -> torch.dtype:
    """The working dtype of a fill: float32 on CUDA for integral scoring
    (BLOSUM62 with 11/2), float64 for anything else (a PWM from
    ``transform_matrix``: one f32 rounding there can move a window across
    the repeat search's hard z >= 3 threshold).  float64 on the CPU."""
    if torch.device(device).type == "cuda" and integral_params(matrix, del_, ext):
        return torch.float32
    return torch.float64
