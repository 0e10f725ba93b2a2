"""Device and dtype defaults.

The port has two places a batched fill can run, both with the exact
reference semantics (SURVEY.md §2.3):

* ``cuda`` — the hand-written CUDA kernels under ``csrc/`` (the
  counterpart of the JAX package's Pallas route on a TPU);
* ``cpu``  — the plain PyTorch versions beside each kernel, vectorised
  over the batch.

A wrapper picks by where its tensors live: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.  ``device=None``
means the card: it resolves to ``cuda`` and raises
:class:`~aligner_tpu_torch.errors.DeviceUnavailable` when no CUDA device
is present.  The plain versions run only for a caller that asks for
``device="cpu"``.

The dtype follows the data (:func:`dtype_for`): float32 on CUDA only when
the matrix (or PWM) and both penalties are integer-valued and no score of
the given lengths can leave the integers f32 holds exactly (below 2^24) —
every score is then a small sum of integers, exact in f32 — and float64
otherwise, which is what the reference computes in (native C++, and the
JAX package on the CPU with x64).  The CPU always runs float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import DeviceUnavailable


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else as given.  A ``cuda`` device
    without a CUDA card raises :class:`DeviceUnavailable`: nothing carries
    on on the CPU unless the caller asked for ``"cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device (NVIDIA GPU) is available to PyTorch; the kernels "
            "need one. Pass device=\"cpu\" (--device cpu) to run the plain "
            "PyTorch versions instead."
        )
    return device


def integral_params(matrix, del_: float, ext: float) -> bool:
    """True when the matrix and both penalties are integer-valued
    (``aligner_tpu.align._integral_params``)."""
    m = np.asarray(matrix)
    return bool(np.all(m == np.round(m)) and float(del_) == int(del_)
                and float(ext) == int(ext))


F32_EXACT = 2**24  # f32 holds every integer up to here


def dtype_for(device, matrix, del_: float, ext: float,
              lengths: tuple[int, int] | None = None) -> torch.dtype:
    """The working dtype of a fill: float32 on CUDA for integral scoring
    (BLOSUM62 with 11/2), float64 for anything else (a PWM from
    ``transform_matrix``: one f32 rounding there can move a window across
    the repeat search's hard z >= 3 threshold).  float64 on the CPU.

    ``lengths`` are the longest rows and columns (R, C) of the fill.  With
    them, integral scoring stays in f32 only while no score can pass 2^24:
    |score| <= max|matrix|·min(R, C) + (R + C + 2)·max(del, ext), the match
    ramp down the diagonal plus the gap ramp along the borders (the bound
    of ``ops.wavefront.range_ok``).  Above that an integer sum would round
    in f32, so the fill takes f64."""
    if torch.device(device).type != "cuda" or not integral_params(matrix, del_, ext):
        return torch.float64
    if lengths is not None:
        R, C = (int(v) for v in lengths)
        peak = float(np.abs(np.asarray(matrix)).max(initial=0))
        if peak * min(R, C) + (R + C + 2) * max(float(del_), float(ext)) > F32_EXACT:
            return torch.float64
    return torch.float32
