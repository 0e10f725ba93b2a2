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

Default dtype is float32 on CUDA (scores in every reference workload are
small sums of integer matrix entries, exact in f32) and float64 on the
CPU; float64 on CUDA is available on request.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` → :func:`default_device`; anything else as given."""
    if device is None:
        return default_device()
    return torch.device(device)


def default_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
