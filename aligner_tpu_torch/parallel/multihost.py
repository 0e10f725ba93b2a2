"""Multi-process runtime on ``torch.distributed``.

Counterpart of ``aligner_tpu/parallel/multihost.py``.  The reference scales
out with Kafka consumers on separate machines; the JAX package runs one
process per host in one mesh.  Here one process runs per card (or several
processes share a card), all in one ``torch.distributed`` process group;
each process feeds its own block of a batch to the mesh steps
(:mod:`aligner_tpu_torch.parallel.mesh`), which sum the window statistics
across processes with ``all_reduce``, and a :class:`BatchLayout` gathers the
per-process results back into the batch's order.

Environment contract (the JAX package's, ``deploy/aligner.env``):

* ``ALIGNER_COORDINATOR``: ``host:port`` of process 0 (the TCP rendezvous);
* ``ALIGNER_PROCESS_ID``: this process's rank;
* ``ALIGNER_NUM_PROCESSES``: the process count (absent or 1: one process,
  nothing to initialise).

The backend: NCCL for processes with a card each (make each process see
its own card, e.g. with ``CUDA_VISIBLE_DEVICES``); gloo for processes on
the CPU and for ranks that share one card, which NCCL refuses ("Duplicate
GPU detected").  The reference's auto-detection of a Cloud TPU pod slice
from its environment markers has no counterpart on a GPU host and is left
out.

Divergence from the reference (its known fault at ``multihost.py:75-130``):
there ``shard_local_batch`` returns an uneven batch as per-process blocks
each padded at its end, and its callers must re-derive where each row went
(process i's row g at ``i*per_pad + (g - lo_i)``).  Here
:func:`shard_local_batch` returns the block together with its
:class:`BatchLayout`, whose :meth:`BatchLayout.gather` returns the
per-process results in the original row order with the padding dropped.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..errors import ValidationError
from .mesh import Mesh, _collective_device, _factor, _visible_cards


def initialize_from_env(backend: str | None = None) -> None:
    """``torch.distributed.init_process_group`` from the ALIGNER_* contract:
    rank ``ALIGNER_PROCESS_ID`` of ``ALIGNER_NUM_PROCESSES``, rendezvous at
    ``tcp://ALIGNER_COORDINATOR``.  Does nothing when
    ``ALIGNER_NUM_PROCESSES`` is absent or 1.  ``backend`` defaults to
    ``"nccl"`` where the process sees a card and ``"gloo"`` on the CPU;
    ranks sharing one card must name ``"gloo"``.  A rank that cannot reach
    its peers fails here (the rendezvous' own timeout)."""
    n = int(os.environ.get("ALIGNER_NUM_PROCESSES", "1"))
    if n <= 1:
        return
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['ALIGNER_COORDINATOR']}",
        rank=int(os.environ["ALIGNER_PROCESS_ID"]), world_size=n)


def _world() -> tuple[int, int]:
    """(process count, this process's index) of the default group, (1, 0)
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(axes: tuple[str, str] = ("data", "matrix"), devices=None) -> Mesh:
    """The mesh over every process's local devices with the default group
    (every process passes the same number of ``devices``; by default its
    visible cards).  Without an initialised group it is this process's
    mesh alone.  The grid is factored as :func:`make_mesh` factors it, with
    ``matrix`` a divisor of the local device count, so that every data
    shard lies within one process: one card a rank gives (ranks, 1).  (The
    reference's global arrays let a data shard span processes; here each
    process fills only its own block.)"""
    import torch.distributed as dist

    devs = _visible_cards() if devices is None else [torch.device(d) for d in devices]
    n_proc, rank = _world()
    n = n_proc * len(devs)
    group = dist.group.WORLD if n_proc > 1 else None
    return Mesh(tuple(axes), np.arange(n).reshape(_factor(n, len(devs))), tuple(devs),
                group, n_proc, rank)


def process_span(total: int) -> tuple[int, int]:
    """This process's contiguous [lo, hi) share of a global batch (a
    ceil-div share: the last processes may get fewer rows, or none)."""
    n, i = _world()
    per = -(-total // n)
    return min(i * per, total), min((i + 1) * per, total)


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """Where each process's rows of a global batch lie.

    ``spans``: each process's [lo, hi) of the global rows (process order);
    ``per_pad``: the rows of every process's block, its real rows first and
    zero-length padding after them (a multiple of its data shards);
    ``global_rows``: the batch's row count; ``group``: the process group
    (None for one process)."""

    spans: tuple[tuple[int, int], ...]
    per_pad: int
    global_rows: int
    group: object = None

    def gather(self, local) -> torch.Tensor:
        """The global result from each process's ``local`` result (its
        ``per_pad`` rows, in block order): ``all_gather`` across the group,
        then each process's real rows in process order, which is the
        original row order.  Every process gets the whole result, on the
        device of its ``local``."""
        local = torch.as_tensor(local)
        if len(local) != self.per_pad:
            raise ValidationError(
                f"a block of {len(local)} rows, the layout's blocks have {self.per_pad}")
        if self.group is None:
            lo, hi = self.spans[0]
            return local[:hi - lo]
        import torch.distributed as dist

        x = local.to(_collective_device(self.group, local.device)).contiguous()
        blocks = [torch.empty_like(x) for _ in self.spans]
        dist.all_gather(blocks, x, group=self.group)
        return torch.cat([b[:hi - lo] for b, (lo, hi) in zip(blocks, self.spans)]
                         ).to(local.device)


def shard_local_batch(mesh: Mesh, local_rows, global_rows: int | None = None):
    """This process's block of a global batch, with its layout.

    ``local_rows``: this process's rows (numpy or a tensor), exactly its
    :func:`process_span` share of ``global_rows`` (default: every process
    passes as many rows as this one).  The block is padded at its end with
    zero rows (zero lengths: inactive problems) to ``per_pad`` rows, the
    ceil-div share rounded up to a multiple of the process's data shards,
    so the mesh steps can take it.  Returns ``(block, BatchLayout)``."""
    n_proc, i = mesh.process_count, mesh.process_index
    shards = len(mesh.local_grid())
    if global_rows is None:
        global_rows = len(local_rows) * n_proc
    per = -(-global_rows // n_proc)
    per_pad = -(-per // shards) * shards
    spans = tuple((min(k * per, global_rows), min((k + 1) * per, global_rows))
                  for k in range(n_proc))
    lo, hi = spans[i]
    if len(local_rows) != hi - lo:
        raise ValidationError(
            f"local batch has {len(local_rows)} rows but this process's share of "
            f"{global_rows} is [{lo}, {hi}) (process_span)")
    pad = per_pad - len(local_rows)
    if isinstance(local_rows, torch.Tensor):
        block = torch.cat([local_rows, local_rows.new_zeros((pad, *local_rows.shape[1:]))])
    else:
        local_rows = np.asarray(local_rows)
        block = np.concatenate(
            [local_rows, np.zeros((pad, *local_rows.shape[1:]), local_rows.dtype)])
    return block, BatchLayout(spans, per_pad, global_rows, mesh.group)
