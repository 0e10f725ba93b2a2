"""Device meshes and sharded alignment steps.

Counterpart of ``aligner_tpu/parallel/mesh.py`` with PyTorch's idiom:
explicit devices, one launch per shard on its device, ``torch.distributed``
between processes, and no global array.  The reference's concurrency
structures map as there:

* :func:`sharded_scores`: the shuffle fan-out (statistics/mod.rs:253-291)
  and the window-scan threads (engine/calc.rs:45-75), a problem batch
  sharded over the ``data`` axis;
* :func:`window_scan_step`: one scan cycle of the latent-repeat search
  (engine/calc.rs:88-147), the window scores sharded, the mean and variance
  over every active window summed across shards and processes, the z-values
  from them;
* :func:`matrix_population_step`: aligner-web's one job per candidate
  matrix (handlers.rs:238-250) and the promotion of the best subtask
  (queries.rs:74-80): the matrices shard over the ``matrix`` axis, each
  device scores its (data shard x matrix shard) tile, and the best matrix
  of each problem is the max over the ``matrix`` axis;
* :func:`data_slots`: the slots of one axis in global order, with this
  process's neighbours, on which the column-blocked pipeline
  (:mod:`.wavefront_sp`) places its column blocks.

A :class:`Mesh` is a grid of shard slots.  Each slot is one launch on one
device; a device may hold several slots (two shards of one card measure the
sharded path on a one-card machine).  :func:`sharded_scores` and
:func:`window_scan_step` split this process's rows contiguously over all of
its slots (``aligner_tpu_torch.align._fill_sharded``, the auto-shard's own
split; the reference fills a data shard redundantly on its ``matrix``
slots).  Every step launches on every slot before it reads any result
back, so shards on distinct cards run at once, and returns its results on
the mesh's first device.  With a process group (:func:`aligner_tpu_torch.parallel.multihost.global_mesh`)
each process owns whole data shards and passes its own block of the batch
(:func:`~aligner_tpu_torch.parallel.multihost.shard_local_batch`); the steps
return that block's results, and the window statistics are summed across
processes by ``all_reduce``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..align import _fill_sharded
from ..backend import dtype_for
from ..errors import DeviceUnavailable, ValidationError
from ..ops.dp_fill import DPFill, PWMFill


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 2-D grid of shard slots.

    ``grid``: the global (data, matrix) array of slot numbers, process-major
    (slot s is local slot ``s % len(devices)`` of process
    ``s // len(devices)``, as ``jax.devices()`` orders a pod's devices);
    ``devices``: this process's device of each of its slots, in slot order;
    ``group``: the ``torch.distributed`` process group, or None for one
    process; ``process_count``, ``process_index``: the group's size and
    this process's rank in it."""

    axis_names: tuple[str, str]
    grid: np.ndarray
    devices: tuple[torch.device, ...]
    group: object = None
    process_count: int = 1
    process_index: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.grid.shape))

    def local_grid(self) -> list[list[torch.device]]:
        """This process's devices as its (data shards, matrix) block of the
        grid.  A process must own whole data shards, as the reference's
        ``shard_local_batch`` requires (``multihost.py:99-103``)."""
        d, m = self.grid.shape
        n = self.process_count
        if d % n or len(self.devices) * n != d * m:
            raise ValidationError(
                f"mesh axis {self.axis_names[0]!r} ({d} shards of {m} slots) does not "
                f"divide over {n} processes of {len(self.devices)} devices: every process "
                "must own an equal span of whole data shards")
        return [list(self.devices[r * m:(r + 1) * m]) for r in range(d // n)]


def _factor(n: int, local: int | None = None) -> tuple[int, int]:
    """(data, matrix): ``matrix`` is the largest divisor of n at most √n,
    so ``data`` takes the larger factor (``aligner_tpu.parallel.make_mesh``).
    With ``local`` (each process's device count, a divisor of n) ``matrix``
    must divide it too, so that every data shard lies within one process:
    one card a rank gives (n, 1)."""
    local = n if local is None else local
    m = max(c for c in range(1, int(np.sqrt(n)) + 1) if local % c == 0)
    return n // m, m


def _visible_cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device (NVIDIA GPU) is available to PyTorch for the mesh; pass "
            "devices=[...] (for example CPU devices) to build one without a card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axes: tuple[str, str] = ("data", "matrix"),
              *, devices=None) -> Mesh:
    """A 2-D mesh of ``n_devices`` slots for this process alone.

    The slots are the first ``n_devices`` of ``devices`` (taken as given; a
    device may repeat) or, by default, of the visible cards ``cuda:0...``
    (:class:`DeviceUnavailable` without one).  More slots than listed are
    refused, as the reference refuses more devices than are visible.  The
    ``data`` axis gets the larger factor."""
    devs = _visible_cards() if devices is None else [torch.device(d) for d in devices]
    n = len(devs) if n_devices is None else n_devices
    if not 1 <= n <= len(devs):
        raise ValidationError(
            f"make_mesh: {n} devices requested but only {len(devs)} visible")
    return Mesh(tuple(axes), np.arange(n).reshape(_factor(n)), tuple(devs[:n]))


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.int32)


def _rows(mesh: Mesh, B: int, what: str) -> list[list[torch.device]]:
    rows = mesh.local_grid()
    if B % len(rows):
        raise ValidationError(
            f"{what}: {B} rows do not shard evenly over the {len(rows)} "
            f"{mesh.axis_names[0]!r} shards of this process; pad with zero-length problems")
    return rows


def _collective_device(group, device: torch.device) -> torch.device:
    """Where the tensors of a collective over ``group`` live: the CPU under
    gloo (which reduces CUDA tensors for some collectives only; ranks that
    share one card need gloo, since NCCL refuses two ranks on one device),
    ``device`` under NCCL.  The one place partials cross to the CPU."""
    import torch.distributed as dist

    return torch.device("cpu") if dist.get_backend(group) == "gloo" else device


@dataclasses.dataclass(frozen=True)
class DataSlots:
    """The slots of one axis of a mesh in global order, for a pipeline that
    runs one slot a shard of that axis.

    ``devices``: this process's slots, in order; ``first``: the global index
    of the first of them; ``spans``: every process's [lo, hi) of the slots,
    in process order; ``left``, ``right``: the ranks that hold the slots just
    before and just after this process's, or None; ``group``: the mesh's
    process group."""

    devices: tuple[torch.device, ...]
    first: int
    spans: tuple[tuple[int, int], ...]
    left: int | None
    right: int | None
    group: object = None

    @property
    def total(self) -> int:
        return max(hi for _, hi in self.spans)


def data_slots(mesh: Mesh, axis: str | None = None) -> DataSlots:
    """The slots of ``axis`` (by default the mesh's first, ``data``): one a
    shard, the first slot of the shard's row of the grid.  Each process owns
    whole data shards (:meth:`Mesh.local_grid`, which refuses a data axis
    that the processes cannot split), so its slots are a contiguous run and
    its neighbours are the ranks before and after it.  On the other axis
    only the first data shard's row runs, on the process that owns it; the
    reference runs the same program redundantly along ``data``, here those
    slots stay idle."""
    axis = mesh.axis_names[0] if axis is None else axis
    if axis not in mesh.axis_names:
        raise ValidationError(f"the mesh has axes {mesh.axis_names}, not {axis!r}")
    rows = mesh.local_grid()
    n, i = mesh.process_count, mesh.process_index
    if axis == mesh.axis_names[0]:
        spans = tuple((p * len(rows), (p + 1) * len(rows)) for p in range(n))
        devices = [slots[0] for slots in rows]
    else:
        m = mesh.grid.shape[1]
        spans = ((0, m),) + ((m, m),) * (n - 1)
        devices = rows[0] if i == 0 else []
    lo, hi = spans[i]
    left = i - 1 if 0 < lo < hi else None
    right = i + 1 if lo < hi and i + 1 < n and spans[i + 1][0] < spans[i + 1][1] else None
    return DataSlots(tuple(devices), lo, spans, left, right, mesh.group)


def sharded_scores(mesh: Mesh, q, qlen, t, tlen, matrix, del_: float, ext: float, *,
                   mode: str = "local", dtype: torch.dtype | None = None):
    """Scores-only batched fill with the problems sharded over ``data``.

    ``q`` (B, C), ``t`` (B, R) int32 codes and their (B,) lengths, a shared
    (V, V) ``matrix``; B must divide over the data shards (pad with
    zero-length problems).  Each piece launches one fill on its device: K1
    on a card, the plain version on the CPU.  The reference's ``engine``
    argument has no counterpart: the device picks the kernel or the plain
    version.  ``dtype`` defaults to :func:`aligner_tpu_torch.backend.dtype_for`
    of the whole batch.  Returns (fmax, fy, fx, end) in batch order on the
    mesh's first device (this process's block with a process group)."""
    q, qlen, t, tlen = (_i32(a) for a in (q, qlen, t, tlen))
    rows = _rows(mesh, len(q), "sharded_scores")
    dtype = dtype or dtype_for(mesh.devices[0], matrix, del_, ext,
                               lengths=(t.shape[1], q.shape[1]))
    res = _fill_sharded(DPFill, matrix, [q, qlen, t, tlen], del_, ext, dtype,
                        [dev for slots in rows for dev in slots], mesh.devices[0], mode=mode)
    return res.fmax, res.fy, res.fx, res.end


def window_scan_step(mesh: Mesh, windows, wlen, pwm, del_: float, ext: float, *,
                     dtype: torch.dtype | None = None):
    """One repeat-search scan: PWM-align every window, z-score globally.

    ``windows`` (B, L) DNA codes sharded over ``data``, ``wlen`` (B,), a
    shared (4, W) ``pwm``; K3 scores-only on each slot.  Each data shard's
    count of active windows, Σf and Σf² are summed in shard order, then
    across processes (``all_reduce``); with n = max(count, 1) (an
    all-padded launch gives 0/0/0 statistics, not NaN z-values),
    mean = Σf/n, var = Σf²/n - mean², std = √max(var, 0) and
    z = (f - mean)/max(std, tiny), in the fill's dtype, as the reference's
    ``psum`` step computes them.  Returns (scores, z, mean, std) on the
    mesh's first device, mean and std 0-d."""
    windows, wlen = _i32(windows), _i32(wlen)
    pwm = np.asarray(pwm)
    rows = _rows(mesh, len(windows), "window_scan_step")
    dtype = dtype or dtype_for(mesh.devices[0], pwm, del_, ext,
                               lengths=(windows.shape[1], pwm.shape[-1]))
    out = mesh.devices[0]
    scores = _fill_sharded(PWMFill, pwm, [windows, wlen], del_, ext, dtype,
                           [dev for slots in rows for dev in slots], out,
                           track_argmax=False).fmax
    active = (torch.as_tensor(wlen, device=out) > 0).to(dtype)
    per = len(windows) // len(rows)
    sums = torch.zeros(3, dtype=dtype, device=out)
    for r in range(len(rows)):
        f, a = scores[r * per:(r + 1) * per], active[r * per:(r + 1) * per]
        sums += torch.stack([a.sum(), (f * a).sum(), (f * f * a).sum()])
    if mesh.group is not None:
        import torch.distributed as dist

        partial = sums.to(_collective_device(mesh.group, out))
        dist.all_reduce(partial, op=dist.ReduceOp.SUM, group=mesh.group)
        sums = partial.to(out)
    n = sums[0].clamp(min=1.0)
    mean = sums[1] / n
    var = sums[2] / n - mean * mean
    std = var.clamp(min=0.0).sqrt()
    z = (scores - mean) / std.clamp(min=torch.finfo(dtype).tiny)
    return scores, z, mean, std


def matrix_population_step(mesh: Mesh, q, qlen, t, tlen, matrices, del_: float,
                           ext: float, *, dtype: torch.dtype | None = None):
    """Score every (pair, candidate matrix) combination; reduce the best
    matrix of each pair.

    The pairs (``q``, ``t`` and lengths, Bq rows) shard over ``data``, the
    (M, V, V) ``matrices`` over ``matrix``; each slot fills its tile of the
    cross product as one batch with per-problem matrices (K1, scores only),
    takes the max and the first argmax over its matrices, and the best over
    the ``matrix`` axis wins, the smallest global matrix index among ties
    (the reference's ``pmax`` then ``pmin``, fixing the original's ORDER BY
    ASC by taking the max).  Returns (best_f, best_matrix_index) per pair on
    the mesh's first device."""
    q, qlen, t, tlen = (_i32(a) for a in (q, qlen, t, tlen))
    matrices = np.asarray(matrices)
    M = matrices.shape[0]
    m = mesh.grid.shape[1]
    if M % m:
        raise ValidationError(
            f"{M} candidate matrices do not shard evenly over the {m}-device "
            f"{mesh.axis_names[1]!r} axis — pad the population to a multiple "
            "(zero matrices are free)")
    rows = _rows(mesh, len(q), "matrix_population_step")
    dtype = dtype or dtype_for(mesh.devices[0], matrices, del_, ext,
                               lengths=(t.shape[1], q.shape[1]))
    bq = len(q) // len(rows)
    m_local = M // m
    tiles = []
    for r, slots in enumerate(rows):
        pairs = [np.tile(a[r * bq:(r + 1) * bq], (m_local,) + (1,) * (a.ndim - 1))
                 for a in (q, qlen, t, tlen)]
        for c, dev in enumerate(slots):
            mats = np.repeat(matrices[c * m_local:(c + 1) * m_local], bq, axis=0)
            dp = DPFill.from_numpy(mats, del_, ext, device=dev, dtype=dtype)
            tiles.append((r, c, dp(*(torch.as_tensor(a, device=dev) for a in pairs),
                                   mode="local", track_argmax=False).fmax))
    out = mesh.devices[0]
    best, win = [], []
    for r in range(len(rows)):
        f = torch.stack([tile.to(out).reshape(m_local, bq) for rr, _, tile in tiles
                         if rr == r])  # (m, m_local, bq)
        local_best = f.amax(dim=1)
        local_arg = f.argmax(dim=1)  # the first maximum, as jnp.argmax
        global_idx = torch.arange(m, device=out)[:, None] * m_local + local_arg
        b = local_best.max(dim=0).values
        cand = torch.where(local_best == b, global_idx, M)
        best.append(b)
        win.append(cand.min(dim=0).values.to(torch.int32))
    return torch.cat(best), torch.cat(win)
