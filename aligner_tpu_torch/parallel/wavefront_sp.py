"""The column-blocked pipeline for one huge global pair, on one card or
across the cards and processes of a mesh.

Counterpart of ``aligner_tpu/parallel/wavefront_sp.py``.  The pair's
columns are cut into blocks (at most :data:`CB_COLS` wide) and its target's
rows into row blocks; every (row block, column block) is one fill, and the
only coupling between a column block and its right neighbour is that
neighbour's streamed left boundary, the right column of the block before
it.  It is also the only route by which a pair wider than
``ops.wavefront.MAX_WIDTH`` columns is aligned at all: no fill, replay tile
or direction plane is ever wider than one column block.

Placement.  With ``n_blocks`` (or ``None``) every block runs on one device,
in row-major order.  With a :class:`~aligner_tpu_torch.parallel.mesh.Mesh`
the blocks are the same ones (at least one a slot of the pipeline's axis)
and each slot of the mesh's ``data`` axis (:func:`~aligner_tpu_torch.parallel.mesh.data_slots`)
owns a contiguous run of them, as the reference shards the query's columns
over its mesh.  Each process walks its slots in a host loop, row block by
row block, launching every block before it reads any result; after a row
block a slot hands the right column of its last block to the next slot: a
copy to that slot's device (nothing on the same device) within a process,
``isend``/``irecv`` between processes.  So slot d fills row block j while
slot d + 1 fills row block j - 1, the reference's pipeline of ``ppermute``
steps.  Every launch is the one a single device would make for the same
block, so the results and the launch counts equal the one-device route's.
The end score reaches every process by one ``all_reduce``; with a
traceback the trace records are gathered to every process, which then
replays and walks the same traceback on its first slot's device.

Three block engines, by the reference's names (``engine``):

* ``"pallas"``, the row-scan engine: the column-block fill
  (:func:`ops.wavefront.run_block_cs`, ``csrc/wavefront_block.cu``) fills
  each block from its streamed left boundary;
* ``"band"``, the forward speed path: the band fill
  (:func:`ops.wavefront.run_block_band`, ``csrc/wavefront_band.cu``) fills
  each block by anti-diagonal steps, with the row above kept per column
  block in hat coordinates and the left boundary streamed
  (:func:`ops.wavefront.band_streams`, :func:`ops.wavefront.band_handoff`;
  :func:`band_grid` runs it on any grid); it returns only a
  block's last row, so with a traceback a band is at most ``tb_rows`` tall
  and divides it, and int8 matrices only;
* ``"lax"``, the engine for any integral matrix: in the reference the
  portable ``lax.cummax`` fill of XLA, with no Pallas kernel behind it.
  Here it is the column-block fill itself, whose (V, V) table is int32:
  the reference's int8 limit on the row-scan engine belongs to its packed
  score bytes, which the port does not carry over.  A matrix with an entry
  beyond int8 turns ``"pallas"`` and ``"band"`` into ``"lax"``, as in the
  reference (the switch is reported in the call's ``info`` and the
  package's log), and the magnitude guard
  (:func:`ops.wavefront.range_ok` with the matrix's largest entry) refuses
  a pair whose scores could leave the int32-exact range, where the
  reference bounds every matrix with 127 and so wraps.

The replay of every engine is the column-block fill with directions and the
replay walk (the reference's ``replay_engine``).  Arithmetic is int32 and
bit-equal to the float64 oracle whatever the engine.  An engine name
outside :data:`ENGINES` raises, where the reference's ``else`` branch
silently runs its lax fill.  With neither ``engine`` nor ``tr`` named, on
the card, :func:`auto_shard_config` picks the engine and the height of a
block from the two engines' rates on the H100, as the reference picks from
its accelerator's; on the CPU the row-scan engine's plain version runs.

Exact alignments, not just end scores: the forward fill also records, on
the device, one H row every ``tb_rows`` rows (``ckpts``) and every left
boundary a column block consumed (``lb_hist``), O(R·n + R·C/tb) ints and
no O(R·C) plane.  The traceback then replays one (``tb_rows`` x column
block) tile at a time with directions and walks it on the device; the
replayed tile is the identical DP restricted to that tile, so the walk
follows the directions a full-plane traceback would.  The loop over the
tiles the cursor crosses is a host loop that reads the cursor once a tile.

The reference's ``ALIGNER_DEVICE_WALK=0`` host walk is ``walk="host"``
here (the variable is not read): each crossed tile is replayed on the
column-block fill as before, and its words are walked on the host.

Not carried over: ``shard_map``, the device-wide column block (a block is
at most :data:`CB_COLS` wide whatever the mesh, so a replay tile stays at
1 GiB of words); the one-dispatch ``lax.while_loop`` replay (it exists for
the reference's per-dispatch round trip); the packed score words, the
nibble and byte tables of the band engine and the VMEM budgets of the
replay.

Cites: simple/mod.rs:42-144 (fill, borders), simple/mod.rs:99-127
(traceback semantics).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..backend import integral_params, resolve_device
from ..errors import ValidationError
from ..observability import PAIR_ENGINES, count, log, span
from ..ops import wavefront as wf
from .mesh import Mesh, _collective_device, data_slots

# The width of one column block, the rows of one replay tile (the checkpoint
# cadence) and the most rows of one forward block.  Chosen by sweeps of
# pairs of 262,144 x 262,144 and 524,288 x 524,288 on an H100, recorded in
# PERF.md §6 (Findings): a larger block means
# fewer launches for the same cells and more tiles in each, so the forward
# fill runs a column block in pieces of up to FORWARD_ROWS rows and the
# kernel writes the checkpoint rows inside the call (each doubling of the
# rows buys less: 32,768 rows to 131,072 takes 46 % off the forward fill of
# the larger pair, 262,144 to 524,288 another 9 %; at 262,144 rows a block
# can still be held against its plain version in two minutes); a replay tile of
# 32,768 x 131,072 keeps its words at 1 GiB, and a wider one gains less in
# the forward fill than it loses in the replay.
CB_COLS = 131072
TB_ROWS = wf.TB_ROWS
FORWARD_ROWS = 262144
ENGINES = (None, "pallas", "band", "lax")

# The two block engines' rates on one H100, for auto_shard_config.  A block
# of tr rows by cb columns takes about NS x (cb + L x tr) ns on either fill:
# its rows enter L column-steps apart (a strip of the row-scan fill starts
# its chunk a lag behind the strip above, a row group of the band fill a lag
# behind the group above), and the last rows then cross the block's cb
# columns.  So a block fills tr·cb / (NS·(cb + L·tr)) cells a ns (GCUPS).
# Either engine is rated at the height it runs: the row-scan engine's
# forward block is FORWARD_ROWS rows, or the whole target when that is
# shorter.  Fitted by least squares on 1 / rate to calibration points
# measured on the card (the band engine's forward by band height at
# CB_COLS-wide blocks and at two other widths; the column-block fill's by
# column width at FORWARD_ROWS rows and by height at CB_COLS columns):
# PERF.md §6, the tables of the column-blocked engines, their rows
# "calibration points" and "the model's largest error" (band: 6.6 %; row
# scan: 21.7 % at its one-block point, 262,144 columns, and 3.4 %
# elsewhere), on an NVIDIA H100 80GB HBM3, 700.00 W.
_BAND_NS_PER_COLUMN = 41.45
_BAND_COLUMNS_PER_ROW = 5.093
_ROWSCAN_NS_PER_COLUMN = 138.59
_ROWSCAN_COLUMNS_PER_ROW = 1.317


def band_rate_model(tr: int, cb: int) -> float:
    """Modelled GCUPS of the band engine at band height ``tr`` and column
    block width ``cb`` on one H100."""
    return tr * cb / (_BAND_NS_PER_COLUMN * (cb + _BAND_COLUMNS_PER_ROW * tr))


def rowscan_rate_model(cb: int, tr: int = FORWARD_ROWS) -> float:
    """Modelled GCUPS of the row-scan engine at column block width ``cb``
    on one H100, in forward blocks of ``tr`` rows."""
    return tr * cb / (_ROWSCAN_NS_PER_COLUMN * (cb + _ROWSCAN_COLUMNS_PER_ROW * tr))


def auto_shard_config(qlen: int, tlen: int, n: int, *, max_band_tr: int = wf.BAND_ROWS,
                      slots: int = 1) -> tuple[str, int, float]:
    """Pick ``(engine, tr, modeled_gcups_per_chip)`` for the pipeline:
    the row-scan engine at a forward block height (a replay tile, doubling
    up to :data:`FORWARD_ROWS`; rated at the padded target where that is
    shorter, as the block is clamped to it), or the band engine at the band
    height, from 512 rows doubling up to ``max_band_tr`` (a traceback passes
    its replay tile's rows) and the padded target, that models fastest.
    ``n`` is the column blocks: a block is the query over ``n``, rounded up
    to 128 columns.  ``slots`` is the slots the blocks are placed on: each
    rate is multiplied by the pipeline's fill factor J / (J + slots - 1),
    J the row blocks at that height, as the reference multiplies it by
    J / (J + n - 1) over its n devices; on one slot the blocks run one
    after another, nothing waits for a pipeline to fill, the factor is 1
    and the row-scan engine's tallest block models fastest."""
    cb = max(wf._cdiv(wf._cdiv(qlen, n), 128) * 128, 128)
    r128 = max(wf._cdiv(tlen, 128) * 128, 128)

    def fill(tr: int) -> float:
        j = wf._cdiv(tlen, tr)
        return j / (j + slots - 1)

    best = None
    tr = TB_ROWS
    while tr <= FORWARD_ROWS:
        e = rowscan_rate_model(cb, min(tr, r128)) * fill(tr)
        if best is None or e >= best[2]:  # the taller block on a tie
            best = ("pallas", tr, e)
        tr *= 2
    tr = 512
    while tr <= min(max_band_tr, r128):
        e = band_rate_model(tr, cb) * fill(tr)
        if e > best[2]:
            best = ("band", tr, e)
        tr *= 2
    return best


def _pick_engine(engine, tr, on_card: bool, qlen: int, tlen: int, n: int, tb_rows,
                 peak: float, slots: int = 1):
    """``(engine, tr)`` that run (``aligner_tpu/parallel/wavefront_sp.py:161-179``):
    with neither named, :func:`auto_shard_config`'s pick on the card (for
    ``n`` column blocks on ``slots`` slots), with the band height capped at
    ``tb_rows`` for a traceback, and the row-scan engine elsewhere; then
    ``"lax"`` for ``"pallas"`` or ``"band"`` when the matrix's largest entry
    ``peak`` is beyond int8."""
    named = engine
    if engine is None:
        engine = "pallas"
        if tr is None and on_card:  # the reference picks only on its own chip
            engine, tr, _ = auto_shard_config(
                qlen, tlen, n, max_band_tr=wf.BAND_ROWS if tb_rows is None else tb_rows,
                slots=slots)
    if engine in ("pallas", "band") and peak > 127:
        engine = "lax"  # the block engine for any integral matrix, as in the reference
    if engine != named:
        log.info("column-blocked pair %dx%d: engine %s (%s)", tlen, qlen, engine,
                 "matrix entries beyond int8" if engine == "lax" else "auto_shard_config")
    return engine, tr


def _prep_sharded(mesh_or_n_blocks, q, t, matrix, del_, ext, tr, tb_rows, engine, device,
                  axis=None):
    """Shared operand prep and validation of the two entry points
    (``tb_rows`` is None for an end score).  ``pp["engine"]`` is the engine
    that runs: the one named, the pick of :func:`auto_shard_config`, or
    ``"lax"`` for a matrix beyond int8.  ``pp["layout"]`` places the column
    blocks (:func:`_layout`); ``pp["device"]`` is the device that walks (the
    process's first slot), ``pp["ops"]`` the operands on each device."""
    mesh = mesh_or_n_blocks if isinstance(mesh_or_n_blocks, Mesh) else None
    if len(q) == 0 or len(t) == 0:
        raise ValueError("empty sequence")
    if engine not in ENGINES:
        raise ValidationError(
            f"unknown engine {engine!r} of the column-blocked wavefront (choose None, "
            "\"pallas\", \"band\" or \"lax\")")
    # validate before any per-element conversion: refusing an oversized
    # pair must not be preceded by a giant int32 copy
    matrix = np.asarray(matrix)
    if not integral_params(matrix, del_, ext):
        raise ValidationError("the column-blocked wavefront requires an integral "
                              "matrix and integral penalties")
    peak = wf.max_entry(matrix)
    if not wf.range_ok(len(q), len(t), del_, ext, peak):
        raise ValidationError("the column-blocked wavefront: scores would exceed the "
                              "int32-exact range (see ops.wavefront.range_ok)")
    C_real, R_real = len(q), len(t)
    slots = None
    if mesh is None:
        if axis is not None:
            raise ValidationError(f"axis {axis!r} names an axis of a mesh; pass a Mesh")
        n_blocks = mesh_or_n_blocks
        if n_blocks is not None and n_blocks < 1:
            raise ValueError("need n_blocks >= 1")
        cb = CB_COLS if n_blocks is None else wf._cdiv(C_real, int(n_blocks))
    else:
        if device is not None:
            raise ValidationError("a mesh places the column blocks on its own devices; "
                                  f"pass no device (got {device!r})")
        slots = data_slots(mesh, axis)
        # the one-device route's blocks, at least one a slot
        cb = min(CB_COLS, wf._cdiv(C_real, slots.total))
        device = slots.devices[0] if slots.devices else mesh.devices[0]
    Cb = min(wf._cdiv(cb, wf.COL_PAD), wf._cdiv(C_real, wf.COL_PAD)) * wf.COL_PAD
    n = wf._cdiv(C_real, Cb)  # column blocks wholly past the query are not run
    device = resolve_device(device)
    layout = _layout(n, slots, device)
    engine, tr = _pick_engine(engine, tr, device.type == "cuda", C_real, R_real, n,
                              tb_rows, peak, slots=layout.active)
    # clamp the blocks to the (word-aligned) target length so wide-short
    # pairs do not fill and replay mostly padding
    r_pad = wf._cdiv(R_real, wf.ROWS_PER_WORD) * wf.ROWS_PER_WORD
    tb = None
    if engine == "band":
        # a band's rows are whole row groups of the band walk: a multiple
        # of 128 as in the reference, clamped to the padded target
        lanes = wf.LANES
        tr = wf.BAND_ROWS if tr is None else tr
        tr = max(lanes, min(wf._cdiv(tr, lanes), wf._cdiv(R_real, lanes)) * lanes)
        if tb_rows is not None:
            tb = min(tb_rows, r_pad)
            wf._check_tr(tb)
            # the band returns only its last row: every checkpoint row ends
            # a band, so a band is at most a replay tile and divides it
            if tr > tb:
                tr = max(lanes, tb // lanes * lanes)
            tb = max(tb // tr, 1) * tr
    elif tb_rows is None:
        tr = min(FORWARD_ROWS if tr is None else tr, r_pad)
        wf._check_tr(tr)
    else:
        tb = min(tb_rows, r_pad)
        wf._check_tr(tb)
        tr = min(FORWARD_ROWS if tr is None else tr, wf._cdiv(R_real, tb) * tb)
        wf._check_tr(tr)
        # a forward block is whole replay tiles, or a replay tile whole
        # forward blocks: every checkpoint row is the last row of a kernel tile
        if tr >= tb:
            tr = tr // tb * tb
        else:
            tb = tb // tr * tr
    # the padded rows are whole forward blocks and whole replay tiles
    unit = max(tr, tb or 0)
    J = wf._cdiv(R_real, unit) * (unit // tr)
    q = np.asarray(q, np.int32)
    t = np.asarray(t, np.int32)
    V = matrix.shape[0]
    for name, a in (("query", q), ("target", t)):
        if int(a.min()) < 0 or int(a.max()) >= V:
            raise ValueError(f"{name} codes must lie in the {V}-symbol scoring alphabet")
    qp = np.zeros(n * Cb, np.int32)  # padded columns score as symbol 0; never read
    qp[:C_real] = q
    tp = np.zeros(J * tr, np.int32)
    tp[:R_real] = t
    mi = np.round(matrix).astype(np.int32)
    ops = {}
    for dev in (device, *(d for d, _ in layout.slots)):
        if dev not in ops:
            ops[dev] = tuple(torch.as_tensor(a, device=dev) for a in (qp, tp, mi))
    q_dev, t_dev, m_dev = ops[device]
    return {
        "q": q, "t": t, "V": V, "C_real": C_real, "R_real": R_real, "Cb": Cb, "n": n,
        "C_pad": n * Cb, "tr": tr, "tb": tb, "J": J, "R_pad": J * tr, "engine": engine,
        "del": int(del_), "ext": int(ext), "device": device, "layout": layout, "ops": ops,
        "q_dev": q_dev, "t_dev": t_dev, "m_dev": m_dev,
    }


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where the column blocks run.  ``slots``: this process's slots, each
    ``(device, range of its blocks)``, in order; ``first``: the global index
    of the first; ``active``: the slots that own blocks (the first ones; the
    rest have only padding and take no part in the hand-offs); ``blocks``:
    every process's [lo, hi) of the blocks, in process order; ``left``,
    ``right``, ``group``: as :class:`~aligner_tpu_torch.parallel.mesh.DataSlots`
    gives them, or None for one process."""

    slots: tuple[tuple[torch.device, range], ...]
    first: int = 0
    active: int = 1
    blocks: tuple[tuple[int, int], ...] = ()
    left: int | None = None
    right: int | None = None
    group: object = None


def _layout(n: int, slots, device) -> _Layout:
    """``n`` column blocks on ``device`` alone (``slots`` None), or on the
    slots of :func:`~aligner_tpu_torch.parallel.mesh.data_slots`, each a
    contiguous run, the first ``n mod slots`` one block longer."""
    if slots is None:
        return _Layout(((device, range(n)),), blocks=((0, n),))
    base, extra = divmod(n, slots.total)

    def start(g: int) -> int:
        return g * base + min(g, extra)

    return _Layout(
        tuple((dev, range(start(g), start(g + 1)))
              for g, dev in enumerate(slots.devices, slots.first)),
        slots.first, min(n, slots.total),
        tuple((start(lo), start(hi)) for lo, hi in slots.spans),
        slots.left, slots.right, slots.group)


class _Handoffs:
    """The right boundaries handed on between the slots of one forward fill,
    TR int32 a row block.  Within this process the boundary is copied to
    the next slot's device (nothing on the same device) without a wait;
    between processes it goes by ``isend``/``irecv`` on the collective
    device (:func:`~aligner_tpu_torch.parallel.mesh._collective_device`:
    the CPU under gloo, the card under NCCL).  The next row block's receive
    is posted as soon as the last one arrives, and a send is never waited on
    before the end of the fill, so no process blocks on its own send.
    ``count`` is the boundaries received, ``wait_s`` the seconds spent
    waiting for those of another process."""

    def __init__(self, pp):
        self.lay, self.tr, self.J = pp["layout"], pp["tr"], pp["J"]
        lay = self.lay
        self.coll = (None if lay.group is None
                     else _collective_device(lay.group, pp["device"]))
        self.held = None  # the previous local slot's boundary, this row block
        self.sends = []  # (work, buffer): a buffer lives until its send is done
        self.count, self.wait_s = 0, 0.0
        self.recv = self._post() if lay.left is not None and lay.first < lay.active else None

    def _post(self):
        import torch.distributed as dist

        buf = torch.empty(self.tr, dtype=torch.int32, device=self.coll)
        return dist.irecv(buf, src=self.lay.left, group=self.lay.group), buf

    def take(self, k: int, j: int, dev):
        """The boundary left of local slot ``k``'s first block in row block
        ``j``, on ``dev``; None for the pipeline's first slot, whose left
        boundary is the border column."""
        if self.lay.first + k == 0:
            return None
        self.count += 1
        if k > 0:
            x, self.held = self.held, None
        else:
            work, x = self.recv
            t0 = time.perf_counter()
            work.wait()  # a peer that fails makes this raise
            self.wait_s += time.perf_counter() - t0
            self.recv = self._post() if j + 1 < self.J else None
        return x.to(dev, non_blocking=True)

    def give(self, k: int, right) -> None:
        """Hand local slot ``k``'s right boundary on to the next slot."""
        if self.lay.first + k + 1 >= self.lay.active:
            return
        if k + 1 < len(self.lay.slots):
            self.held = right
            return
        import torch.distributed as dist

        x = right.to(self.coll)
        self.sends.append((dist.isend(x, dst=self.lay.right, group=self.lay.group), x))

    def finish(self) -> None:
        for work, _ in self.sends:
            work.wait()
        self.sends.clear()


def _border_row(pp, x0: int, width: int, device=None):
    """H[0, x0 + 1 … x0 + width] with the far-corner overwrite
    (simple/mod.rs:59-70), on ``device`` (by default the walking one)."""
    x = x0 + torch.arange(1, width + 1, dtype=torch.int32, device=device or pp["device"])
    C, d = pp["C_real"], pp["del"]
    return torch.where(x == C, -(C + 1) * d, -x * d).to(torch.int32)


def _border_col(pp, y0: int, height: int, device=None):
    """H[y0 + 1 … y0 + height, 0] with the far-corner overwrite."""
    y = y0 + torch.arange(1, height + 1, dtype=torch.int32, device=device or pp["device"])
    R, d = pp["R_real"], pp["del"]
    return torch.where(y == R, -(R + 1) * d, -y * d).to(torch.int32)


def _corner(pp, x0: int, device=None):
    """H[0, x0] as a (1,) tensor: a border-row value, in closed form for
    every column block."""
    C, d = pp["C_real"], pp["del"]
    return torch.full((1,), -(C + 1) * d if x0 == C else -x0 * d, dtype=torch.int32,
                      device=device or pp["device"])


def _block(pp, d: int, t_rows, h_prev, lb, y_base: int, *, with_dirs: bool = False,
           ckpt_every: int = 0, device=None):
    """Column block ``d`` of the rows ``t_rows`` on the column-block fill,
    in the wrapper's strip height: the largest that divides the rows and
    the cadence; on ``device``'s operands (by default the walking one's)."""
    Cb = pp["Cb"]
    q_dev, _, m_dev = pp["ops"][device or pp["device"]]
    return wf.run_block_cs(q_dev[d * Cb:(d + 1) * Cb], t_rows, m_dev, h_prev,
                           lb, d * Cb, y_base, pp["C_real"], pp["R_real"], del_=pp["del"],
                           ext=pp["ext"], with_dirs=with_dirs, ckpt_every=ckpt_every,
                           check_codes=False)


def _forward(pp, with_trace: bool, trace=None, block=None, **block_kw):
    """The forward fill: every (row block, column block) in row-major order
    on this process's slots, scores only, on the engine ``pp["engine"]``,
    the right boundaries handed on between slots (:class:`_Handoffs`).
    Returns ``end`` (1,) on the walking device, the same on every process,
    or with ``with_trace`` ``(end, lb_hist (n, R_pad), ckpts (R_pad / TB,
    C_pad))`` with ``lb_hist[d, y - 1] = H[y, d·Cb]`` and ``ckpts[k] =
    H[(k + 1)·TB]``, gathered from every slot to every process (:func:`_gather`).
    Nothing comes back to the host in between, except the boundaries and
    records that cross processes under gloo.  ``pp["stats"]`` receives the
    hand-offs and the gather.

    The row-scan engines (``"pallas"``, ``"lax"``) keep per column block the
    row above, H[y_base, x0 + 1 …], and fill each block from it and its
    streamed left boundary; the band engine
    (``aligner_tpu/parallel/wavefront_sp.py:365-460``) keeps the row above
    in hat coordinates, slot k = H[y_base, x0 + k + 1] + k·ext, over
    D = Cb + tr - 1 slots, and fills a band a block; its right column is
    handed on the same way, and the de-hatted last row of a band that ends a
    replay tile is that tile's checkpoint row.  ``trace`` (a list) receives
    every band's ``(args, kwargs, outputs)``; ``block`` is the fill of one
    band (:func:`ops.wavefront.run_block_band`, counted as the pipeline's
    launch; or another fill with its arguments, such as its plain version),
    called with ``block_kw`` besides ``Cb``, ``ext`` and ``with_rc``."""
    lay, band = pp["layout"], pp["engine"] == "band"
    Cb, tr, J, TB = pp["Cb"], pp["tr"], pp["J"], pp["tb"]
    C_real, R_real, V = pp["C_real"], pp["R_real"], pp["V"]
    del_, ext = pp["del"], pp["ext"]
    D = Cb + tr - 1
    prev, last_bound, qs, khat, recs = {}, {}, {}, {}, []
    end = None
    for dev, blocks in lay.slots:
        i32 = dict(dtype=torch.int32, device=dev)
        if band:
            dvec = torch.arange(1, D + 1, **i32)
            khat[dev] = (dvec - 1) * ext  # the hat offset of slot k
        for d in blocks:
            # the corner of a block's first row: H[0, x0], then the boundary
            # value of the last row of the block above
            last_bound[d] = _corner(pp, d * Cb, dev)
            if not band:
                prev[d] = _border_row(pp, d * Cb, Cb, dev)
                continue
            # the block's query codes, then the padding code V, which scores 0
            codes = np.full(D, V, np.int32)
            part = pp["q"][d * Cb:(d + 1) * Cb]
            codes[:len(part)] = part
            qs[d] = torch.as_tensor(codes, device=dev)
            xg = d * Cb + dvec  # the border row H[0, x] of the block's columns
            prev[d] = (torch.where(xg == C_real, -(C_real + 1) * del_, -xg * del_)
                       + khat[dev]).to(torch.int32)
        if with_trace:
            recs.append((torch.empty((len(blocks), pp["R_pad"]), **i32),
                         torch.empty((pp["R_pad"] // TB, len(blocks) * Cb), **i32)))
    kw = dict(Cb=Cb, ext=ext, with_rc=True, **block_kw)
    if block is None and band:
        block = wf.run_block_band
        kw.update(check_codes=False, blocked=True)
    links = _Handoffs(pp)
    for j in range(J):
        y_base = j * tr
        j_end = R_real - 1 - y_base
        # the checkpoint rows of this row block: one every TB rows inside
        # it, or its last row when that ends a replay tile
        every = ck_at = 0
        if with_trace and not band:
            every = TB if tr >= TB else tr if (y_base + tr) % TB == 0 else 0
        if with_trace and band and (y_base + tr) % TB == 0:
            ck_at = (y_base + tr) // TB
        for k, (dev, blocks) in enumerate(lay.slots):
            if not blocks:
                continue
            t_rows = pp["ops"][dev][1][y_base:y_base + tr]
            bl_cur = links.take(k, j, dev)
            if bl_cur is None:
                bl_cur = _border_col(pp, y_base, tr, dev)
            for i, d in enumerate(blocks):
                lb = torch.cat([last_bound[d], bl_cur])
                last_bound[d] = bl_cur[-1:]
                if with_trace:
                    recs[k][0][i, y_base:y_base + tr] = bl_cur
                if not band:
                    prev[d], bl_cur, endv, _, ck = _block(pp, d, t_rows, prev[d], lb, y_base,
                                                          ckpt_every=every, device=dev)
                    # the block that holds the end cell (its value may be 0)
                    if (d * Cb < C_real <= (d + 1) * Cb
                            and y_base < R_real <= y_base + tr):
                        end = endv
                    if every:
                        k0 = y_base // TB
                        recs[k][1][k0:k0 + ck.shape[0], i * Cb:(i + 1) * Cb] = ck
                    continue
                # cell (1,1), the only cell whose penalty is del, lies in block (0, 0)
                streams = wf.band_streams(prev[d], lb, ext, del_ - ext if j == d == 0 else 0)
                x_loc = C_real - d * Cb
                owned = 0 <= j_end < tr and 1 <= x_loc <= Cb
                args = (t_rows, qs[d], *streams, pp["ops"][dev][2],
                        (j_end, x_loc + j_end, owned))
                out = block(*args, **kw)
                if trace is not None:
                    trace.append((args, kw, out))
                prev[d] = wf.band_handoff(out[0], tr, ext)
                bl_cur = out[1]
                if owned:
                    end = out[2]
                if ck_at:
                    recs[k][1][ck_at - 1, i * Cb:(i + 1) * Cb] = (prev[d][:Cb]
                                                                 - khat[dev][:Cb])
            links.give(k, bl_cur)
    links.finish()
    pp["stats"] = dict(handoffs=links.count, handoff_wait_s=links.wait_s, gather_bytes=0,
                       gather_s=0.0)
    end = _reduce_end(pp, end)
    if not with_trace:
        return end
    with span("pair.gather"):
        return (end, *_gather(pp, recs))


def _reduce_end(pp, end):
    """The end score (1,) on the walking device: the value of the block that
    holds the end cell, summed over the processes (``all_reduce``; the
    owner's value and zero elsewhere), as the reference ``psum``s it."""
    lay, dev = pp["layout"], pp["device"]
    end = torch.zeros(1, dtype=torch.int32, device=dev) if end is None else end.to(dev)
    if lay.group is None:
        return end
    import torch.distributed as dist

    x = end.to(_collective_device(lay.group, dev)).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=lay.group)
    return x.to(dev)


def _gather(pp, recs):
    """``(lb_hist, ckpts)`` of every column block on the walking device,
    from each local slot's ``(lb (k, R_pad), ck (R_pad / TB, k·Cb))``: copied
    there from the other slots' devices, then with a process group
    ``all_gather``ed (each process's part padded to the most blocks a process
    owns) in the blocks' order, as the reference's ``replicate_trace`` does.
    Records the bytes that came from another device or process and the
    seconds in ``pp["stats"]``."""
    from ..observability import counters

    lay, dev = pp["layout"], pp["device"]
    Cb, nck = pp["Cb"], pp["R_pad"] // pp["tb"]
    t0 = time.perf_counter()
    moved = sum(lb.nbytes + ck.nbytes for (d, _), (lb, ck) in zip(lay.slots, recs)
                if d != dev)
    if len(recs) == 1 and lay.slots[0][0] == dev:
        lb_hist, ckpts = recs[0]
    else:
        lb_hist = torch.cat([lb.to(dev) for lb, _ in recs]) if recs else torch.empty(
            (0, pp["R_pad"]), dtype=torch.int32, device=dev)
        ckpts = torch.cat([ck.to(dev) for _, ck in recs], dim=1) if recs else torch.empty(
            (nck, 0), dtype=torch.int32, device=dev)
    if lay.group is not None:
        import torch.distributed as dist

        coll = _collective_device(lay.group, dev)
        counts = [hi - lo for lo, hi in lay.blocks]
        K = max(counts)
        x = torch.zeros((K, pp["R_pad"]), dtype=torch.int32, device=coll)
        x[:len(lb_hist)] = lb_hist
        y = torch.zeros((nck, K * Cb), dtype=torch.int32, device=coll)
        y[:, :ckpts.shape[1]] = ckpts
        xs, ys = [torch.empty_like(x) for _ in counts], [torch.empty_like(y) for _ in counts]
        dist.all_gather(xs, x, group=lay.group)
        dist.all_gather(ys, y, group=lay.group)
        moved += (x.nbytes + y.nbytes) * (len(counts) - 1)
        lb_hist = torch.cat([a[:c] for a, c in zip(xs, counts)]).to(dev)
        ckpts = torch.cat([a[:, :c * Cb] for a, c in zip(ys, counts)], dim=1).to(dev)
    if moved:
        seconds = time.perf_counter() - t0
        pp["stats"].update(gather_bytes=moved, gather_s=seconds)
        counters.record(f"{dev.type}/wavefront-sp-gather", moved, 1, seconds)
    return lb_hist, ckpts


def band_grid(q, t, matrix, del_: float, ext: float, *, tb: int, cb: int, device,
              block=None, **block_kw):
    """The band engine's forward fill (:func:`_forward`) on a grid of
    blocks of ``tb`` rows by ``cb`` columns on one device, any ``cb``, an
    int8 matrix: every block takes the row its upper neighbour returned and,
    as a *streamed* left boundary, the right column its left neighbour
    returned.  It holds the block contract of the band fill at x0 > 0
    against a full plane (``block`` and ``block_kw`` as for
    :func:`_forward`).  Returns ``(end, rights, bottoms)``: the end score
    (1,), per column block the plain column H[1 … R_pad, x0 + cb], and per
    band and column block the plain row H[y_base + tb, x0 + 1 … x0 + cb]."""
    pp = wf._prep(q, t, matrix, del_, ext, device, wide=True)
    C_real, R_real = pp["C_real"], pp["R_real"]
    n, J = wf._cdiv(C_real, cb), wf._cdiv(R_real, tb)
    t_dev = torch.as_tensor(wf._pad_rows(pp["t"], tb), device=pp["device"])
    pp.update(Cb=cb, n=n, tr=tb, tb=tb, J=J, R_pad=J * tb, C_pad=n * cb, engine="band",
              t_dev=t_dev, layout=_layout(n, None, pp["device"]),
              ops={pp["device"]: (pp["q_dev"], t_dev, pp["m_dev"])})
    trace = []
    end = _forward(pp, False, trace, block, **block_kw)
    khat = torch.arange(cb, dtype=torch.int32, device=pp["device"]) * pp["ext"]
    rights = [torch.cat([out[1] for _, _, out in trace[d::n]]) for d in range(n)]
    bottoms = [[wf.band_handoff(out[0], tb, pp["ext"])[:cb] - khat
                for _, _, out in trace[j * n:(j + 1) * n]] for j in range(J)]
    return end, rights, bottoms


def sharded_global_end_score(mesh_or_n_blocks, q, t, matrix, del_: float, ext: float, *,
                             tr: int | None = None, engine: str | None = None,
                             device=None, axis: str | None = None) -> float:
    """Exact global end score H[tlen, qlen] of one pair, its columns cut
    into blocks.

    ``mesh_or_n_blocks`` is a :class:`~aligner_tpu_torch.parallel.mesh.Mesh`,
    as the reference takes one, or the number of column blocks for one
    device.  On a mesh the blocks are :data:`CB_COLS` wide at most, at
    least one a slot of the pipeline's axis (``axis``, by default the
    mesh's ``data`` axis, one slot a shard: the first of the shard's row;
    the reference's ``shard_map`` runs the same program redundantly along
    the other axis, here those slots stay idle), each slot a contiguous run
    of them, the right boundaries handed on from slot to slot and process
    to process; ``device`` must then be None (the mesh names its devices),
    and every process of the mesh's group calls with the same pair and
    returns the same score.  A data axis that the processes cannot split
    raises :class:`ValidationError`; a peer that fails makes the call
    raise.  With an integer each block is the query's length over it,
    rounded up to ``ops.wavefront.COL_PAD`` columns (blocks wholly past the
    query are not run), on ``device``; with ``None`` a block is
    :data:`CB_COLS` wide.  ``tr`` is the rows of one forward block (a
    multiple of 16, clamped to the padded target; by default the whole
    target up to :data:`FORWARD_ROWS`; the band engine rounds it up to a
    multiple of 128, by default :data:`ops.wavefront.BAND_ROWS`).  Requires
    an integral matrix and integral penalties, with scores in the
    int32-exact range for the matrix's largest entry.  ``engine``:
    ``"pallas"`` (the column-block row-scan fill), ``"band"`` (the band
    fill) or ``"lax"`` (the column-block fill for any integral matrix); a
    matrix beyond int8 runs on ``"lax"`` whatever is named.  ``None`` with
    ``tr`` ``None`` on the card takes :func:`auto_shard_config`'s pick for
    the slots the blocks are placed on, else ``"pallas"``.  The call waits
    for the device once, for the score.
    """
    from ..observability import counters

    pp = _prep_sharded(mesh_or_n_blocks, q, t, matrix, del_, ext, tr, None, engine, device,
                       axis)
    _count_blocks(pp)
    t0 = time.perf_counter()
    with span("pair.forward", launches=_launches(pp)):
        score = float(_forward(pp, with_trace=False).item())  # the call's one wait
    counters.record(f"{pp['device'].type}/wavefront-sp", pp["R_real"] * pp["C_real"], 1,
                    time.perf_counter() - t0)
    _record_handoffs(pp)
    return score


def _count_blocks(pp) -> None:
    """The pair's blocks and engine, on the caller's ``pair`` span."""
    count(row_blocks=pp["J"], col_blocks=pp["n"], engine=PAIR_ENGINES.index(pp["engine"]))


def _launches(pp) -> int:
    """The forward fill's launches in this process: one a block a row block."""
    return pp["J"] * sum(len(blocks) for _, blocks in pp["layout"].slots)


def _record_handoffs(pp) -> None:
    """The call's hand-offs (received) and the seconds spent waiting for
    them, in the counter ``<device>/wavefront-sp-handoff`` (its cells are
    the hand-offs), when there were any."""
    from ..observability import counters

    st = pp["stats"]
    if st["handoffs"]:
        counters.record(f"{pp['device'].type}/wavefront-sp-handoff", st["handoffs"], 1,
                        st["handoff_wait_s"])


def _tile_inputs(pp, lb_hist, ckpts, j: int, d: int):
    """``(h0, lb)`` of replay tile (j, d) from the forward fill's records."""
    Cb, TB = pp["Cb"], pp["tb"]
    x0 = d * Cb
    if j == 0:
        h0, lb0 = _border_row(pp, x0, Cb), _corner(pp, x0)
    else:
        h0 = ckpts[j - 1, x0:x0 + Cb].contiguous()
        lb0 = lb_hist[d, j * TB - 1:j * TB]
    return h0, torch.cat([lb0, lb_hist[d, j * TB:(j + 1) * TB]])


def _forward_traced(pp):
    """The forward fill with its records, timed (every local slot's device
    synchronised) and counted; returns ``(end, lb_hist, ckpts, seconds)``."""
    from ..observability import measure

    t0 = time.perf_counter()
    devices = [pp["device"], *(d for d, _ in pp["layout"].slots)]
    with span("pair.forward", launches=_launches(pp)), measure(
            f"{pp['device'].type}/wavefront-sp", pp["R_real"] * pp["C_real"], 1,
            device=devices):
        out = _forward(pp, with_trace=True)
    _record_handoffs(pp)
    return (*out, time.perf_counter() - t0)


def _sharded_walk(pp):
    """The device part of :func:`sharded_global_align`: the forward fill
    with its records, then the loop over the replay tiles the cursor
    crosses, on the walking device.  Returns the end score tensor, the
    records, the finished cursor and step stream (all on the device) and a
    record of the call: the engine, blocks, tiles and waits, the forward's
    and the replay's seconds, the hand-offs received and the seconds spent
    waiting for them, and the bytes and seconds of the records' gather
    (the forward's seconds include both)."""
    from ..observability import counters

    dev, Cb = pp["device"], pp["Cb"]
    C_real, R_real = pp["C_real"], pp["R_real"]
    TB = pp["tb"]
    end, lb_hist, ckpts, forward_s = _forward_traced(pp)
    t1 = time.perf_counter()
    syncs = 1
    state, steps = wf.new_walk(R_real, C_real, pp["R_pad"] + pp["C_pad"] + 1, dev)
    cy, cx, n, tiles = R_real, C_real, 0, 0
    words = None
    with span("pair.replay") as replay:
        while cy > 0 and cx > 0:
            del words  # one tile's words at a time
            j, d = (cy - 1) // TB, (cx - 1) // Cb
            h0, lb = _tile_inputs(pp, lb_hist, ckpts, j, d)
            words = _block(pp, d, pp["t_dev"][j * TB:(j + 1) * TB], h0, lb, j * TB,
                           with_dirs=True)[3]
            with span("pair.walk") as walk:
                wf.replay_walk(words, state, steps, row_base=j * TB, col_base=d * Cb)
                n0 = n
                cy, cx, n = (int(v) for v in state.cpu())  # the tile's one wait
                walk.count(steps=n - n0)
            syncs += 1
            tiles += 1
        replay.count(tiles=tiles, cells=tiles * TB * Cb)
    t2 = time.perf_counter()
    counters.record(f"{dev.type}/wavefront-sp-replay", tiles * TB * Cb, 1, t2 - t1)
    info = dict(engine=pp["engine"], tiles=tiles, tr=pp["tr"], tb_rows=TB,
                forward_blocks=pp["J"] * pp["n"], syncs=syncs, forward_s=forward_s,
                replay_s=t2 - t1, **pp["stats"])
    return end, lb_hist, ckpts, state, steps, info


def _sharded_walk_host(pp):
    """The host walk of :func:`sharded_global_align`
    (``aligner_tpu/parallel/wavefront_sp.py:906-990``): the same forward
    fill and records, then each tile the cursor enters replayed with
    directions on the column-block fill, its words brought to the host and
    walked there (:func:`ops.wavefront.walk_block_host`).  No walk kernel
    is launched.  Returns the end score tensor and the walk's codes and
    last cell."""
    from ..observability import counters

    dev, Cb, TB = pp["device"], pp["Cb"], pp["tb"]
    end, lb_hist, ckpts, _ = _forward_traced(pp)
    t1 = time.perf_counter()
    cy, cx, codes, tiles = pp["R_real"], pp["C_real"], [], 0
    with span("pair.replay") as replay:
        while cy > 0 and cx > 0:
            j, d = (cy - 1) // TB, (cx - 1) // Cb
            h0, lb = _tile_inputs(pp, lb_hist, ckpts, j, d)
            words = _block(pp, d, pp["t_dev"][j * TB:(j + 1) * TB], h0, lb, j * TB,
                           with_dirs=True)[3]
            with span("pair.walk") as walk:
                w = words.cpu().numpy()  # one tile's words at a time
                del words
                c, y, x = wf.walk_block_host(w, cy - j * TB, cx - d * Cb)
                walk.count(steps=len(c))
            codes += c
            cy, cx = j * TB + y, d * Cb + x
            tiles += 1
        replay.count(tiles=tiles, cells=tiles * TB * Cb)
    counters.record(f"{dev.type}/wavefront-sp-replay", tiles * TB * Cb, 1,
                    time.perf_counter() - t1)
    return end, cy, cx, codes


def sharded_global_align(mesh_or_n_blocks, q, t, matrix, del_: float, ext: float, *,
                         tr: int | None = None, tb_rows: int = TB_ROWS,
                         engine: str | None = None, device=None, walk: str = "device",
                         axis: str | None = None):
    """Exact global ALIGNMENT of one huge pair, its columns cut into blocks
    on a mesh or on ``device``: checkpoint-and-replay traceback on top of
    the forward fill of :func:`sharded_global_end_score` (same
    ``mesh_or_n_blocks``, ``tr``, ``engine``, ``device``, ``axis``).

    Returns ``(end_score, qa, ta, coords)`` with the reference's traceback
    semantics (seeded last characters, simple/mod.rs:99-127), bit-equal to
    the oracle and the single-plane paths.  ``tb_rows`` is the checkpoint
    cadence and the rows of one replay tile (rounded down to a multiple of
    ``tr`` when that is the smaller; by default ``tr`` is as for the end
    score, rounded down to whole replay tiles: the kernel writes the
    checkpoint rows inside a call, so a forward block may hold many; a band
    of the band engine is at most a replay tile and divides it, and the
    pick caps its height at ``tb_rows``).  Every engine replays on the
    column-block fill with directions.
    Forward extra memory is O(R·n + R·C/tb_rows) ints; on a mesh these
    records are gathered to every process, which replays and walks the same
    traceback on its first slot's device and returns the same alignment.
    The traceback replays one (tb_rows x column block) tile per tile the
    path crosses and reads the cursor after each.  ``walk="host"`` walks
    each replayed tile on the host instead (:func:`_sharded_walk_host`),
    with the same result.
    """
    if walk not in ("device", "host"):
        raise ValueError(f"walk must be device or host, got {walk!r}")
    pp = _prep_sharded(mesh_or_n_blocks, q, t, matrix, del_, ext, tr, tb_rows, engine,
                       device, axis)
    _count_blocks(pp)
    if walk == "host":
        end, cy, cx, codes = _sharded_walk_host(pp)
        with span("pair.decode"):
            qa, ta, coords = wf._assemble_codes(pp, cy, cx, codes)
    else:
        end, _, _, state, steps, _ = _sharded_walk(pp)
        with span("pair.decode"):
            qa, ta, coords = wf._assemble(pp, state, steps)
    return float(end.item()), qa, ta, coords
