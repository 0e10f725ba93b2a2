"""Plain reference of the latent-repeat search on one DNA record, exploring
mode, forward strand: the tasks it keeps and its final PWM, in plain
PyTorch float64 and NumPy, independent of the program.

Written from latent-repeat-search (aligner-core ``src/bin/latent-repeat-search``)
as SURVEY.md §0 item 3 and the program's engine docstring state it:

* the windows (``calc.rs:37-56``, one thread): a window starts at every
  ``offset``-th base, ``j = 0, offset, 2·offset, …`` while ``j`` is below the
  length, and ends at ``j + width + offset``, or at the record's end where
  that reaches it;
* a window's score ``f`` is the PWM local fill's maximum
  (``pwm/mod.rs:44-74``): the plane (window length + 1) × (W + 1), rows the
  window's bases, columns the PWM's positions, cell (y, x) scored
  ``pwm[base y, position x]``; the fill is :func:`reference.fill.local_fill`
  (the anti-diagonal pass of the reference's local mode, its passes repeated
  until the penalties of row 1 agree) with the PWM as its score table,
  indexed by position: each problem's "query" is the positions 0 … W - 1;
* the starting statistics (``calc.rs:19-86``): the windows of a shuffled
  copy of the record, their scores' mean and their standard deviation (the
  square root of the mean squared deviation);
* a cycle (``calc.rs:88-147``): every window of the record scored, a window
  kept where ``z = (f - mean) / σ >= 3``; the kept windows filtered
  (:func:`overlap_filter`); where another cycle follows, the next mean and
  σ from the filtered tasks' scores, σ the variance itself (the reference's
  missing square root, ``calc.rs:197-202``), and the next PWM: the
  filtered tasks' frequency matrices (``alignment.rs:55-65``: the bases
  against the PWM positions that the walk from each window's maximum steps
  diagonally through) summed and transformed (kd 0, r² = del × ext,
  ``calc.rs:156-164, 209-215``); a cycle that keeps no window ends the
  loop, the previous cycle's tasks and PWM standing (``calc.rs:182-219``).

Means are NumPy's (its pairwise sums, in window order and in the filter's
order), as the program computes them; the reference's Rust sums in order,
which can differ in the last bit.

The seeds.  The reference draws its starting PWM and its shuffle from an
unseeded ``thread_rng``; this reference, as the program documents for its
seeded runs, draws them from a generator made from one seed: a per-record
generator from one draw of ``numpy.random.default_rng(seed)``, then the
(4, W) PWM of {-1, 0, 1} from it (``lib.rs:92-96``), transformed with the
record's base frequencies, then the shuffle of the record.

It runs on the card (or any device) in blocks of windows, after the
benchmark's window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fill import BEG, DIAG, LEFT, TOP, local_fill
from .heuristic import transform_matrix

Z = 3.0  # calc.rs:17
BASES = 4
CODES = {ord("A"): 0, ord("T"): 1, ord("C"): 2, ord("G"): 3}  # enums.rs:138-167


@dataclasses.dataclass
class Options:
    width: int  # the PWM's positions, W (-r)
    offset: int  # the window step (-q)
    deletions: float  # del (-d)
    extension: float  # ext (-e)
    repeats: int  # cycles (--repeats)


@dataclasses.dataclass
class Answer:
    tasks: list  # (left, right, z, f) in the filter's order
    matrix: np.ndarray  # (4, W) float64, the final PWM
    scans: int  # the starting scan and each cycle's


def encode(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    """The codes (int8) of a record of the four bases, upper case, and each
    base's share of them."""
    lut = np.full(256, -1, np.int16)
    for ch, code in CODES.items():
        lut[ch] = code
    codes = lut[np.frombuffer(raw, np.uint8)]
    if (codes < 0).any():
        raise ValueError("the reference takes records of A, T, C and G alone")
    codes = codes.astype(np.int8)
    freqs = np.bincount(codes, minlength=BASES).astype(np.float64) / max(len(codes), 1)
    return codes, freqs


def windows(length: int, opts: Options) -> tuple[np.ndarray, np.ndarray]:
    """Each window's first base and its end (exclusive), in order."""
    starts = np.arange(0, length, opts.offset, dtype=np.int64)
    far = starts + opts.width + opts.offset
    return starts, np.where(far >= length, length, far)


def _block(codes, starts, ends, width: int, device):
    """A block of windows as the fill's problems: the bases (B, longest) and
    the lengths, and the PWM's positions as each problem's query."""
    lens = torch.as_tensor(ends - starts, device=device)
    rows = int(lens.max())
    at = torch.as_tensor(starts, device=device)[:, None] + torch.arange(rows, device=device)
    t = codes[at.clamp_(max=len(codes) - 1)]
    q = torch.arange(width, device=device).expand(len(starts), width)
    ql = torch.full((len(starts),), width, dtype=torch.int64, device=device)
    return q, ql, t, lens


def scan(codes, starts, ends, pwm, opts: Options, *, device, dtype=torch.float64,
         block: int = 65_536) -> np.ndarray:
    """Every window's score (float64 on the host), ``block`` windows a fill;
    ``codes`` on ``device`` (int64), ``pwm`` (4, W) on ``device``."""
    out = np.empty(len(starts), np.float64)
    for lo in range(0, len(starts), block):
        hi = min(lo + block, len(starts))
        q, ql, t, tl = _block(codes, starts[lo:hi], ends[lo:hi], opts.width, device)
        r = local_fill(q, ql, t, tl, pwm, opts.deletions, opts.extension, dtype=dtype)
        out[lo:hi] = r.f.double().cpu().numpy()
    return out


def frequencies(codes, starts, ends, pwm, opts: Options, *, device, dtype=torch.float64,
                block: int = 8_192) -> np.ndarray:
    """The summed (4, W) frequency matrix of the windows' alignments: from
    each window's maximum (the first in row-major order) the walk takes a
    top step (a base against no position), a left step (a position against
    no base) or a diagonal step (a base against a position, counted) until a
    Beginning cell (pwm/mod.rs:77-103), all windows of a block a step at a
    time on ``device``."""
    counts = torch.zeros(BASES * opts.width, dtype=torch.int64, device=device)
    for lo in range(0, len(starts), block):
        hi = min(lo + block, len(starts))
        q, ql, t, tl = _block(codes, starts[lo:hi], ends[lo:hi], opts.width, device)
        r = local_fill(q, ql, t, tl, pwm, opts.deletions, opts.extension, dtype=dtype,
                       with_dirs=True)
        bi = torch.arange(hi - lo, device=device)
        cy, cx = r.fy.clone(), r.fx.clone()
        while True:
            d = r.dirs[bi, cy + cx, cy].long()
            alive = d != BEG
            if not bool(alive.any()):
                break
            diag = alive & (d == DIAG)
            base = t[bi, (cy - 1).clamp(min=0)]
            counts += torch.bincount((base * opts.width + cx - 1)[diag],
                                     minlength=BASES * opts.width)
            cy = cy - (alive & (d != LEFT)).long()
            cx = cx - (alive & (d != TOP)).long()
        del r
    return counts.view(BASES, opts.width).double().cpu().numpy()


def intersects(a: tuple, b: tuple) -> bool:
    """engine/mod.rs:104-119: ``a``'s left or right end inside ``b``, or
    ``b`` inside ``a``."""
    return b[0] <= a[0] <= b[1] or b[0] <= a[1] <= b[1] or (b[0] >= a[0] and b[1] <= a[1])


def overlap_filter(tasks: list) -> list:
    """engine/mod.rs:49-102 on (left, right, z, f) tasks: sorted by left
    (stably), a batch is the first task and each next one while it
    intersects that first task; the batch's largest z is kept (the last of
    equal ones); the rest of the list goes on from the first task that broke
    the batch.  Where a batch runs to the list's end, the list goes on from
    its last task, which alone is kept unless a kept task has its left end
    (a task equals another by its left end, task.rs:12-16)."""
    if len(tasks) <= 1:
        return list(tasks)
    rest = sorted(tasks, key=lambda t: t[0])
    out: list = []
    pos = 0
    while True:
        if len(rest) - pos == 1:
            if all(t[0] != rest[pos][0] for t in out):
                out.append(rest[pos])
            return out
        first = rest[pos]
        batch, stop = [first], pos + 1
        while stop < len(rest) and intersects((first[0], first[1]), (rest[stop][0],
                                                                     rest[stop][1])):
            batch.append(rest[stop])
            stop += 1
        best = batch[0]
        for t in batch[1:]:
            if t[2] >= best[2]:
                best = t
        out.append(best)
        pos = min(stop, len(rest) - 1)


def search(raw: bytes, opts: Options, seed: int, *, device, dtype=torch.float64,
           block: int = 65_536) -> Answer:
    """The search of one record ``raw`` (bytes of A, T, C, G) with the
    generator seed ``seed``, its fills in ``dtype`` (float64 is the
    reference's own; a lower one makes a control) on ``device``."""
    codes, freqs = encode(raw)
    gen = np.random.default_rng(int(seed))
    rec = np.random.default_rng(int(gen.integers(0, 2**63)))
    r2 = float(opts.deletions) * float(opts.extension)
    pwm = transform_matrix(rec.integers(-1, 2, size=(BASES, opts.width)).astype(np.float64),
                           0.0, r2, freqs)
    shuffled = codes.copy()
    rec.shuffle(shuffled)
    starts, ends = windows(len(codes), opts)

    def scores(c, m):
        cd = torch.as_tensor(c.astype(np.int64), device=device)
        return scan(cd, starts, ends, torch.as_tensor(m, device=device), opts, device=device,
                    dtype=dtype, block=block)

    fs = scores(shuffled, pwm)
    mean = float(fs.mean())
    sigma = float(np.sqrt(((fs - mean) ** 2).mean()))
    scans, tasks = 1, []
    on_card = torch.as_tensor(codes.astype(np.int64), device=device)
    for i in range(opts.repeats):
        fs = scores(codes, pwm)
        scans += 1
        with np.errstate(divide="ignore", invalid="ignore"):
            z = (fs - mean) / sigma
        keep = np.flatnonzero(z >= Z)
        if keep.size == 0:
            break
        tasks = overlap_filter([(int(starts[k]), int(ends[k]), float(z[k]), float(fs[k]))
                                for k in keep])
        if i < opts.repeats - 1:
            f = np.array([t[3] for t in tasks])
            mean = float(f.mean())
            sigma = float(((f - mean) ** 2).mean())
            left = np.array([t[0] for t in tasks], np.int64)
            right = np.array([t[1] for t in tasks], np.int64)
            counts = frequencies(on_card, left, right, torch.as_tensor(pwm, device=device),
                                 opts, device=device, dtype=dtype)
            pwm = transform_matrix(counts, 0.0, r2, freqs)
    return Answer(tasks, pwm, scans)
