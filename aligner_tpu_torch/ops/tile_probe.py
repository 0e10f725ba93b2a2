"""The strip walk of the row-scan and column-block fills
(``csrc/wavefront_tile.cuh``) timed on one card against an earlier build of
the same fills, in turns, at the shapes the paths give them, each result
held ``torch.equal`` to the other build's.

    python -m aligner_tpu_torch.ops.tile_probe [--against DIR] [--out DIR]
        [--reps N] [--tiles K:TR,...] [--warps W,...] [--spare F,...]
        [--variants NAME,...] [--shapes NAME,...]

``--against DIR``: a directory holding an earlier ``wavefront.cu``,
``wavefront_block.cu`` and ``wavefront_tile.cuh`` (for example from ``git
show <commit>:aligner_tpu_torch/csrc/<file>``) whose entry points take the
per-anti-diagonal launcher's arguments: a scratch column ``hcol`` (n_tr,
TR + 1) in place of the counters, and no grid.  They are compiled with the
shipped flags into a library of their own under ``--out``.  Without it only
the shipped kernel runs.

The shapes: the row-scan fill (K5) forward over the 65,536 x 65,536 pair
with a checkpoint row every 32,768 rows and its last 32,768-row replay
block with directions; the column-block fill (K7) on the last forward
block of the 524,288 x 524,288 pair (262,144 rows by 131,072 columns from
column 393,216, a checkpoint row every 32,768 rows) and on its last replay
tile (32,768 x 131,072 with directions), from the records of that pair's
forward fill.  The order is earlier, shipped, shipped, earlier; then the
shipped kernel with other strip shapes (``--tiles``, columns a lane and
strip rows), warps a block (``--warps``) and caps on the grid
(``--spare``, :data:`~aligner_tpu_torch.ops.wavefront.STRIP_SPARE`), and the
variants of the source named in ``VARIANTS`` (text replaced in
``wavefront_tile.cuh``; every source of ``csrc`` built again, one nvcc a
source, all at once, and loaded in place of the shipped library), each
held equal too.  Prints one line a run and writes them, with the card's
name and power limit, to ``DIR/tile_probe.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..matrices import blosum62
from . import _build
from . import wavefront as wf

_OUT = os.path.join(os.path.dirname(_build._OUT_DIR), "tile_probe")
PAIR, WIDE, SEED = 65_536, 524_288, 11
_HEADERS: dict[str, str] = {}  # --header NAME=PATH

# name -> [(text of wavefront_tile.cuh, its replacement)]
VARIANTS = {
    # a tight poll, without the back-off
    "no-sleep": [("        __nanosleep(sleep);\n", "")],
    # the row handed down by plain (weak) stores
    "weak-hand-store": [("store_relaxed(a.hand + xl + k, tagged(h[k], i + 1));",
                         "a.hand[xl + k] = tagged(h[k], i + 1);")],
    # the step loop unrolled, so that a step's loads can overlap the step before
    "unroll-2": [("            for (int s = base; s < s_end; ++s) {",
                  "#pragma unroll 2\n            for (int s = base; s < s_end; ++s) {")],
    # the maxima by Hopper's DPX add-max
    "dpx": [("const int hv = max(max(dg + m0[qk[k]], vt), left + np);",
             "const int hv = __viaddmax_s32(left, np, __viaddmax_s32(dg, m0[qk[k]], vt));"),
            ("const int hv = max(max(dg + m1[qk[k]], vt), left + next);",
             "const int hv = __viaddmax_s32(left, next, __viaddmax_s32(dg, m1[qk[k]], vt));")],
}


def variant_header(name: str) -> str:
    """``wavefront_tile.cuh`` with variant ``name``'s replacements (or the
    file of a ``--header NAME=PATH``); raises ``ValueError`` where an anchor
    is not in the header exactly once."""
    if name in _HEADERS:
        with open(_HEADERS[name]) as fh:
            return fh.read()
    with open(os.path.join(_build._CSRC, "wavefront_tile.cuh")) as fh:
        src = fh.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: its anchor {old[:60]!r} occurs "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def build_variants(names, out_dir: str, source=variant_header,
                   file: str = "wavefront_tile.cuh") -> dict[str, ctypes.CDLL]:
    """Each named variant of the sources as a library bound like the
    shipped one: ``source(name)`` in place of ``csrc/<file>``, every other
    source as shipped."""
    nvcc = _build._nvcc()
    jobs = []
    for name in names:
        src = source(name)
        d = os.path.join(out_dir, "variants", name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(_build._CSRC):
            if f.endswith((".cu", ".cuh")):
                with open(os.path.join(_build._CSRC, f)) as fh:
                    text = fh.read()
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(src if f == file else text)
        objs = []
        for f in sorted(os.listdir(d)):
            if f.endswith(".cu"):
                obj = os.path.join(d, f + ".o")
                cmd = [nvcc, *_build.FLAGS, "-c", "-o", obj, os.path.join(d, f)]
                objs.append(obj)
                jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
        jobs.append((name, objs))
    libs = {}
    pending = []
    for job in jobs:
        if isinstance(job[0], str):
            _build._run_nvcc(pending)
            pending = []
            name, objs = job
            so = os.path.join(out_dir, "variants", name, "kernels.so")
            cmd = [nvcc, *_build.FLAGS, "-shared", "-o", so, *objs]
            _build._run_nvcc([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))])
            lib = ctypes.CDLL(so)
            _build._bind(lib)
            libs[name] = lib
        else:
            pending.append(job)
    return libs


def build_earlier(src_dir: str, out_dir: str) -> ctypes.CDLL:
    """The earlier fills of ``src_dir`` as a library of their own, one nvcc
    a source, both at once."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for name in ("wavefront.cu", "wavefront_block.cu"):
        obj = os.path.join(out_dir, f"earlier_{name}.o")
        cmd = [nvcc, *_build.FLAGS, "-c", "-o", obj, os.path.join(src_dir, name)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    _build._run_nvcc(procs)
    so = os.path.join(out_dir, "earlier_wavefront.so")
    cmd = [nvcc, *_build.FLAGS, "-shared", "-o", so, *objs]
    _build._run_nvcc([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))])
    lib = ctypes.CDLL(so)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wavefront_row_scan_launch.argtypes = [p, p, p, i32, p, p, p, *[i32] * 9,
                                              p, p, p, i32, p]
    lib.wavefront_row_scan_launch.restype = i32
    lib.wavefront_block_cs_launch.argtypes = [p, p, p, i32, p, p, p, p, p, *[i32] * 10,
                                              p, p, p, i32, p]
    lib.wavefront_block_cs_launch.restype = i32
    return lib


def _ptr(a):
    return None if a is None else a.data_ptr()


def earlier_row_scan(lib, q, t, m, h0, y_offset, C_real, R_real, with_dirs, ckpt_every,
                     TR=64, K=4):
    """``row_scan``'s outputs from the earlier build: one launch an
    anti-diagonal of tiles."""
    dev = q.device
    C_pad, R_pad = q.numel(), t.numel()
    n_tr, n_tc = R_pad // TR, C_pad // (32 * K)
    i32 = dict(dtype=torch.int32, device=dev)
    end, hrow = torch.zeros(1, **i32), torch.empty(C_pad, **i32)
    hcol = torch.empty((n_tr, TR + 1), **i32)
    words = torch.empty((R_pad // 16, C_pad), **i32) if with_dirs else None
    ckpts = torch.empty((R_pad // ckpt_every, C_pad), **i32) if ckpt_every else None
    err = lib.wavefront_row_scan_launch(
        _ptr(q), _ptr(t), _ptr(m), m.shape[0], _ptr(h0) if y_offset else None, _ptr(hrow),
        _ptr(hcol), y_offset, C_real, R_real, 11, 2, K, TR, n_tr, n_tc, _ptr(end),
        _ptr(words), _ptr(ckpts), ckpt_every, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"earlier row scan: CUDA error {err}")
    return end, words, ckpts


def earlier_block_cs(lib, q, t, m, h_prev, lbound, x0, y_base, C_real, R_real, with_dirs,
                     ckpt_every, TR=64, K=4):
    """``run_block_cs``'s outputs from the earlier build."""
    dev = q.device
    Cb, rows = q.numel(), t.numel()
    n_tr, n_tc = rows // TR, Cb // (32 * K)
    i32 = dict(dtype=torch.int32, device=dev)
    end, h_new, rights = (torch.zeros(1, **i32), torch.empty(Cb, **i32),
                          torch.empty(rows, **i32))
    hcol = torch.empty((n_tr, TR + 1), **i32)
    words = torch.empty((rows // 16, Cb), **i32) if with_dirs else None
    ckpts = torch.empty((rows // ckpt_every, Cb), **i32) if ckpt_every else None
    err = lib.wavefront_block_cs_launch(
        _ptr(q), _ptr(t), _ptr(m), m.shape[0], _ptr(h_prev), _ptr(lbound), _ptr(h_new),
        _ptr(hcol), _ptr(rights), x0, y_base, C_real, R_real, 11, 2, K, TR, n_tr, n_tc,
        _ptr(end), _ptr(words), _ptr(ckpts), ckpt_every,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"earlier column block: CUDA error {err}")
    return h_new, rights, end, words, ckpts


def gpu_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _pair(seed, n):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, n).astype(np.int8)
    t = q.copy()
    mask = rng.random(n) < 0.25
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    return q, t


def shapes(dev):
    """name -> (fill, args, keywords, the real rows and columns to hold),
    ``fill`` "scan" or "block"."""
    from ..parallel import wavefront_sp as sp

    m = np.array(blosum62())
    out = {}
    q, t = _pair(SEED, PAIR)
    pp = wf._prep(q, t, m, 11, 2, dev)
    TB = wf.TB_ROWS
    t_dev = torch.as_tensor(wf._pad_rows(pp["t"], TB), device=dev)
    fwd = wf.row_scan(pp["q_dev"], t_dev, pp["m_dev"], 11, 2, None, 0, PAIR, PAIR,
                      with_dirs=False, ckpt_every=TB)
    args = (pp["q_dev"], t_dev, pp["m_dev"], None, 0, PAIR, PAIR)
    out["k5-forward"] = ("scan", args, dict(with_dirs=False, ckpt_every=TB), PAIR, PAIR)
    j = (PAIR - 1) // TB
    args = (pp["q_dev"], t_dev[j * TB:(j + 1) * TB], pp["m_dev"], fwd[2][j - 1], j * TB,
            PAIR, PAIR)
    out["k5-replay-block"] = ("scan", args, dict(with_dirs=True, ckpt_every=0),
                              PAIR - j * TB, PAIR)
    q, t = _pair(SEED + 5, WIDE)
    pp = sp._prep_sharded(None, q, t, m, 11, 2, None, sp.TB_ROWS, None, dev)
    _, lb_hist, ckpts = sp._forward(pp, True)
    d, Cb, TB, tr = pp["n"] - 1, pp["Cb"], pp["tb"], pp["tr"]
    y0 = (pp["J"] - 1) * tr
    args = (pp["q_dev"][d * Cb:], pp["t_dev"][y0:], pp["m_dev"],
            ckpts[y0 // TB - 1, d * Cb:].contiguous(), lb_hist[d, y0 - 1:].contiguous(),
            d * Cb, y0, WIDE, WIDE)
    out["k7-forward-block"] = ("block", args, dict(with_dirs=False, ckpt_every=TB),
                               WIDE - y0, WIDE - d * Cb)
    jt = pp["R_pad"] // TB - 1
    h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, jt, d)
    args = (pp["q_dev"][d * Cb:(d + 1) * Cb], pp["t_dev"][jt * TB:(jt + 1) * TB],
            pp["m_dev"], h0, lb, d * Cb, jt * TB, WIDE, WIDE)
    out["k7-replay-tile"] = ("block", args, dict(with_dirs=True, ckpt_every=0),
                             WIDE - jt * TB, WIDE - d * Cb)
    return out


def _same(a, b, rows, cols, fill):
    """Equal on the real rows and columns: the scan's (end, words, ckpts),
    the block's (h_new, rights, end, words, ckpts)."""
    if fill == "block":
        if not (torch.equal(a[0][:cols], b[0][:cols]) and torch.equal(a[1][:rows], b[1][:rows])):
            return False
        a, b = a[2:], b[2:]
    ok = torch.equal(a[0], b[0])
    if a[1] is not None:
        full = rows // 16
        ok = ok and torch.equal(a[1][:full, :cols], b[1][:full, :cols])
        if rows % 16:
            mask = (1 << (2 * (rows % 16))) - 1
            ok = ok and torch.equal(a[1][full, :cols] & mask, b[1][full, :cols] & mask)
    if a[2] is not None:
        ok = ok and torch.equal(a[2][:, :cols], b[2][:, :cols])
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=_OUT)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiles", default="",
                    help="strip shapes of the shipped kernel, K:TR,... (e.g. 2:64,8:128)")
    ap.add_argument("--warps", default="", help="warps a block of the shipped kernel, W,...")
    ap.add_argument("--spare", default="", help="caps on the grid, STRIP_SPARE values F,...")
    ap.add_argument("--variants", default="", help="names in VARIANTS")
    ap.add_argument("--header", action="append", default=[],
                    help="NAME=PATH: a whole other wavefront_tile.cuh, timed as a variant")
    ap.add_argument("--shapes", default="", help="names of shapes, all by default")
    ap.add_argument("--strips", default="",
                    help="N,...: the row-scan fill of N strips x 65,536 columns, scores "
                         "only, for the time of a strip and the lag between strips")
    args_ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.makedirs(args_ns.out, exist_ok=True)
    earlier = build_earlier(args_ns.against, args_ns.out) if args_ns.against else None
    for spec in args_ns.header:
        name, path = spec.split("=", 1)
        _HEADERS[name] = path
    variants = build_variants(list(filter(None, args_ns.variants.split(","))) + list(_HEADERS),
                              args_ns.out)
    shipped_lib = _build.load()
    all_shapes = shapes(dev)
    names = args_ns.shapes.split(",") if args_ns.shapes else list(all_shapes)
    records = []

    def shipped(fill, a, kw, K=wf.COLS_PER_THREAD, TR=None):
        if fill == "scan":
            q, t, m, h0, y, C, R = a
            return lambda: wf.row_scan(q, t, m, 11, 2, h0, y, C, R, tile_rows=TR,
                                       cols_per_thread=K, check_codes=False, **kw)
        return lambda: wf.run_block_cs(*a, del_=11, ext=2, tile_rows=TR, cols_per_thread=K,
                                       check_codes=False, **kw)

    def run(name, what, fn, ref, rows, cols, fill, extra=None):
        ms = gpu_ms(fn, args_ns.reps)
        got = fn()
        torch.cuda.synchronize()
        same = ref is None or _same(got, ref, rows, cols, fill)
        rec = dict(shape=name, kernel=what, ms=ms, equal=bool(same), card=card, **(extra or {}))
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if not same:
            raise SystemExit(f"{name}: {what} differs from the shipped kernel")
        return got

    for name in names:
        fill, a, kw, rows, cols = all_shapes[name]
        new = shipped(fill, a, kw)
        ref = new()
        if earlier is not None:
            if fill == "scan":
                q, t, m, h0, y, C, R = a
                old = lambda: earlier_row_scan(earlier, q, t, m, h0, y, C, R,  # noqa: E731
                                               kw["with_dirs"], kw["ckpt_every"])
            else:
                old = lambda: earlier_block_cs(earlier, *a, kw["with_dirs"],  # noqa: E731
                                               kw["ckpt_every"])
            for what, fn in (("earlier", old), ("shipped", new), ("shipped", new),
                             ("earlier", old)):
                run(name, what, fn, ref, rows, cols, fill)
        else:
            run(name, "shipped", new, ref, rows, cols, fill)
        for tile in filter(None, args_ns.tiles.split(",")):
            K, TR = (int(v) for v in tile.split(":"))
            run(name, f"shipped K={K} TR={TR}", shipped(fill, a, kw, K, TR), ref, rows, cols,
                fill, dict(K=K, TR=TR))
        for attr, values in (("STRIP_WARPS", args_ns.warps), ("STRIP_SPARE", args_ns.spare)):
            for v in filter(None, values.split(",")):
                saved = getattr(wf, attr)
                setattr(wf, attr, type(saved)(float(v)))
                try:
                    run(name, f"shipped {attr}={v}", new, ref, rows, cols, fill, {attr: v})
                finally:
                    setattr(wf, attr, saved)
        for vname, lib in variants.items():
            for which, use in (("shipped", shipped_lib), (vname, lib), ("shipped", shipped_lib)):
                _build._LIB = use
                try:
                    run(name, which, new, ref, rows, cols, fill, dict(variant=vname))
                finally:
                    _build._LIB = shipped_lib
    # a call of N strips takes a strip's time and N - 1 lags between strips
    m = torch.as_tensor(np.array(blosum62()).astype(np.int32), device=dev)
    for n in (int(v) for v in filter(None, args_ns.strips.split(","))):
        rows = n * wf.FORWARD_TILE_ROWS
        q, t = (torch.as_tensor(a.astype(np.int32), device=dev) for a in _pair(SEED, PAIR))
        t = t[:rows].contiguous()
        fn = (lambda: wf.row_scan(q, t, m, 11, 2, None, 0, PAIR, rows,  # noqa: E731
                                  with_dirs=False, check_codes=False))
        ref = fn()
        for which, use in (("shipped", shipped_lib), *variants.items()):
            _build._LIB = use
            try:
                tr = wf._strip_rows(rows, 0, None, False)
                run(f"strips-{n}", which, fn, ref, rows, PAIR, "scan",
                    dict(strips=n, steps_per_strip=wf.strip_plan(
                        dev, False, rows, PAIR, tr, wf.COLS_PER_THREAD, 24,
                        False).steps_per_strip))
            finally:
                _build._LIB = shipped_lib
    with open(os.path.join(args_ns.out, "tile_probe.json"), "w") as fh:
        json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
