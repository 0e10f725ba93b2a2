"""The band walk of the end score (``csrc/wavefront_band.cu``) timed on one
card against an earlier build of the band fill, in turns, at the shapes the
paths give it, each result held ``torch.equal`` to the other build's.

    python -m aligner_tpu_torch.ops.band_probe [--against DIR] [--out DIR]
        [--reps N] [--shapes NAME,...] [--kp K:P,...] [--warps W,...]
        [--variants NAME,...] [--groups N,...]

``--against DIR``: a directory holding an earlier ``wavefront_band.cu``
(for example from ``git show <commit>:aligner_tpu_torch/csrc/wavefront_band.cu``)
whose entry point takes the per-anti-diagonal launcher's arguments (rows a
lane and steps a tile, the scratch ``state``, ``carry`` and ``w``, and a
count of launches), timed at 2 rows a lane and 128-step tiles.  It is
compiled with the shipped flags into a library of its own under ``--out``.

The shapes: one band as tall as the 65,536 x 65,536 pair and one as tall as
the 262,144 x 262,144 pair, as ``end_score_single_global_diag`` builds them
(scores only, the end cell owned), and the 262,144 x 262,144 block at x0 =
262,144 of ``parallel.wavefront_sp.band_grid`` on the 524,288 x 524,288
pair (a streamed left boundary, the right column on).  The order is
earlier, shipped, shipped, earlier; then the shipped kernel at other rows a
lane and read-aheads (``--kp``) and warps a block (``--warps``), and the
variants of the source named in ``VARIANTS`` (text replaced in
``wavefront_band.cu``; every source of ``csrc`` built again, one nvcc a
source, all at once), each held equal too.  ``--groups N``: a call of N
row groups by 65,536 columns, for the time of one group and the lag
between groups.  Prints one
line a run and writes them, with the card's name and power limit, to
``DIR/band_probe.json``.
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
from .tile_probe import _pair, build_variants, gpu_ms

_OUT = os.path.join(os.path.dirname(_build._OUT_DIR), "band_probe")
PAIR, WIDE, BLOCKED, SEED = 65_536, 262_144, 524_288, 11

# name -> [(text of wavefront_band.cu, its replacement)]
VARIANTS = {
    # a tight poll, without the back-off
    "no-sleep": [("        __nanosleep(sleep);\n", "")],
    # the step loop unrolled less, or further
    "unroll-4": [("constexpr int STEP_UNROLL = 8;", "constexpr int STEP_UNROLL = 4;")],
    "unroll-16": [("constexpr int STEP_UNROLL = 8;", "constexpr int STEP_UNROLL = 16;")],
    # the lane copies of the table in 16 bits, two entries a word (half the
    # shared memory, so twice the blocks an SM; scores + 2*ext must fit)
    "half-table": [
        ("    return sizeof(int) * (size_t(copies) * V * (V + 1) + 4 * size_t(P) * warps);",
         "    return sizeof(int) * (size_t(copies) * V * (V + 1) / 2 + 4 * size_t(P) * warps);"),
        ("    const int n_tab = (a.V * V1) << cs;",
         "    const int n_tab = ((a.V * V1) << cs) / 2;"),
        ("        const int tv = (i >> cs) / V1, qv = (i >> cs) - tv * V1;\n"
         "        smat[i] = (qv < a.V ? a.matrix[tv * a.V + qv] : 0) + 2 * a.ext;\n",
         "        int two[2];\n"
         "        for (int u = 0; u < 2; ++u) {\n"
         "            const int e = (i >> cs) * 2 + u, tv = e / V1, qv = e - tv * V1;\n"
         "            two[u] = (qv < a.V ? a.matrix[tv * a.V + qv] : 0) + 2 * a.ext;\n"
         "        }\n"
         "        smat[i] = (two[0] & 0xffff) | (two[1] << 16);\n"),
        ("            trow[k] = ((a.t[j] * V1) << cs) + (lane & ((1 << cs) - 1));",
         "            trow[k] = a.t[j] * V1;"),
        ("sc[k] = smat[trow[k] + qc[k]];",
         "{\n            const int e = trow[k] + (qc[k] >> a.cshift);\n"
         "            const int w =\n"
         "                smat[((e >> 1) << a.cshift) + (lane & ((1 << a.cshift) - 1))];\n"
         "            sc[k] = (e & 1) ? (w >> 16) : int(short(w));\n        }"),
    ],
    # the cell's two maxima as one DPX three-way maximum
    "dpx-max3": [("            const int m = h[k] > up ? h[k] : up;\n"
                  "            v = v > m ? v : m;\n",
                  "            v = __vimax3_s32(v, h[k], up);\n")],
}


def variant_source(name: str) -> str:
    """``wavefront_band.cu`` with variant ``name``'s replacements; raises
    ``ValueError`` where an anchor is not in the source exactly once."""
    with open(os.path.join(_build._CSRC, "wavefront_band.cu")) as fh:
        src = fh.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: its anchor {old[:60]!r} occurs "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def build_earlier(src_dir: str, out_dir: str) -> ctypes.CDLL:
    """The earlier band fill of ``src_dir`` as a library of its own."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    obj = os.path.join(out_dir, "earlier_wavefront_band.o")
    so = os.path.join(out_dir, "earlier_wavefront_band.so")
    for cmd in ([nvcc, *_build.FLAGS, "-c", "-o", obj,
                 os.path.join(src_dir, "wavefront_band.cu")],
                [nvcc, *_build.FLAGS, "-shared", "-o", so, obj]):
        _build._run_nvcc([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))])
    lib = ctypes.CDLL(so)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wavefront_band_launch.argtypes = [*[p] * 7, *[i32] * 11, *[p] * 6,
                                          ctypes.POINTER(i32), p]
    lib.wavefront_band_launch.restype = i32
    return lib


def earlier_band(lib, t_band, q, f, c1, c2, fd, matrix, scal, *, Cb, ext, with_rc,
                 K=2, TD=128):
    """``run_block_band``'s outputs from the earlier build: one launch an
    anti-diagonal of tiles."""
    dev = t_band.device
    TB, D = t_band.numel(), q.numel()
    i32 = dict(dtype=torch.int32, device=dev)
    state = torch.full((2, TB), wf.NEG_I32, **i32)
    carry = torch.full((TB // (32 * K), 2), wf.NEG_I32, **i32)
    w = torch.full((D,), wf.NEG_I32, **i32)
    rb = torch.full((D,), wf.NEG_I32, **i32)
    rc, end = torch.zeros(TB, **i32), torch.zeros(1, **i32)
    n = ctypes.c_int(0)
    j_end, d_end, owned = (int(v) for v in scal)
    err = lib.wavefront_band_launch(
        t_band.data_ptr(), q.data_ptr(), f.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        fd.data_ptr(), matrix.data_ptr(), matrix.shape[0], TB, D, int(Cb), int(ext), K, TD,
        j_end, d_end, owned, int(with_rc), state.data_ptr(), carry.data_ptr(), w.data_ptr(),
        rb.data_ptr(), rc.data_ptr(), end.data_ptr(), ctypes.byref(n),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"earlier band fill: CUDA error {err}")
    return rb, rc, end


def _no_fill(t_band, q, *args, **kw):
    """A band fill that fills nothing: the end score's loop then only
    builds the streams."""
    return q.new_zeros(q.numel()), None, None


def _end_score_band(dev, n, tb):
    """The first band of the n x n pair as the end score builds it."""
    q, t = _pair(SEED + (0 if n == PAIR else 2), n)
    pp = wf._prep(q, t, np.array(blosum62()), 11, 2, dev)
    bands = []
    wf._band_end_score(pp, tb, wf.BAND_TD, wf.BAND_ROWS_PER_LANE, block=_no_fill,
                       trace=bands)
    args, kw, _ = bands[0]
    return args, dict(kw, with_rc=False)


def _grid_block(dev):
    """The 262,144 x 262,144 block at x0 = 262,144 of band_grid on the
    524,288 x 524,288 pair, its left boundary from the shipped kernel."""
    from ..parallel import wavefront_sp as sp

    q, t = _pair(SEED + 5, BLOCKED)
    calls = []

    def block(*args, **kw):
        out = wf.run_block_band(*args, **kw)
        calls.append((args, kw))
        return out

    sp.band_grid(q, t, np.array(blosum62()), 11.0, 2.0, tb=WIDE, cb=WIDE, device=dev,
                 block=block, check_codes=False)
    args, kw = calls[1]  # band 0, column block 1
    kw = {k: v for k, v in kw.items() if k in ("Cb", "ext", "with_rc")}
    return args, kw


def shapes(dev, names):
    """name -> (args, keywords) of run_block_band."""
    make = {"band-65536": lambda: _end_score_band(dev, PAIR, PAIR),
            "band-262144": lambda: _end_score_band(dev, WIDE, WIDE),
            "grid-block": lambda: _grid_block(dev)}
    return {n: make[n]() for n in names}


def same_band(a, b, TB, Cb, with_rc) -> bool:
    """rb on the slots that cells of the block's columns feed, rc and end."""
    ok = torch.equal(a[0][TB - 1:TB - 1 + Cb], b[0][TB - 1:TB - 1 + Cb])
    if with_rc:
        ok = ok and torch.equal(a[1], b[1])
    return ok and torch.equal(a[2], b[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=_OUT)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shapes", default="band-65536,band-262144,grid-block")
    ap.add_argument("--kp", default="",
                    help="rows a lane and slots read ahead of the shipped kernel, K:P,...")
    ap.add_argument("--warps", default="", help="warps a block, W,...")
    ap.add_argument("--variants", default="", help="names in VARIANTS")
    ap.add_argument("--groups", default="",
                    help="N,...: a call of N row groups x 65,536 columns")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("band_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.makedirs(ns.out, exist_ok=True)
    earlier = build_earlier(ns.against, ns.out) if ns.against else None
    variants = build_variants(list(filter(None, ns.variants.split(","))), ns.out,
                              source=variant_source, file="wavefront_band.cu")
    shipped_lib = _build.load()
    records = []

    def run(name, what, fn, ref, TB, Cb, with_rc, extra=None):
        ms = gpu_ms(fn, ns.reps)
        got = fn()
        torch.cuda.synchronize()
        same = ref is None or same_band(got, ref, TB, Cb, with_rc)
        rec = dict(shape=name, kernel=what, ms=ms, equal=bool(same), card=card,
                   **(extra or {}))
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if not same:
            raise SystemExit(f"{name}: {what} differs from the shipped kernel")

    def plan_of(a, kw, K, P):
        TB, D = a[0].numel(), a[1].numel()
        p = wf.band_plan(dev, TB, kw["Cb"], D, K, P, a[6].shape[0])
        return dict(K=K, P=P, n_g=p.n_g, warps=p.warps, blocks=p.blocks, copies=p.copies,
                    critical_steps=p.critical_steps)

    for name, (a, kw) in shapes(dev, list(filter(None, ns.shapes.split(",")))).items():
        TB, Cb, rc = a[0].numel(), kw["Cb"], kw["with_rc"]
        new = lambda: wf.run_block_band(*a, **kw, check_codes=False)  # noqa: E731
        ref = new()
        base = plan_of(a, kw, wf.BAND_ROWS_PER_LANE, wf.BAND_READ_AHEAD)
        if earlier is not None:
            old = lambda: earlier_band(earlier, *a, **kw)  # noqa: E731
            for what, fn in (("earlier", old), ("shipped", new), ("shipped", new),
                             ("earlier", old)):
                run(name, what, fn, ref, TB, Cb, rc, base if what == "shipped" else None)
        else:
            run(name, "shipped", new, ref, TB, Cb, rc, base)
        for kp in filter(None, ns.kp.split(",")):
            K, P = (int(v) for v in kp.split(":"))
            run(name, f"shipped K={K} P={P}",
                lambda: wf.run_block_band(*a, **kw, rows_per_lane=K, read_ahead=P,
                                          check_codes=False),
                ref, TB, Cb, rc, plan_of(a, kw, K, P))
        for v in filter(None, ns.warps.split(",")):
            saved, wf.BAND_WARPS = wf.BAND_WARPS, int(v)
            try:
                run(name, f"shipped BAND_WARPS={v}", new, ref, TB, Cb, rc, dict(BAND_WARPS=v))
            finally:
                wf.BAND_WARPS = saved
        for vname, lib in variants.items():
            for which, use in (("shipped", shipped_lib), (vname, lib), ("shipped", shipped_lib)):
                _build._LIB = use
                try:
                    run(name, which, new, ref, TB, Cb, rc, dict(variant=vname))
                finally:
                    _build._LIB = shipped_lib
    # a call of N groups takes a group's time and N - 1 lags between groups
    for n in (int(v) for v in filter(None, ns.groups.split(","))):
        rows = n * 32 * wf.BAND_ROWS_PER_LANE
        q, t = _pair(SEED, PAIR)
        pp = wf._prep(q, t[:rows], np.array(blosum62()), 11, 2, dev)
        bands = []
        wf._band_end_score(pp, -(-rows // wf.LANES) * wf.LANES, wf.BAND_TD,
                           wf.BAND_ROWS_PER_LANE, block=_no_fill, trace=bands)
        a, kw, _ = bands[0]
        a = (a[0][:rows].contiguous(), *a[1:7], (0, 1, 0))
        kw = dict(kw, with_rc=False)
        fn = lambda: wf.run_block_band(*a, **kw, check_codes=False)  # noqa: E731
        ref = fn()
        for which, use in (("shipped", shipped_lib), *variants.items()):
            _build._LIB = use
            try:
                run(f"groups-{n}", which, fn, ref, rows, kw["Cb"], False,
                    dict(groups=n, **plan_of(a, kw, wf.BAND_ROWS_PER_LANE,
                                              wf.BAND_READ_AHEAD)))
            finally:
                _build._LIB = shipped_lib
    with open(os.path.join(ns.out, "band_probe.json"), "w") as fh:
        json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
