"""Variants of the batched fill kernel (``csrc/dp_fill.cu``, its body
``csrc/dp_fill_core.cuh``) timed side by side on one card, each held equal
to the shipped kernel.

    python -m aligner_tpu_torch.ops.fill_probe [--out DIR] [--sass]
        [--variants NAME,...] [--shapes WORD,...] [--reps N]

A variant is the shipped kernel body with some text replaced (``VARIANTS``);
each compiles beside ``dp_fill.cu`` in its own ``nvcc`` (all at once) into
``build/variants/``
and is loaded in turn in place of the built library, so the wrapper, the
launch plan and the inputs are the shipped ones.  Every variant runs at
the main path's shapes of the fill (the p-value launch, the full-mode
batch, the repeat scan's chunk and its survivors, the tallest search
bucket), at the scan's shape with 1, 2 and 3 warps a block forced, and at
the lone design's shapes (the search's top 10, 2,000 x 3,596 in f32, and
the population's members, 341 x 341 in f64 with a matrix each, at B = 1,
10 and 64), each also with one thread a problem forced, in turns
(shipped, variants..., shipped); its results must be ``torch.equal`` to
the shipped kernel's, but for the variants in ``UNHELD``, which compute
less.  Prints one line a variant and shape and writes
them to ``DIR/fill_probe.json``; ``--sass`` also writes there the SASS of
three instances (``SASS_OF``) of each variant.  Kept so that a variant
tried once can be tried again: a variant whose anchor text is gone from
the source is an error, raised before anything is built.
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
from . import _build, dp_fill

_SRC = os.path.join(_build._CSRC, "dp_fill_core.cuh")
_LAUNCHER = os.path.join(_build._CSRC, "dp_fill.cu")
_OUT = os.path.join(os.path.dirname(_build._OUT_DIR), "variants")

# A block of 8 cells that are all active (most blocks): no select on
# ``active`` on the chain, the cell's value is m.
_FULL_BLOCK = """            if (x_active && y0 + 7 <= tl) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const T left_v = lv[j];
                    const T top = a_up - pen;
                    const T left = left_v - pen;
                    const T diag = diag_prev + sv[j];
                    const T m = cmax(cmax(top, left), diag);
                    const bool beg = !GLOBAL && m == T(0);
                    if (DIRS) {
                        int d = (m - top < eps) ? TOP : ((m - left < eps) ? LEFT : DIAG);
                        if (beg) d = BEG;
                        word |= unsigned(d) << (2 * j);
                    }
                    pen = beg ? del : ext;
                    out[j] = m;
                    if (!TRACK) bv = cmax(bv, m);
                    diag_prev = left_v;
                    a_up = m;
                }
            } else {
"""
_LOOP_HEAD = ("            unsigned word = 0u;\n#pragma unroll\n"
              "            for (int j = 0; j < 8; ++j) {\n")
_LOOP_TAIL = "                a_up = val;\n            }\n"

# Without argmax tracking, the running maximum by a tree a block.
_TREE_MAX = """            if (!TRACK) {
#pragma unroll
                for (int h = 1; h < 8; h *= 2) {
#pragma unroll
                    for (int j = 0; j < 8; j += 2 * h) out[j] = cmax(out[j], out[j + h]);
                }
                bv = cmax(bv, out[0]);
            }
"""


SCAN_WARPS = (1, 2, 3)  # warps a block forced at the repeat scan's shape
LONE_BATCHES = (1, 10, 64)  # problems a launch at the lone design's shapes

# the instances whose SASS --sass keeps: f32 pair local scores only
# without argmax (the p-value), f32 pair local with argmax and directions
# (the full batch), f64 PWM scores only (the repeat scan)
SASS_OF = ("IfLb0ELb0ELb0ELb0ELb0E", "IfLb0ELb1ELb1ELb0ELb0E", "IdLb0ELb0ELb0ELb1ELb0E")

# The scores through one pointer that may be shared or device memory: the
# compiler then makes generic 64-bit loads and their address arithmetic.
_GATHER = """            if (smem_mat) {
#pragma unroll
                for (int j = 0; j < 8; ++j) sv[j] = smat[soff + code[j] * sstride];
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) sv[j] = srow[code[j] * sstride];
            }
"""
_GATHER_GENERIC = """            const T* sr = smem_mat ? smat + soff : srow;
#pragma unroll
            for (int j = 0; j < 8; ++j) sv[j] = sr[code[j] * sstride];
"""

# The Beginning test on the bits of m (an integer and, an integer compare)
# instead of a floating compare: equal for every value.
_ZERO_BITS = """__device__ __forceinline__ bool is_zero(float v) {
    return (__float_as_uint(v) & 0x7fffffffu) == 0u;
}
__device__ __forceinline__ bool is_zero(double v) {
    const unsigned long long u = __double_as_longlong(v);
    return (u & 0x7fffffffffffffffull) == 0ull;
}
"""

# The penalty as a flag (del or ext) and both subtractions of each gap term
# made before the choice, opaque to the compiler so that it cannot fold
# them back into one subtraction of a selected penalty.
_SUB_RN = """__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
"""
_KERNEL_HEAD = ("template <typename T, bool GLOBAL, bool TRACK, bool DIRS, bool PWM, bool PLANE>\n"
                "__global__")

# The lone design's chain lane with its companion feeding it scores and
# nothing else (no words, no maximum): the chain's own floor, handoffs
# included.
_COMPANION = "            f.companion_column(x - 1, lane);\n"
_SCORES_ONLY = "            if (x + 1 <= f.cols) f.fill_scores(x + 1, lane);\n"

# name -> [(text in the shipped source, its replacement), ...]
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "penalty-flag": [
        (_KERNEL_HEAD, _SUB_RN + _KERNEL_HEAD),
        ("    T pen = del;\n", "    bool pd = true;  // the penalty is del (else ext)\n"),
        ("                const T top = a_up - pen;\n                const T left = left_v - pen;\n",
         "                const T top = pd ? sub_rn(a_up, del) : sub_rn(a_up, ext);\n"
         "                const T left = pd ? sub_rn(left_v, del) : sub_rn(left_v, ext);\n"),
        ("                if (active) pen = beg ? del : ext;\n", "                if (active) pd = beg;\n")],
    # the hardware's max in f64 too
    "fmax-f64": [("double cmax(double a, double b) { return vmax(a, b); }",
                  "double cmax(double a, double b) { return fmax(a, b); }")],
    "zero-bits": [(_KERNEL_HEAD, _ZERO_BITS + _KERNEL_HEAD),
                  ("\n                const bool beg = !GLOBAL && m == T(0);",
                   "\n                const bool beg = !GLOBAL && is_zero(m);")],
    # for information only, not exact op for op: the maxima taken in
    # another order, so the cell waits on one maximum after its top term
    "max-order": [("\n                const T m = cmax(cmax(top, left), diag);",
                   "\n                const T m = cmax(top, cmax(left, diag));")],
    "generic-gather": [(_GATHER, _GATHER_GENERIC)],
    # compare-and-select maxima in f32 too
    "ternary-f32": [("{ return fmaxf(a, b); }", "{ return vmax(a, b); }")],
    "full-block": [(_LOOP_HEAD, "            unsigned word = 0u;\n" + _FULL_BLOCK
                    + "#pragma unroll\n            for (int j = 0; j < 8; ++j) {\n"),
                   (_LOOP_TAIL, _LOOP_TAIL + "            }\n")],
    "chain-alone": [(_COMPANION, _SCORES_ONLY)],
    # the lone chain's penalty as a flag, both subtractions of each gap
    # term made before the choice (the same operations, speculated)
    "lone-penalty-flag": [
        (_KERNEL_HEAD, _SUB_RN + _KERNEL_HEAD),
        ("        auto cell = [&](T left_v, T s) {\n"
         "            const T top = a_up - pen;\n            const T left = left_v - pen;\n",
         "        bool pd = pen == del;\n        auto cell = [&](T left_v, T s) {\n"
         "            const T top = pd ? sub_rn(a_up, del) : sub_rn(a_up, ext);\n"
         "            const T left = pd ? sub_rn(left_v, del) : sub_rn(left_v, ext);\n"),
        ("            pen = beg ? del : ext;\n            diag_prev = left_v;\n",
         "            pd = beg;\n            diag_prev = left_v;\n"),
        ("        for (int i = full; i < rows; ++i) nb[i] = cell(ob[i], sv[i]);\n",
         "        for (int i = full; i < rows; ++i) nb[i] = cell(ob[i], sv[i]);\n"
         "        pen = pd ? del : ext;\n")],
    "tree-max": [("                if (!TRACK) bv = cmax(bv, val);\n", ""),
                 ("            if (TRACK) {\n                // the block's first maximum",
                  _TREE_MAX + "            if (TRACK) {\n                // the block's first maximum")],
}


# variants whose outputs are not the kernel's: timed, not held equal
UNHELD = {"chain-alone"}


def variant_sources(names, base: str | None = None) -> dict[str, str]:
    """The shipped kernel body (``base``, by default ``csrc/dp_fill_core.cuh``) and
    each named variant of it; raises ``ValueError`` where a variant's
    anchor text is not in the source exactly once."""
    if base is None:
        with open(_SRC) as fh:
            base = fh.read()
    out = {"shipped": base}
    for name in names:
        src = base
        for old, new in VARIANTS[name]:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: its anchor {old[:60]!r} occurs "
                                 f"{src.count(old)} times in the source, not once")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build_all(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    nvcc = _build._nvcc()
    with open(_LAUNCHER) as fh:
        launcher = fh.read()
    procs = []
    for name, src in sources.items():
        d = os.path.join(_OUT, name)
        os.makedirs(d, exist_ok=True)
        # the launcher includes the body beside it: this variant's
        with open(os.path.join(d, "dp_fill_core.cuh"), "w") as fh:
            fh.write(src)
        with open(os.path.join(d, "dp_fill.cu"), "w") as fh:
            fh.write(launcher)
        cmd = [nvcc, *_build.FLAGS, "-Xptxas", "-v", "-shared", "-o",
               os.path.join(d, "dp_fill.so"), os.path.join(d, "dp_fill.cu")]
        procs.append((name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, cmd, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise _build.KernelBuildFailure(f"{' '.join(cmd)}\n{out}")
        with open(os.path.join(_OUT, name, "ptxas.txt"), "w") as fh:
            fh.write(out)
        lib = ctypes.CDLL(os.path.join(_OUT, name, "dp_fill.so"))
        _build.bind_fill(lib)
        libs[name] = lib
    return libs


def _shapes(dev):
    """(name, cells a problem, fill) at the main path's shapes, on seeded
    random codes (the work does not depend on the residues)."""
    rng = np.random.default_rng(0)

    def ints(*shape, hi):
        return torch.as_tensor(rng.integers(0, hi, shape), dtype=torch.int32, device=dev)

    b62 = torch.as_tensor(np.array(blosum62()), dtype=torch.float32, device=dev)
    pv = (ints(4_999, 344, hi=24), torch.full((4_999,), 344, dtype=torch.int32, device=dev),
          ints(4_999, 344, hi=24), torch.full((4_999,), 344, dtype=torch.int32, device=dev))
    fb = (ints(4_096, 400, hi=24), torch.full((4_096,), 400, dtype=torch.int32, device=dev),
          ints(4_096, 400, hi=24), torch.full((4_096,), 400, dtype=torch.int32, device=dev))
    tall = (ints(166, 344, hi=24), torch.full((166,), 344, dtype=torch.int32, device=dev),
            ints(166, 2_000, hi=24), torch.full((166,), 2_000, dtype=torch.int32, device=dev))
    top = {B: (ints(B, 3_596, hi=24), torch.full((B,), 3_596, dtype=torch.int32, device=dev),
               ints(B, 2_000, hi=24), torch.full((B,), 2_000, dtype=torch.int32, device=dev))
           for B in LONE_BATCHES}
    pop = {B: (ints(B, 341, hi=24), torch.full((B,), 341, dtype=torch.int32, device=dev),
               ints(B, 341, hi=24), torch.full((B,), 341, dtype=torch.int32, device=dev),
               torch.as_tensor(rng.normal(0.0, 3.0, (B, 24, 24)), device=dev))
           for B in LONE_BATCHES}
    pwm = torch.as_tensor(rng.normal(0.0, 3.0, (4, 300)), device=dev)
    scan = (ints(65_536, 330, hi=4), torch.full((65_536,), 330, dtype=torch.int32, device=dev))
    surv = (scan[0][:1_024].contiguous(), scan[1][:1_024].contiguous())
    return [
        ("p-value 4999x344x344 f32 scores", 344 * 344,
         lambda: dp_fill.fill(*pv, b62, 11.0, 2.0, track_argmax=False)),
        ("full batch 4096x400x400 f32 dirs", 400 * 400,
         lambda: dp_fill.fill(*fb, b62, 11.0, 2.0, with_dirs=True)),
        ("full batch 4096x400x400 f32 scores", 400 * 400,
         lambda: dp_fill.fill(*fb, b62, 11.0, 2.0)),
        ("full batch 4096x400x400 f32 scores no argmax", 400 * 400,
         lambda: dp_fill.fill(*fb, b62, 11.0, 2.0, track_argmax=False)),
        ("tallest bucket 166x2000x344 f32 scores", 2_000 * 344,
         lambda: dp_fill.fill(*tall, b62, 11.0, 2.0)),
        ("scan 65536x336x300 f64 scores", 336 * 300,
         lambda: dp_fill.fill_pwm(*scan, pwm, 30.0, 7.0, track_argmax=False)),
        ("survivors 1024x336x300 f64 dirs", 336 * 300,
         lambda: dp_fill.fill_pwm(*surv, pwm, 30.0, 7.0, with_dirs=True)),
        *[(f"scan 65536x336x300 {dt} scores, {w} warp(s) a block", 336 * 300,
           _forced(w, lambda p=p: dp_fill.fill_pwm(*scan, p, 30.0, 7.0, track_argmax=False)))
          for dt, p in (("f64", pwm), ("f32", pwm.float())) for w in SCAN_WARPS],
        *[(f"{name}{how}", cells, fn if lone else _design(False, fn))
          for B in LONE_BATCHES
          for name, cells, fn in (
              (f"top-10 {B}x2000x3596 f32 dirs", 2_000 * 3_596,
               lambda B=B: dp_fill.fill(*top[B], b62, 11.0, 2.0, with_dirs=True)),
              (f"population {B}x341x341 f64 dirs", 341 * 341,
               lambda B=B: dp_fill.fill(*pop[B][:4], pop[B][4], 11.0, 1.0, with_dirs=True)))
          for lone, how in ((True, ""), (False, ", one thread a problem"))],
    ]


def _forced(warps: int, fn):
    """``fn`` run with the launch plan held to ``warps`` warps a block:
    the wrapper's plan, made by ``plan_fill`` with ``warps`` given."""
    planned = dp_fill.launch_plan

    def plan(B, R8, matrix, **instance):
        shipped = planned(B, R8, matrix, **instance)
        card = dp_fill.card_limits(matrix.device)
        return dp_fill.plan_fill(R8, matrix.element_size(), B, card, shipped.mat_bytes,
                                 warps=warps)

    def run():
        dp_fill.launch_plan = plan
        try:
            return fn()
        finally:
            dp_fill.launch_plan = planned
    return run


def _design(lone: bool, fn):
    """``fn`` run with ``plan_fill`` held to the lone design (True) or to
    one thread a problem (False)."""
    planned = dp_fill.plan_fill

    def plan(*args, **kw):
        return planned(*args, **{**kw, "lone": lone})

    def run():
        dp_fill.plan_fill = plan
        try:
            return fn()
        finally:
            dp_fill.plan_fill = planned
    return run


def _time(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _same(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip((a.fmax, a.fy, a.fx, a.end, a.words),
                               (b.fmax, b.fy, b.fx, b.end, b.words)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(os.path.dirname(_OUT), "fill_probe"))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS (default: all)")
    ap.add_argument("--shapes", default="",
                    help="run only the shapes whose name holds one of these "
                         "comma-separated words")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fill_probe: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    libs = _build_all(variant_sources([v for v in args.variants.split(",") if v]))
    words = [w for w in args.shapes.split(",") if w]
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        for name in libs:
            sass = subprocess.run([cuobjdump, "-sass", os.path.join(_OUT, name, "dp_fill.so")],
                                  capture_output=True, text=True).stdout
            keep = [f for f in sass.split("Function : ")[1:]
                    if any(k in f.split("\n", 1)[0] for k in SASS_OF)]
            with open(os.path.join(args.out, f"dp_fill.{name}.sass"), "w") as fh:
                fh.write("".join("Function : " + f for f in keep))
    order = ["shipped", *[n for n in libs if n != "shipped"], "shipped"]
    rows = []
    saved = _build._LIB
    try:
        for shape, cells, fn in _shapes(dev):
            if words and not any(w in shape for w in words):
                continue
            ref = None
            for name in order:
                _build._LIB = libs[name]
                ms = _time(fn, args.reps)
                res = fn()
                torch.cuda.synchronize()
                ref = ref or res
                same = None if name in UNHELD else _same(res, ref)
                rows.append(dict(shape=shape, variant=name, ms=ms,
                                 ns_cell=ms * 1e6 / cells, equal=same))
                held = " (not held)" if same is None else "" if same else " DIFFERS"
                print(f"{shape}: {name} {ms:.3f} ms ({ms * 1e6 / cells:.2f} ns a cell "
                      f"per problem){held}", flush=True)
    finally:
        _build._LIB = saved
    with open(os.path.join(args.out, "fill_probe.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0 if all(r["equal"] is not False for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
