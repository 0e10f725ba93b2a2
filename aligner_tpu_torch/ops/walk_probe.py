"""The two traceback walks (``csrc/walk_core.cuh``: the replay walk W and
the batched walk K4) timed on one card against an earlier build of them, in
turns, at the shapes the paths give them, each result held ``torch.equal``
to the other build's and to the plain version.

    python -m aligner_tpu_torch.ops.walk_probe [--against DIR] [--out DIR]
        [--reps N] [--shapes NAME,...] [--spans SPAN,...]
        [--plans WARPS:SPAN,...] [--variants NAME,...]

``--against DIR``: a directory holding an earlier ``wavefront.cu`` (with the
headers it includes) and ``device_walk.cu``, for example from ``git show
<commit>:aligner_tpu_torch/csrc/...``, whose walks take the arguments of the
one-warp window walk and of the one-thread-a-problem walk (threads a block
as the earlier ``_build.threads_for`` chose them).  They are compiled with
the shipped flags into a library of their own under ``--out``.

The shapes: W on the last 32,768-row replay block of the 65,536 x 65,536
pair (from its end cell), W on the last 32,768 x 131,072 replay tile of the
524,288 x 524,288 pair (column base 393,216, from its end cell), K4 on the
4,096 x 400^2 full batch (local, from the argmax cells) and on the repeat
search's 1,024 survivors (PWM, 336 x 300 f64); and, asked for by name, W on
blocks of one code: ``w-diag`` (32,768^2, all DIAG), ``w-left`` (16 rows by
65,536 columns, all LEFT: steps without a row change) and ``w-top``
(65,536 rows by 256 columns, all TOP: a row change a step).  The order is
earlier, shipped, shipped, earlier; then W at other spans (``--spans``) and
K4 at other plans (``--plans``: warps a block and span), and the variants
of the walker core named in ``VARIANTS`` (text replaced in
``walk_core.cuh``, other ring depths among them; every source of ``csrc``
built again, one nvcc a source, all at once) in turns with the shipped
build, each held equal too.
Every run reports ns a step (the call's time over the steps its walks took:
the longest walk's for K4, whose walks run side by side), the rows asked
for, the refills and the rounds (a run of one code each).  Prints one line a run and writes them, with the
card's name and power limit, to ``DIR/walk_probe.json``.
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

from ..matrices import blosum62, random_pwm, transform_matrix
from . import _build
from . import device_walk as dw
from . import dp_fill
from . import wavefront as wf
from .tile_probe import _pair, build_variants

_OUT = os.path.join(os.path.dirname(_build._OUT_DIR), "walk_probe")
PAIR, BLOCKED, SEED = 65_536, 524_288, 11
N_FULL, FULL_LEN, N_SURVIVORS = 4_096, 400, 1_024
PWM_W, OFFSET, PWM_DEL, PWM_EXT = 300, 30, 30.0, 7.0


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up, from
    CUDA events, the runs queued behind a busy kernel of about 10 ms so that
    the host's time to launch them (tens of microseconds a call, as long as
    a batched walk) never leaves the card idle between them."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# name -> [(text of walk_core.cuh, its replacement)]
VARIANTS = {
    # rings of other depths: W's 8 or 16 word rows, K4's 4
    "replay-depth-8": [("int REPLAY_DEPTH = 4;", "int REPLAY_DEPTH = 8;")],
    "replay-depth-16": [("int REPLAY_DEPTH = 4;", "int REPLAY_DEPTH = 16;")],
    "walk-depth-4": [("int WALK_DEPTH = 8;", "int WALK_DEPTH = 4;")],
    # the rows staged by plain loads and stores of the walker's lanes, not
    # cp.async: the same words, no copy in flight
    "sync-ask": [
        ("                for (int c = l + 4 * lane_id(); c < hi; c += 128) cp_async16(s + c, w + c);",
         "                for (int c = l + 4 * lane_id(); c < hi; c += 128)\n"
         "                    for (int i = 0; i < 4; ++i) s[c + i] = w[c + i];"),
        ("                for (int c = l + lane_id(); c < hi; c += 32) cp_async4(s + c, w + c);",
         "                for (int c = l + lane_id(); c < hi; c += 32) s[c] = w[c];"),
    ],
}


def variant_source(name: str) -> str:
    """``walk_core.cuh`` with variant ``name``'s replacements; raises
    ``ValueError`` where an anchor is not in the source exactly once."""
    with open(os.path.join(_build._CSRC, "walk_core.cuh")) as fh:
        src = fh.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: its anchor {old[:60]!r} occurs "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def build_earlier(src_dir: str, out_dir: str) -> ctypes.CDLL:
    """The earlier walks of ``src_dir`` as a library of their own."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    objs, jobs = [], []
    for f in ("wavefront.cu", "device_walk.cu"):
        obj = os.path.join(out_dir, f"earlier_{f}.o")
        cmd = [nvcc, *_build.FLAGS, "-I", src_dir, "-c", "-o", obj, os.path.join(src_dir, f)]
        objs.append(obj)
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    _build._run_nvcc(jobs)
    so = os.path.join(out_dir, "earlier_walks.so")
    cmd = [nvcc, *_build.FLAGS, "-shared", "-o", so, *objs]
    _build._run_nvcc([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))])
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wavefront_replay_walk_launch.argtypes = [p, i64, i32, i32, i32, p, p, i32, p]
    lib.wavefront_replay_walk_launch.restype = i32
    lib.device_walk_launch.argtypes = [p, i64, p, p, i32, i32, i32, i32, p, p, p, p, i32, p]
    lib.device_walk_launch.restype = i32
    return lib


def earlier_replay(lib, words, state, steps, row_base, col_base):
    dev = words.device
    err = lib.wavefront_replay_walk_launch(
        words.data_ptr(), words.shape[1], row_base, col_base, words.shape[0] * 16,
        state.data_ptr(), steps.data_ptr(), steps.numel() * 16,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"earlier replay walk: CUDA error {err}")


def earlier_walk(lib, words, sy, sx, S, mode):
    dev = words.device
    B, _, C = words.shape
    sms = dw._sms(dev.index if dev.index is not None else torch.cuda.current_device())
    threads = next((t for t in (128, 64) if -(-B // t) >= sms), 32)
    i32 = dict(dtype=torch.int32, device=dev)
    steps = torch.empty((-(-S // 16), B), **i32)
    n, ey, ex = (torch.empty(B, **i32) for _ in range(3))
    err = lib.device_walk_launch(
        words.data_ptr(), words.shape[1] * C, sy.data_ptr(), sx.data_ptr(), B, C, S,
        int(mode == "global"), steps.data_ptr(), n.data_ptr(), ey.data_ptr(), ex.data_ptr(),
        threads, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"earlier batched walk: CUDA error {err}")
    return steps, n, ey, ex


def _w_pair(dev):
    """The 65,536 x 65,536 pair's last replay block and its cursor."""
    q, t = _pair(SEED, PAIR)
    pp = wf._prep(q, t, np.array(blosum62()), 11, 2, dev)
    TB = wf.TB_ROWS
    t_dev = torch.as_tensor(wf._pad_rows(pp["t"], TB), device=dev)
    _, _, ckpts = wf._scan(pp, t_dev, None, 0, with_dirs=False, ckpt_every=TB)
    j = (PAIR - 1) // TB
    _, words, _ = wf._scan(pp, t_dev[j * TB:(j + 1) * TB], ckpts[j - 1], j * TB,
                           with_dirs=True)
    return dict(words=words, row_base=j * TB, col_base=0, R=PAIR, C=PAIR,
                size=t_dev.numel() + pp["C_pad"] + 1)


def _w_tile(dev):
    """The 524,288 x 524,288 pair's last replay tile and its cursor."""
    from ..parallel import wavefront_sp as sp

    q, t = _pair(SEED + 5, BLOCKED)
    pp = sp._prep_sharded(None, q, t, np.array(blosum62()), 11.0, 2.0, None, sp.TB_ROWS,
                          None, dev)
    _, lb_hist, ckpts = sp._forward(pp, True)
    j, d = pp["R_pad"] // pp["tb"] - 1, pp["n"] - 1
    h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, j, d)
    del lb_hist, ckpts
    words = sp._block(pp, d, pp["t_dev"][j * pp["tb"]:(j + 1) * pp["tb"]], h0, lb,
                      j * pp["tb"], with_dirs=True)[3]
    return dict(words=words, row_base=j * pp["tb"], col_base=d * pp["Cb"], R=BLOCKED,
                C=BLOCKED, size=pp["R_pad"] + pp["C_pad"] + 1)


def _k4_full(dev):
    """The 4,096 x 400^2 full batch's words (local) and argmax cells."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, (N_FULL, FULL_LEN))
    t = q.copy()
    mask = rng.random(t.shape) < 0.25
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    i32 = dict(dtype=torch.int32, device=dev)
    ln = torch.full((N_FULL,), FULL_LEN, **i32)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32, device=dev)
    r = dp_fill.fill(torch.as_tensor(q, **i32), ln, torch.as_tensor(t, **i32), ln, m, 11.0,
                     2.0, mode="local", with_dirs=True)
    return dict(words=r.words, sy=r.fy, sx=r.fx, S=2 * FULL_LEN + 1, mode="local")


def _k4_pwm(dev):
    """The repeat search's survivor batch: 1,024 windows of 330 bases
    against a 4 x 300 PWM as its first cycle makes it, f64, directions."""
    rng = np.random.default_rng(5)
    pwm = transform_matrix(random_pwm(PWM_W, rng), 0.0, PWM_DEL * PWM_EXT,
                           np.full(4, 0.25))
    win = PWM_W + OFFSET
    i32 = dict(dtype=torch.int32, device=dev)
    q = torch.as_tensor(rng.integers(0, 4, (N_SURVIVORS, win)), **i32)
    ql = torch.full((N_SURVIVORS,), win, **i32)
    r = dp_fill.fill_pwm(q, ql, torch.as_tensor(pwm, device=dev), PWM_DEL, PWM_EXT,
                         with_dirs=True)
    return dict(words=r.words, sy=r.fy, sx=r.fx, S=win + PWM_W + 1, mode="local")


def _w_codes(dev, code, rows, cols):
    """A block of `rows` x `cols` cells all holding one code, walked from
    its last cell: all DIAG (a step and a row every 16 steps), all LEFT
    (steps in one word row, no row change) or all TOP (one step a word
    row, a row change each): the time of a step and of a row apart."""
    word = int(np.array(code * 0x55555555, np.uint32).view(np.int32))
    words = torch.full((rows // 16, cols), word, dtype=torch.int32, device=dev)
    return dict(words=words, row_base=0, col_base=0, R=rows, C=cols,
                size=rows + cols + 1)


SHAPES = {"w-pair": _w_pair, "w-tile": _w_tile, "k4-full": _k4_full, "k4-pwm": _k4_pwm,
          "w-diag": lambda dev: _w_codes(dev, 2, 32_768, 32_768),
          "w-left": lambda dev: _w_codes(dev, 1, 16, 65_536),
          "w-top": lambda dev: _w_codes(dev, 0, 65_536, 256)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=_OUT)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", default="w-pair,w-tile,k4-full,k4-pwm")
    ap.add_argument("--spans", default="", help="W's ring span, SPAN,...")
    ap.add_argument("--plans", default="", help="K4's plan, WARPS:SPAN,...")
    ap.add_argument("--variants", default="", help="names in VARIANTS")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.makedirs(ns.out, exist_ok=True)
    earlier = build_earlier(ns.against, ns.out) if ns.against else None
    names = list(filter(None, ns.variants.split(",")))
    variants = build_variants(names, ns.out, source=variant_source,
                              file="walk_core.cuh") if names else {}
    shipped_lib = _build.load()
    records = []

    def record(name, what, ms, same, steps, stats, extra=None):
        rec = dict(shape=name, kernel=what, ms=ms, equal=bool(same), steps=steps,
                   ns_a_step=ms * 1e6 / max(steps, 1), rows_asked=stats[0],
                   refills=stats[1], rounds=stats[2], card=card, **(extra or {}))
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if not same:
            raise SystemExit(f"{name}: {what} differs from the plain version")

    for name in filter(None, ns.shapes.split(",")):
        s = SHAPES[name](dev)
        torch.cuda.synchronize()
        if name.startswith("w-"):
            words, rb, cb = s["words"], s["row_base"], s["col_base"]

            start = wf.new_walk(s["R"], s["C"], s["size"], dev)

            def fresh():  # copies on the card: no transfer inside the timing
                return start[0].clone(), start[1].clone()

            ref = fresh()
            wf.replay_walk_plain(words, *ref, row_base=rb, col_base=cb)
            n_steps = int(ref[0][2])

            def run(what, fn, extra=None):
                ms = queued_ms(lambda: fn(*fresh()), ns.reps)
                got = fresh()
                stats = torch.zeros(3, dtype=torch.int32, device=dev)
                fn(*got, stats=stats) if what != "earlier" else fn(*got)
                torch.cuda.synchronize()
                same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                record(name, what, ms, same, n_steps,
                       stats.tolist() if what != "earlier" else [None] * 3, extra)

            def new(state, steps, stats=None):
                wf.replay_walk(words, state, steps, row_base=rb, col_base=cb, stats=stats)

            plan = dict(span=wf.REPLAY_SPAN)
            if earlier is not None:
                old = lambda st, sp: earlier_replay(earlier, words, st, sp, rb, cb)  # noqa: E731
                for what in ("earlier", "shipped", "shipped", "earlier"):
                    run(what, old if what == "earlier" else new, plan)
            else:
                run("shipped", new, plan)
            for sp_ in (int(v) for v in filter(None, ns.spans.split(","))):
                saved, wf.REPLAY_SPAN = wf.REPLAY_SPAN, sp_
                try:
                    run(f"shipped span={sp_}", new, dict(span=sp_))
                finally:
                    wf.REPLAY_SPAN = saved
            with_variants(variants, shipped_lib, lambda what: run(what, new, plan))
        else:
            words, sy, sx, S, mode = s["words"], s["sy"], s["sx"], s["S"], s["mode"]
            ref = dw.walk_plain(words, sy, sx, S=S, mode=mode)
            n_steps = int(ref[1].max())
            B, _, C = words.shape

            def run(what, fn, extra=None):
                ms = queued_ms(fn, ns.reps)
                stats = torch.zeros(3, dtype=torch.int32, device=dev)
                got = fn(stats) if what != "earlier" else fn()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                record(name, what, ms, same, n_steps,
                       stats.tolist() if what != "earlier" else [None] * 3,
                       dict(extra or {}, problems=B, mean_steps=float(ref[1].float().mean())))

            p = dw.walk_plan(B, C, dev)
            plan = dict(warps=p.warps, blocks=p.blocks, span=p.span)
            new = lambda stats=None: dw.walk(words, sy, sx, S=S, mode=mode, stats=stats)  # noqa: E731
            if earlier is not None:
                old = lambda: earlier_walk(earlier, words, sy, sx, S, mode)  # noqa: E731
                for what in ("earlier", "shipped", "shipped", "earlier"):
                    run(what, old if what == "earlier" else new, plan)
            else:
                run("shipped", new, plan)
            for spec in filter(None, ns.plans.split(",")):
                w_, sp_ = (int(v) for v in spec.split(":"))
                saved = dw.WALK_WARPS, dw.WALK_SPAN
                dw.WALK_WARPS, dw.WALK_SPAN = w_, sp_
                try:
                    p = dw.walk_plan(B, C, dev)
                    run(f"shipped warps={w_} span={sp_}", new,
                        dict(warps=p.warps, blocks=p.blocks, span=p.span))
                finally:
                    dw.WALK_WARPS, dw.WALK_SPAN = saved
            with_variants(variants, shipped_lib, lambda what: run(what, new, plan))
        del s
    with open(os.path.join(ns.out, "walk_probe.json"), "w") as fh:
        json.dump(records, fh, indent=1)
    return 0


def with_variants(variants, shipped_lib, run) -> None:
    """``run(name)`` with each variant's library in turns with the shipped
    one: shipped, variant, shipped."""
    for vname, lib in variants.items():
        for which, use in (("shipped", shipped_lib), (vname, lib), ("shipped", shipped_lib)):
            _build._LIB = use
            try:
                run(which)
            finally:
                _build._LIB = shipped_lib


if __name__ == "__main__":
    sys.exit(main())
