"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and metrics are found by name from
``BENCHMARK.json`` (see ``harness/manifest.py``).  Set-up makes the inputs
from the seed and warms the program; the window then sends the cell's
requests one after another (one client, a closed loop) for ``--seconds``;
afterwards the program's answers are compared with the plain reference
(``benchmark/reference/``).  The last line of standard output is one JSON
object; the numbers compared, each with its limit, are the last lines of
standard error and the result's last key.  ``--trace 1`` runs the window
under ``torch.profiler`` and reports the per-layer metrics.

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), or when the JAX stack or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

from harness import guard, manifest  # noqa: E402
from harness.record import Run  # noqa: E402


class NoCard(RuntimeError):
    pass


def cache_env(env=os.environ) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernels build into ``build/kernels`` there)."""
    base = os.path.join(ROOT, "build", "bench_cache")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    env["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    env["CUDA_CACHE_PATH"] = os.path.join(base, "nv_compute")
    guard.quiet_environment(env)


def card_line() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class NoProgram(RuntimeError):
    pass


def program_in_checkout() -> None:
    """The program under test is the checkout's own ``aligner_tpu_torch``."""
    try:
        import aligner_tpu_torch
    except ImportError as e:
        raise NoProgram(f"the program is not in this checkout: {e}") from e
    where = os.path.dirname(os.path.dirname(os.path.abspath(aligner_tpu_torch.__file__)))
    if where != ROOT:
        raise NoProgram(f"aligner_tpu_torch was imported from {where}, not from {ROOT}")


def pick_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             *, bench=None, config_overrides=None, traffic_overrides=None) -> Run:
    """Set-up, window, check and metrics of one cell on ``device``.  The
    overrides update the configuration's and the traffic's parameters (for
    tests at small sizes)."""
    import torch

    bench = bench or manifest.load()
    cell = manifest.cell(bench, cell_name)
    cfg = _merge(manifest.config(bench, cell["config"]), config_overrides or {})
    traffic = _merge(manifest.traffic(cell["traffic"]), traffic_overrides or {})
    drv = manifest.driver(traffic["driver"])
    run = Run(cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=seconds,
              trace=trace, device=device)
    on_card = torch.device(device).type == "cuda"
    state = drv.setup(run)
    if on_card:
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - T_START
    limit = traffic.get("trace_requests") if trace else None
    if trace:
        from harness import trace as tr
    with contextlib.ExitStack() as stack:
        if trace:
            prof = stack.enter_context(tr.profiler())
            stack.enter_context(tr.wrap(drv.spans(state)))
            stack.enter_context(tr.span("window"))
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds and (limit is None or i < limit):
            rec = {"i": i}
            with tr.span(traffic["driver"]) if trace else contextlib.nullcontext():
                rec["t0"] = time.perf_counter()
                try:
                    rec.update(drv.request(state, i))
                except Exception as e:  # a request that fails is counted, not fatal
                    rec["error"] = f"{type(e).__name__}: {e}"
                rec["t1"] = time.perf_counter()
            run.requests.append(rec)
            i += 1
        if on_card:
            torch.cuda.synchronize(device)
        run.window_s = max(r["t1"] for r in run.requests) - t0 if run.requests else 0.0
    if on_card:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if hasattr(drv, "counters"):
        run.counters = drv.counters(state)
    if trace:
        run.trace_summary = tr.read(prof)
        del prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    run.checks = drv.check(state, run)
    run.check_s = time.perf_counter() - t_check
    for m in manifest.metrics_for(bench, cell_name, trace):
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            run.metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return run


def result_line(run: Run, device_info: dict) -> dict:
    failed = sum(1 for r in run.requests if "error" in r)
    out = {
        "correct": run.correct(),
        "attempted": len(run.requests),
        "failed": failed,
        "metrics": run.metrics,
        "device": dict(device_info, memory_peak_bytes=run.memory_peak_bytes),
    }
    if run.trace_summary is not None:
        from harness import trace as tr
        out["device"]["busy_s"] = run.trace_summary.busy_s
        out["device"]["window_s"] = run.trace_summary.window_s
        out["breakdown"] = tr.breakdown(run.trace_summary)
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    try:
        program_in_checkout()
        device = pick_device(int(cell["chips"]))
    except (NoProgram, NoCard) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": int(cell["chips"])}
    card = card_line()
    if card:
        info["card"] = card
    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                   bench=bench)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(run, info)
    print(f"set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"{len(run.requests)} requests, check {run.check_s:.3f} s", file=sys.stderr)
    for r in run.requests:
        if "error" in r:
            print(f"request {r['i']} failed: {r['error']}", file=sys.stderr)
    for name, v, lim in run.checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
