"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: its ``file`` (``benchmark/configs/<name>.json``);
* a cell's traffic: ``benchmark/workloads/<traffic>.json``, its parameters
  and the driver that sends it (``benchmark/drivers/<driver>.py``);
* a metric, end to end or per layer: ``benchmark/metrics/<name>.py``, a
  reader with ``read(run) -> float | None``.

A cell, configuration or metric is added by adding its files and its entry;
no file here names one.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class ManifestError(ValueError):
    pass


def load(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise ManifestError(f"no BENCHMARK.json at {root}")
    with open(path) as fh:
        return json.load(fh)


def check_names(bench: dict) -> None:
    """The characters and lengths of names and units, and no name twice."""
    def name(v, what):
        if not isinstance(v, str) or not NAME.match(v):
            raise ManifestError(f"{what} {v!r} is not a valid name")

    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for entry in bench[kind]:
            name(entry["name"], kind)
            if entry["name"] in seen:
                raise ManifestError(f"{kind}: {entry['name']!r} twice")
            seen.add(entry["name"])
    for c in bench["configs"]:
        for key in c["reduced"]:
            name(key, "reduced key")
    for w in bench["workloads"]:
        name(w["config"], "config")
        name(w["traffic"], "traffic")
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    if len(set(metric_names)) != len(metric_names):
        raise ManifestError("a metric name is used twice")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
            raise ManifestError(f"unit {m['unit']!r} of {m['name']} is not valid")
        if m["better"] not in ("lower", "higher"):
            raise ManifestError(f"better of {m['name']}")
        if m["source"] not in SOURCES:
            raise ManifestError(f"source of {m['name']}")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no cell {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise ManifestError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    """A traffic mix by its name (a cell's ``traffic``): ``workloads/<name>.json``."""
    with open(os.path.join(bench_dir, "workloads", f"{name}.json")) as fh:
        return json.load(fh)


def _module(path: str, tag: str):
    if not os.path.exists(path):
        raise ManifestError(f"missing {path}")
    tag = f"{tag}_{hashlib.sha1(path.encode()).hexdigest()[:8]}"
    if tag in sys.modules:
        return sys.modules[tag]
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[tag] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: str = BENCH_DIR):
    return _module(os.path.join(bench_dir, "drivers", f"{name}.py"), f"bench_driver_{name}")


def reader(name: str, bench_dir: str = BENCH_DIR):
    return _module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                   "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones:
    those that list it, and those that list no cells."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
