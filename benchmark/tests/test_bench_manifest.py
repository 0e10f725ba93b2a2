"""BENCHMARK.json against the benchmark's contract, every name found from
its own files, a cell added from files alone, and the modules a run may
not load."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import guard, manifest

BENCH_DIR = manifest.BENCH_DIR
ROOT = manifest.ROOT


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    manifest.check_names(bench)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "µs", "", "x" * 65, ".x" * 0 + "-"])
def test_a_bad_name_is_refused(bench, bad):
    broken = json.loads(json.dumps(bench))
    broken["workloads"][0]["name"] = bad
    if bad == "-":
        broken["workloads"][0]["name"] = "-lead"
    with pytest.raises(manifest.ManifestError):
        manifest.check_names(broken)


@pytest.mark.parametrize("unit", ["tokens per second", "x" * 17, "µs"])
def test_a_bad_unit_is_refused(bench, unit):
    broken = json.loads(json.dumps(bench))
    broken["end_to_end"][0]["unit"] = unit
    with pytest.raises(manifest.ManifestError):
        manifest.check_names(broken)


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = manifest.metrics_for(bench, w["name"], True)
        assert layers
        for m in layers:  # a layer's metric moves a metric its cells report
            assert m["moves"] in e2e


def test_everything_is_found_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        cfg = manifest.config(bench, c["name"])
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg["reduced"]
    for w in bench["workloads"]:
        tr = manifest.traffic(w["traffic"])
        assert callable(manifest.driver(tr["driver"]).request)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_files_under_paths_are_named_from_names():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*"), recursive=True):
        rel = os.path.relpath(path, ROOT)
        if "__pycache__" in rel:
            continue
        assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel


def test_a_cell_is_added_from_files_alone(tmp_path, small):
    """A copy of the benchmark gains a cell (a traffic file and its entry) and
    a per-layer metric (a reader and its entry); no file already there
    changes, and the new cell runs."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(p, "rb").read() for p in glob.glob(str(root / "benchmark" / "**" / "*"),
                                                         recursive=True) if os.path.isfile(p)}
    bench = manifest.load()
    bench["workloads"].append({"name": "search.short-pool", "config": "protein-search",
                               "traffic": "short-pool", "chips": 1,
                               "why": "a pool of three short queries"})
    bench["per_layer"].append({"name": "queries_answered.search", "unit": "queries",
                               "better": "higher", "source": "host_clock", "layer": "Entry",
                               "moves": "gcups", "workloads": ["search.short-pool"]})
    for m in bench["end_to_end"]:
        if m["name"] == "gcups":
            m["workloads"].append("search.short-pool")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "workloads" / "short-pool.json").write_text(json.dumps(
        {"driver": "search", "queries": {"lengths": [20, 30, 25], "order": "fixed"},
         "clients": 1, "check_requests": 1}))
    (root / "benchmark" / "metrics" / "queries_answered.search.py").write_text(
        "def read(run):\n    return float(len(run.done()))\n")
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
    small_cfg = small("search.long-queries")["config_overrides"]
    script = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {str(root / 'benchmark')!r}); sys.path.insert(1, {ROOT!r})\n"
        "import run as R\n"
        "out = []\n"
        "for trace in (False, True):\n"
        "    r = R.run_cell('search.short-pool', 5, 0.5, trace, torch.device('cpu'),\n"
        f"                   config_overrides={small_cfg!r})\n"
        "    out.append(R.result_line(r, {'platform': 'cpu'}))\n"
        "print(json.dumps(out))\n")
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, cwd=str(root))
    assert done.returncode == 0, done.stderr[-3000:]
    plain, traced = json.loads(done.stdout.strip().splitlines()[-1])
    assert plain["correct"] and "gcups" in plain["metrics"] and "setup_s" in plain["metrics"]
    assert traced["correct"] and traced["metrics"]["queries_answered.search"]["value"] >= 1


def test_forbidden_modules_by_whole_top_level_name():
    assert guard.forbidden_loaded({"aligner_tpu_torch": 1, "aligner_tpu_torch.align": 1,
                                   "jaxtyping": 1, "numpy": 1}) == []
    assert guard.forbidden_loaded({"jax.numpy": 1, "aligner_tpu.oracle": 1,
                                   "flax": 1, "jaxlib": 1}) == ["aligner_tpu", "flax", "jax",
                                                                 "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(*subdirs):
    for sub in subdirs:
        yield from glob.glob(os.path.join(BENCH_DIR, sub, "*.py"))


def test_nothing_a_run_loads_imports_the_jax_stack():
    files = list(_sources("harness", "reference", "drivers", "metrics")) + [
        os.path.join(BENCH_DIR, "run.py"), os.path.join(BENCH_DIR, "control.py")]
    for path in files:
        for name in _imports(path):
            assert guard.top(name) not in guard.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert guard.top(name) not in guard.FORBIDDEN | {guard.PROGRAM}, (path, name)
            assert guard.top(name) in {"numpy", "torch", "math", "dataclasses", "time",
                                       "__future__"}, (path, name)


def test_a_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                           "service.pvalue", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_a_run_in_a_directory_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "service.pvalue",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                          env=env)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "not in this checkout" in done.stderr
