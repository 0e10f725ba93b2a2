"""The PyTorch port's package: imports without JAX, its copied
framework-free layer (alphabets, matrices, FASTA I/O) equals the JAX
package's on the example files, and its logging set-up keeps to its own
logger."""

import logging
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.io import read_fasta_file as ref_read_fasta
from aligner_tpu_torch.io import read_fasta_file as port_read_fasta

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "aligner_tpu_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*.fasta"))


def test_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['aligner_tpu'] = None\n"
        "import aligner_tpu_torch, aligner_tpu_torch.cli.search\n"
        "import aligner_tpu_torch.ops.dp_fill, aligner_tpu_torch.ops.device_walk\n"
        "import aligner_tpu_torch.ops.wavefront, aligner_tpu_torch.parallel.wavefront_sp\n"
        "import aligner_tpu_torch.heuristic\n"
        "import aligner_tpu_torch.service.worker, aligner_tpu_torch.service.netstate\n"
        "import aligner_tpu_torch.service.updater, aligner_tpu_torch.service.blast_cmp\n"
        "import aligner_tpu_torch.cli.calc\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+aligner_tpu\b|"
                     r"from\s+aligner_tpu(\.|\s))", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_fasta_and_codecs_match_reference(path):
    a = ref_read_fasta(path)
    b = port_read_fasta(path)
    assert [(r.head, r.seq) for r in a] == [(r.head, r.seq) for r in b]
    for r in a:
        pa = ref.Protein.encode(r.seq, strict=True)
        pb = port.Protein.encode(r.seq, strict=True)
        assert pa.dtype == pb.dtype and np.array_equal(pa, pb)
        assert ref.Protein.decode(pa) == port.Protein.decode(pb)
        da = ref.DNA.encode_with_freqs_and_indices(r.seq)
        db = port.DNA.encode_with_freqs_and_indices(r.seq)
        assert np.array_equal(da[0], db[0]) and np.array_equal(da[1], db[1])
        assert ([(i.coord, i.offset, i.local_offset) for i in da[2]]
                == [(i.coord, i.offset, i.local_offset) for i in db[2]])


def test_matrices_match_reference(rng):
    assert np.array_equal(ref.blosum62(), port.blosum62())
    assert np.array_equal(ref.blosum50(), port.blosum50())
    assert ref.get_threshold(24) == port.get_threshold(24)
    assert np.array_equal(ref.random_pwm(9, np.random.default_rng(3)),
                          port.random_pwm(9, np.random.default_rng(3)))
    freqs = rng.dirichlet(np.ones(24))
    a = ref.transform_matrix(ref.blosum62(), 0.3, 40.0, freqs)
    b = port.transform_matrix(port.blosum62(), 0.3, 40.0, freqs)
    assert np.array_equal(a, b)


def test_configure_logging_keeps_to_the_package_logger(monkeypatch):
    """``ALIGNER_LOG`` sets the level of the ``aligner_tpu_torch`` logger;
    the root logger's level is untouched (the JAX package's
    ``configure_logging`` sets the root's)."""
    from aligner_tpu_torch.observability import configure_logging, log

    root = logging.getLogger()
    monkeypatch.setattr(root, "level", logging.ERROR)
    monkeypatch.setattr(log, "level", logging.NOTSET)
    monkeypatch.setenv("ALIGNER_LOG", "info")
    configure_logging()
    assert log.name == "aligner_tpu_torch" and log.level == logging.INFO
    assert root.level == logging.ERROR
    configure_logging("debug")
    assert log.level == logging.DEBUG and root.level == logging.ERROR
    monkeypatch.setenv("ALIGNER_LOG", "disable")  # names no level
    configure_logging()
    assert log.level == logging.WARNING and root.level == logging.ERROR
    monkeypatch.delenv("ALIGNER_LOG")
    configure_logging()
    assert log.level == logging.WARNING


def test_native_runtime_falls_back_to_the_cache(monkeypatch, tmp_path):
    """Where the package directory cannot take the native library (an
    installed package, a container image), the port builds it into
    ``~/.cache/aligner-tpu-torch/`` as the JAX package does into its own
    cache; then a local pair above the direct-plane budget runs on the
    native streaming engine and equals the oracle."""
    from aligner_tpu.align import align_local as ref_align_local
    from aligner_tpu_torch import native
    from aligner_tpu_torch.ops import wavefront as wf

    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("ALIGNER_NO_NATIVE", raising=False)
    pkg = tmp_path / "pkg"  # no prebuilt library, and no build succeeds there
    pkg.mkdir()
    monkeypatch.setattr(native, "_PKG_DIR", str(pkg))
    real_build = native._build
    monkeypatch.setattr(native, "_build",
                        lambda so: not so.startswith(str(pkg)) and real_build(so))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available()
    assert (home / ".cache" / "aligner-tpu-torch" / "_aligner_native.so").exists()
    assert not (pkg / "_aligner_native.so").exists()

    monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 100)
    rng = np.random.default_rng(4)
    q = rng.integers(0, 24, 40).astype(np.int8)
    t = q.copy()
    t[rng.integers(0, 40, 8)] = rng.integers(0, 24, 8)
    b62 = np.asarray(ref.blosum62())
    got = port.align_local(q, t, b62, 11.0, 2.0, device="cpu").alignment
    want = ref_align_local(q, t, b62, 11.0, 2.0, backend="oracle").alignment
    assert got.f == want.f
    assert np.array_equal(got.query, want.query) and np.array_equal(got.target, want.target)
    assert tuple(map(tuple, got.coords)) == tuple(map(tuple, want.coords))
