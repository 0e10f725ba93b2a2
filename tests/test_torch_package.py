"""The PyTorch port's package: imports without JAX, and its copied
framework-free layer (alphabets, matrices, FASTA I/O) equals the JAX
package's on the example files."""

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
