"""The port's multi-process runtime (``aligner_tpu_torch.parallel.multihost``)
with real processes: two gloo ranks on the CPU, each with 2 CPU shards of a
(2, 2) mesh, run the mesh steps on their ``process_span`` blocks
(``tests/torch_multihost_proc.py``); what they gather is held against the
one-process steps of the port and the JAX package (the first half of
``tests/test_multihost.py::test_two_process_jax_distributed``).  Scores, best
matrices and indices bit for bit; the window statistics to a relative 1e-12
in float64 (equal on both ranks).  The same ranks, and four of one shard
each, run the column-blocked pipeline on their mesh (its second half: the
right boundary handed across the ranks, the end score reduced, the trace
records gathered): every rank's end score, strings and coordinates equal
the others', the JAX package's mesh form and its host engine, bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import Mesh

from aligner_tpu import host as ref_host
from aligner_tpu.parallel import mesh as ref
from aligner_tpu.parallel import wavefront_sp as ref_sp
from aligner_tpu_torch.matrices import blosum62
from aligner_tpu_torch.parallel import mesh as pm
from aligner_tpu_torch.parallel import multihost
from torch_multihost_proc import (ENGINES, POP_B, UNEVEN, WAVEFRONT_PAIRS, WF_TB, WF_TR,
                                  inputs, local_block, one_process, run_ranks,
                                  wavefront_pair)

torch.set_num_threads(1)

RANK_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ranks") / "ranks.json", "cpu",
                     timeout=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def one():
    """The one-process steps: the port on a 4-slot CPU mesh, the JAX package
    on conftest's 8 virtual devices (its population on a 4-device mesh)."""
    x = inputs()
    out = one_process("cpu")
    jmesh = ref.make_mesh(8)
    pair = (x["q"], x["ql"], x["t"], x["tl"])
    out.update(
        jax_scores=ref.sharded_scores(jmesh, *pair, x["m"], 11.0, 2.0, dtype=jnp.float64,
                                      engine="xla"),
        jax_scan=ref.window_scan_step(jmesh, *out["windows"], x["pwm"], 3.0, 1.0,
                                      dtype=jnp.float64, engine="xla"),
        jax_population=ref.matrix_population_step(
            ref.make_mesh(4), *out["pop"], x["mats"], 7.0, 3.0, dtype=jnp.float64))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("four") / "ranks.json", "cpu", n=4, shards=1,
                     timeout=RANK_TIMEOUT_S)


def _wavefront_reference(data_slots: int) -> dict:
    """Each pair of the ranks' pipeline through the JAX package's mesh form
    (``engine="lax"``, the ranks' ``tr`` and ``tb_rows``, a mesh of the
    ranks' data width) and its host engine: ``{"CxR": (end, qa, ta,
    coords)}``, the end equal in both."""
    jmesh = Mesh(np.array(jax.devices()[:data_slots]), ("data",))
    m = np.asarray(blosum62())
    out = {}
    for C, R, _ in WAVEFRONT_PAIRS:
        q, t = wavefront_pair(C, R)
        end = ref_sp.sharded_global_end_score(jmesh, q, t, m, 11.0, 2.0, tr=WF_TR,
                                              engine="lax")
        a = ref_sp.sharded_global_align(jmesh, q, t, m, 11.0, 2.0, tr=WF_TR, tb_rows=WF_TB,
                                        engine="lax")
        o = ref_host.align_global(q, t, m, 11.0, 2.0)
        assert end == a[0] == o.score[R, C]
        assert np.array_equal(a[1], o.query_aligned) and np.array_equal(a[2], o.target_aligned)
        out[f"{C}x{R}"] = (end, a[1].tolist(), a[2].tolist(), [list(c) for c in a[3]])
    return out


def _check_wavefront(ranks, data_slots: int) -> None:
    """Every rank's runs are the first rank's, and each equals the
    reference: every engine's end score, and both walks' alignments.  Every
    rank but the first received boundaries, and every rank gathered the
    others' records (the counters ``cpu/wavefront-sp-handoff`` and
    ``-gather``, whose cells count boundaries and bytes)."""
    want = _wavefront_reference(data_slots)
    for i, r in enumerate(ranks):
        assert r["wavefront"] == ranks[0]["wavefront"]
        counted = r["wavefront_counters"]
        assert ("cpu/wavefront-sp-handoff" in counted) == (i > 0)
        assert counted["cpu/wavefront-sp-gather"][1] > 0
    for pair, runs in ranks[0]["wavefront"].items():
        end, qa, ta, coords = want[pair]
        assert [run["engine"] for run in runs] == list(ENGINES)
        for run in runs:
            assert run["end"] == end
            assert run["alignments"] == [[end, qa, ta, coords]] * 2


def test_two_ranks_column_blocked_pipeline(ranks):
    """Two ranks, the data axis of their (2, 2) mesh: the 96-column pair is
    one block on rank 0 (rank 1's slot has only padding and joins the
    reduce and the gather); the 1,100-column pair is 5 blocks of 256, 3 on
    rank 0 and 2 on rank 1, every row block's boundary handed across."""
    _check_wavefront(ranks, 2)


def test_four_ranks_column_blocked_pipeline(four_ranks):
    """Four ranks of one slot each, a (4, 1) mesh: the 1,100-column pair's 5
    blocks lie 2, 1, 1, 1, each boundary handed through three ranks."""
    _check_wavefront(four_ranks, 4)


def test_two_ranks_sharded_scores(ranks, one):
    assert [r["span"] for r in ranks] == [[0, 8], [8, 16]]
    assert [r["mesh"] for r in ranks] == [[2, 2]] * 2
    for r in ranks:
        for got, want, jwant in zip(r["scores"], one["scores"],
                                    one["jax_scores"]):
            np.testing.assert_array_equal(np.asarray(got), want.numpy())
            np.testing.assert_array_equal(np.asarray(got), np.asarray(jwant))


def test_two_ranks_uneven_batch_in_the_original_order(ranks, one):
    """15 rows over 2 ranks: rank 1's block holds 7 rows and one of
    padding; the layout gathers the 15 results back in the original row
    order (the reference returns the padded per-process blocks and leaves
    the reordering to its callers)."""
    for r in ranks:
        assert r["uneven_layout"] == [[[0, 8], [8, 15]], 8, 15]
        assert r["uneven_block_rows"] == 8
        for got, want in zip(r["uneven_scores"], one["scores"]):
            np.testing.assert_array_equal(np.asarray(got), want.numpy()[:UNEVEN])


def test_two_ranks_window_scan_step(ranks, one):
    """The statistics summed across ranks by ``all_reduce``: equal on both
    ranks, and to the one-process steps."""
    a, b = (r["scan"] for r in ranks)
    assert a == b
    scores, z, mean, std = one["scan"]
    jscores, jz, jmean, jstd = one["jax_scan"]
    np.testing.assert_array_equal(np.asarray(a["scores"]), scores.numpy()[:UNEVEN])
    np.testing.assert_array_equal(np.asarray(a["scores"]), np.asarray(jscores)[:UNEVEN])
    for want in ((z, mean, std), (jz, jmean, jstd)):
        np.testing.assert_allclose(np.asarray(a["z"]), np.asarray(want[0])[:UNEVEN],
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose([a["mean"], a["std"]],
                                   [float(want[1]), float(want[2])], rtol=1e-12, atol=0)


def test_two_ranks_matrix_population_step(ranks, one):
    best, win = one["population"]
    jbest, jwin = one["jax_population"]
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["population"][0]), best.numpy())
        np.testing.assert_array_equal(np.asarray(r["population"][1]), win.numpy())
        np.testing.assert_array_equal(np.asarray(r["population"][0]),
                                      np.asarray(jbest)[:POP_B])
        np.testing.assert_array_equal(np.asarray(r["population"][1]),
                                      np.asarray(jwin)[:POP_B])


@pytest.mark.parametrize("value", [None, "1"], ids=["absent", "one"])
def test_initialize_from_env_single_process_is_a_no_op(monkeypatch, value):
    import torch.distributed as dist

    if value is None:
        monkeypatch.delenv("ALIGNER_NUM_PROCESSES", raising=False)
    else:
        monkeypatch.setenv("ALIGNER_NUM_PROCESSES", value)
    monkeypatch.delenv("ALIGNER_COORDINATOR", raising=False)
    multihost.initialize_from_env()
    assert not dist.is_initialized()
    assert multihost.process_span(10) == (0, 10)
    mesh = multihost.global_mesh(devices=["cpu"] * 2)
    assert mesh.group is None and mesh.shape == {"data": 2, "matrix": 1}


def test_one_process_layout_and_refusals():
    """Without a group the block is padded to a multiple of the data shards
    and the layout gives back its real rows; a block that is not this
    process's span, and a result of another size than the blocks, are
    refused."""
    from aligner_tpu_torch.errors import ValidationError

    mesh = pm.make_mesh(4, devices=["cpu"] * 4)  # (2, 2): 2 data shards
    block, lay = multihost.shard_local_batch(mesh, np.arange(5), global_rows=5)
    assert block.tolist() == [0, 1, 2, 3, 4, 0] and lay.per_pad == 6
    assert lay.gather(torch.arange(6)).tolist() == [0, 1, 2, 3, 4]
    block, lay = multihost.shard_local_batch(mesh, torch.ones(3, 2))
    assert tuple(block.shape) == (4, 2) and block[3].sum() == 0 and lay.global_rows == 3
    with pytest.raises(ValidationError, match="share of 6"):
        multihost.shard_local_batch(mesh, np.arange(5), global_rows=6)
    with pytest.raises(ValidationError, match="a block of 5 rows"):
        lay.gather(torch.arange(5))


def test_four_ranks_one_shard_each(four_ranks, one):
    """Four ranks of one shard each (a card a rank, as under NCCL): a (4, 1)
    mesh, every data shard within one process; the gathered steps equal the
    one-process ones (the window statistics to a relative 1e-12, its sums
    taken in another order)."""
    ranks = four_ranks
    assert [r["mesh"] for r in ranks] == [[4, 1]] * 4
    assert [r["uneven_layout"][1] for r in ranks] == [4] * 4  # ceil(15 / 4) rows a rank
    scores, z, mean, std = one["scan"]
    best, win = one["population"]
    for r in ranks:
        for got, want in zip(r["scores"], one["scores"]):
            np.testing.assert_array_equal(np.asarray(got), want.numpy())
        for got, want in zip(r["uneven_scores"], one["scores"]):
            np.testing.assert_array_equal(np.asarray(got), want.numpy()[:UNEVEN])
        assert r["scan"] == ranks[0]["scan"]
        np.testing.assert_array_equal(np.asarray(r["scan"]["scores"]), scores.numpy()[:UNEVEN])
        np.testing.assert_allclose(np.asarray(r["scan"]["z"]), z.numpy()[:UNEVEN],
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose([r["scan"]["mean"], r["scan"]["std"]],
                                   [float(mean), float(std)], rtol=1e-12, atol=0)
        np.testing.assert_array_equal(np.asarray(r["population"][0]), best.numpy())
        np.testing.assert_array_equal(np.asarray(r["population"][1]), win.numpy())


@pytest.mark.parametrize("ranks, local, shape", [
    (4, 1, (4, 1)), (8, 1, (8, 1)), (2, 2, (2, 2)), (3, 4, (6, 2)), (2, 8, (4, 4))])
def test_global_mesh_keeps_each_data_shard_in_one_process(monkeypatch, ranks, local,
                                                           shape):
    """``global_mesh``'s grid at other world sizes (the group's size and
    rank given, no group started): ``matrix`` divides the local device
    count, so every rank owns whole data shards and its block of an uneven
    batch takes the steps."""
    monkeypatch.setattr(multihost, "_world", lambda: (ranks, ranks - 1))
    mesh = multihost.global_mesh(devices=["cpu"] * local)
    assert mesh.grid.shape == shape and mesh.process_index == ranks - 1
    grid = mesh.local_grid()
    assert len(grid) == shape[0] // ranks and all(len(g) == shape[1] for g in grid)
    x = inputs()
    lo, hi = multihost.process_span(UNEVEN)
    (q, ql, t, tl), lay = local_block(mesh, (x["q"], x["ql"], x["t"], x["tl"]), UNEVEN)
    assert lay.per_pad % len(grid) == 0 and len(q) == lay.per_pad
    fmax = pm.sharded_scores(mesh, q, ql, t, tl, x["m"], 11.0, 2.0,
                             dtype=torch.float64)[0]
    want = pm.sharded_scores(pm.make_mesh(1, devices=["cpu"]), x["q"][lo:hi],
                             x["ql"][lo:hi], x["t"][lo:hi], x["tl"][lo:hi], x["m"], 11.0,
                             2.0, dtype=torch.float64)[0]
    np.testing.assert_array_equal(fmax[:hi - lo].numpy(), want.numpy())
