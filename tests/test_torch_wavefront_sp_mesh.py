"""The column-blocked pipeline on a mesh, in one process, on the CPU:
``sharded_global_end_score`` and ``sharded_global_align`` with a ``Mesh``
of 2, 3 and 4 CPU slots (grid (n, 1), and one (2, 2) grid, on which only
the data axis runs), on the engines ``"pallas"``, ``"band"`` and ``"lax"``
and both walks, against the JAX package's mesh form on conftest's virtual
devices (a mesh of the same data width) and the port's integer form on the
same blocks; the column block's width is cut to 256 (``CB_COLS``) so that a
slot owns several blocks.  Then the cases where a pipeline goes wrong first:
the end column on a slot's first column, pairs of 1 x k and k x 1, slots
with only padding, the refusals; the launches of the mesh form against the
integer form's; the route of ``align_global`` and ``global_end_score`` to
the pipeline when the auto-shard sees several devices; and the engine pick's
pipeline fill factor.  Tolerance: none.  Every value is an int32, a
direction code or a string and is compared for equality."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import aligner_tpu as ref_at
import aligner_tpu_torch as port
from aligner_tpu import host as ref_host
from aligner_tpu.ops import wavefront as ref_wf
from aligner_tpu.parallel import wavefront_sp as ref_sp
from aligner_tpu_torch import align as port_align
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.parallel import mesh as pm
from aligner_tpu_torch.parallel import wavefront_sp as sp

torch.set_num_threads(1)

B62 = np.asarray(port.blosum62())
ENGINES = ["pallas", "band", "lax"]
CB = 256  # the column block's width in these tests: several blocks a slot
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setattr(sp, "CB_COLS", CB)


def _mesh(d: int, m: int = 1) -> pm.Mesh:
    return pm.Mesh(("data", "matrix"), np.arange(d * m).reshape(d, m), (CPU,) * (d * m))


def _pair(seed, C, R):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 24, C).astype(np.int8), rng.integers(0, 24, R).astype(np.int8)


def _reference(q, t, data: int, tr: int, tb: int):
    """The JAX package's mesh form (``engine="lax"``) on ``data`` devices,
    checked against its host engine: ``(end, qa, ta, coords)``."""
    jmesh = JaxMesh(np.array(jax.devices()[:data]), ("data",))
    end = ref_sp.sharded_global_end_score(jmesh, q, t, B62, 11.0, 2.0, tr=tr, engine="lax")
    a = ref_sp.sharded_global_align(jmesh, q, t, B62, 11.0, 2.0, tr=tr, tb_rows=tb,
                                    engine="lax")
    o = ref_host.align_global(q, t, B62, 11.0, 2.0)
    assert end == a[0] == o.score[len(t), len(q)]
    assert np.array_equal(a[1], o.query_aligned) and np.array_equal(a[2], o.target_aligned)
    return a


def _same(got, want) -> bool:
    return (got[0] == want[0] and got[3] == want[3] and got[1].dtype == want[1].dtype
            and np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2]))


def _blocks(mesh, q, t, engine, tr, tb):
    """(n, Cb, every local slot's block range) of the mesh form's layout."""
    pp = sp._prep_sharded(mesh, q, t, B62, 11, 2, tr, tb, engine, None)
    return pp["n"], pp["Cb"], [list(r) for _, r in pp["layout"].slots]


# (data, matrix, C, R, blocks a slot): 2, 3 and 4 slots owning several
# blocks, ragged runs and a ragged last block; the (2, 2) grid runs on its
# data axis alone
GRIDS = [(2, 1, 1100, 150, [[0, 1, 2], [3, 4]]), (3, 1, 1200, 140, [[0, 1], [2, 3], [4]]),
         (4, 1, 1700, 130, [[0, 1], [2, 3], [4, 5], [6]]), (2, 2, 700, 120, [[0, 1], [2]])]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("d,m,C,R,runs", GRIDS, ids=[f"{d}x{m}-{C}" for d, m, C, *_ in GRIDS])
def test_mesh_equals_reference_and_integer_form(engine, d, m, C, R, runs):
    """Every engine, both walks: the mesh form equals the JAX package's mesh
    form and the port's integer form on the same blocks, bit for bit."""
    mesh = _mesh(d, m)
    q, t = _pair(C + R, C, R)
    n, Cb, got_runs = _blocks(mesh, q, t, engine, 32, 64)
    assert Cb == CB and got_runs == runs and n == runs[-1][-1] + 1
    want = _reference(q, t, d, 32, 64)
    for walk in ("device", "host"):
        on_mesh = sp.sharded_global_align(mesh, q, t, B62, 11, 2, tr=32, tb_rows=64,
                                          engine=engine, walk=walk)
        one = sp.sharded_global_align(n, q, t, B62, 11, 2, tr=32, tb_rows=64,
                                      engine=engine, walk=walk, device="cpu")
        assert _same(on_mesh, want) and _same(one, want)
    end = sp.sharded_global_end_score(mesh, q, t, B62, 11, 2, tr=32, engine=engine)
    assert end == sp.sharded_global_end_score(n, q, t, B62, 11, 2, tr=32, engine=engine,
                                              device="cpu") == want[0]


@pytest.mark.parametrize("engine", ENGINES)
def test_records_and_launches_equal_the_integer_form(engine, monkeypatch):
    """On 2 slots the forward's records (boundary history, checkpoint rows),
    the cursor and the step stream equal the integer form's, and so does
    every block fill called: the same blocks, the same ``tr``, the same
    calls; the second slot received one boundary a row block."""
    q, t = _pair(3, 1100, 200)
    calls = []
    for name in ("run_block_cs", "run_block_band"):
        real = getattr(wf, name)
        monkeypatch.setattr(wf, name, lambda *a, _real=real, _name=name, **k: (
            calls.append((_name, a[0].numel(), k.get("with_dirs"))), _real(*a, **k))[1])
    a = sp._sharded_walk(sp._prep_sharded(_mesh(2), q, t, B62, 11, 2, 32, 64, engine, None))
    mesh_calls, calls[:] = list(calls), []
    b = sp._sharded_walk(sp._prep_sharded(5, q, t, B62, 11, 2, 32, 64, engine, "cpu"))
    assert mesh_calls == calls and len(calls) > 0
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    J = b[5]["forward_blocks"] // 5
    assert a[5]["forward_blocks"] == b[5]["forward_blocks"]
    assert a[5]["handoffs"] == J and b[5]["handoffs"] == 0
    assert a[5]["gather_bytes"] == 0  # both slots are the one CPU device


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("C,R", [(513, 90), (769, 90), (257, 200)],
                         ids=["slot-first-column", "block-first-column", "block-a-slot"])
def test_end_column_on_a_slot_or_block_first_column(engine, C, R):
    """The end cell on the first column of a slot's run (513: blocks
    [0, 1] | [2], column 513 opens block 2 on slot 1), of a block inside a
    run (769: [0, 1] | [2, 3]), and of the second of two one-block slots
    (257)."""
    q, t = _pair(C * R, C, R)
    want = _reference(q, t, 2, 32, 64)
    got = sp.sharded_global_align(_mesh(2), q, t, B62, 11, 2, tr=32, tb_rows=64,
                                  engine=engine)
    assert _same(got, want)
    assert sp.sharded_global_end_score(_mesh(2), q, t, B62, 11, 2, tr=32,
                                       engine=engine) == want[0]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("C,R,d", [(1, 300, 2), (300, 1, 3), (1, 1, 2), (900, 1, 4),
                                   (120, 90, 4)],
                         ids=["1xk", "kx1", "1x1", "wide-one-row", "empty-slots"])
def test_thin_pairs_and_slots_with_only_padding(engine, C, R, d):
    """Pairs of 1 x k and k x 1, and pairs with fewer blocks than slots:
    the slots past the last block have only padding, take no boundary and
    hand none on, and the result is the reference's."""
    q, t = _pair(C + 7 * R, C, R)
    mesh = _mesh(d)
    n, _, runs = _blocks(mesh, q, t, engine, 16, 32)
    assert sum(map(len, runs)) == n and all(runs[i] for i in range(min(n, d)))
    want = _reference(q, t, d, 16, 32)
    for walk in ("device", "host"):
        assert _same(sp.sharded_global_align(mesh, q, t, B62, 11, 2, tr=16, tb_rows=32,
                                             engine=engine, walk=walk), want)
    assert sp.sharded_global_end_score(mesh, q, t, B62, 11, 2, tr=16,
                                       engine=engine) == want[0]


def _homolog(seed, L):
    """A pair aligned along its diagonal: the target is the query with a
    quarter of its positions substituted (no gap pays at del 11)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, L).astype(np.int8)
    t = q.copy()
    mask = rng.random(L) < 0.25
    t[mask] = rng.integers(0, 20, int(mask.sum()))
    return q, t


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("d", [2, 3, 4])
def test_a_diagonal_path_through_the_slots_corners(engine, d):
    """A 900 x 900 homologous pair: its path runs down the diagonal through
    the corner (x0, x0) of every block, a row-block boundary, so each step
    into a slot's first block reads the corner that slot carries from the
    row block above, not one its neighbour sends."""
    q, t = _homolog(d, 900)
    want = _reference(q, t, d, 32, 64)
    got = sp.sharded_global_align(_mesh(d), q, t, B62, 11, 2, tr=32, tb_rows=128,
                                  engine=engine)
    assert _same(got, want)
    assert sp.sharded_global_end_score(_mesh(d), q, t, B62, 11, 2, tr=32,
                                       engine=engine) == want[0]


def test_matrix_axis_runs_the_first_data_row():
    """``axis="matrix"`` places the blocks on the first data shard's row of
    a (2, 2) grid, and gives the same result."""
    q, t = _pair(5, 700, 100)
    mesh = _mesh(2, 2)
    pp = sp._prep_sharded(mesh, q, t, B62, 11, 2, 32, 64, None, None, axis="matrix")
    assert [list(r) for _, r in pp["layout"].slots] == [[0, 1], [2]]
    want = _reference(q, t, 2, 32, 64)
    assert _same(sp.sharded_global_align(mesh, q, t, B62, 11, 2, tr=32, tb_rows=64,
                                         axis="matrix"), want)


def test_data_slots_in_global_order(monkeypatch):
    """``data_slots`` on a mesh of 3 ranks of 4 devices, (6, 2): each rank
    owns 2 data shards, their first slots, and its neighbours are the ranks
    before and after it; the other axis runs on rank 0 alone."""
    grid = np.arange(12).reshape(6, 2)
    devs = tuple(torch.device("cpu", i) for i in range(4))
    for rank, left, right in ((0, None, 1), (1, 0, 2), (2, 1, None)):
        mesh = pm.Mesh(("data", "matrix"), grid, devs, object(), 3, rank)
        s = pm.data_slots(mesh)
        assert s.devices == (devs[0], devs[2]) and s.first == 2 * rank
        assert s.spans == ((0, 2), (2, 4), (4, 6)) and (s.left, s.right) == (left, right)
        assert s.total == 6
        s = pm.data_slots(mesh, "matrix")
        assert s.devices == (devs[:2] if rank == 0 else ())
        assert s.spans == ((0, 2), (2, 2), (2, 2)) and s.left is s.right is None


def test_refusals():
    """A mesh's data axis that the ranks cannot split, an axis the mesh does
    not have, a device beside a mesh and an axis without one are refused."""
    q, t = _pair(1, 300, 40)
    uneven = pm.Mesh(("data", "matrix"), np.arange(6).reshape(3, 2), (CPU,) * 3, object(), 2,
                     0)
    for fn in (sp.sharded_global_end_score, sp.sharded_global_align):
        with pytest.raises(port.ValidationError, match="equal span of whole data shards"):
            fn(uneven, q, t, B62, 11, 2)
        with pytest.raises(port.ValidationError, match="not 'rows'"):
            fn(_mesh(2), q, t, B62, 11, 2, axis="rows")
        with pytest.raises(port.ValidationError, match="pass no device"):
            fn(_mesh(2), q, t, B62, 11, 2, device="cpu")
        with pytest.raises(port.ValidationError, match="pass a Mesh"):
            fn(2, q, t, B62, 11, 2, device="cpu", axis="data")


# the route: a huge pair with several devices in the auto-shard's list


@pytest.fixture
def huge_is_small(monkeypatch):
    """A 300 x 250 pair counts as huge in both packages; the port's
    auto-shard sees two CPU devices for a device with no index (as the card
    with no index sees every card) and one for a named one."""
    monkeypatch.delenv("ALIGNER_AUTO_SHARD", raising=False)
    monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 4096)
    monkeypatch.setattr(ref_wf, "DIRECT_PLANE_CELLS", 4096)
    monkeypatch.setattr(port_align, "_shard_devices",
                        lambda device: [CPU, CPU] if device.index is None else [device])
    seen = []
    for name in ("sharded_global_align", "sharded_global_end_score"):
        real = getattr(sp, name)
        monkeypatch.setattr(sp, name, lambda where, *a, _real=real, **k: (
            seen.append(where), _real(where, *a, **k))[1])
    return seen


def test_huge_pair_with_several_devices_takes_the_pipeline(huge_is_small):
    """``align_global`` and ``global_end_score`` send the huge pair to the
    pipeline over a (2, 1) mesh of the two devices, as the JAX package sends
    it to its data mesh (``aligner_tpu/align.py:446``); the results equal
    the JAX package's bit for bit."""
    q, t = _pair(11, 300, 250)
    got = port.align_global(q, t, B62, 11.0, 2.0, device="cpu").alignment
    end = port.global_end_score(q, t, B62, 11.0, 2.0, device="cpu")
    assert len(huge_is_small) == 2
    for mesh in huge_is_small:
        assert isinstance(mesh, pm.Mesh) and mesh.grid.shape == (2, 1)
        assert mesh.devices == (CPU, CPU)
    want = ref_at.align_global(q, t, B62, 11.0, 2.0).alignment
    assert np.array_equal(got.query, want.query) and np.array_equal(got.target, want.target)
    assert tuple(map(tuple, got.coords)) == tuple(map(tuple, want.coords))
    assert end == ref_at.global_end_score(q, t, B62, 11.0, 2.0)


@pytest.mark.parametrize("how", ["named device", "ALIGNER_AUTO_SHARD=0"])
def test_one_device_keeps_the_old_route(huge_is_small, monkeypatch, how):
    """A named device and ``ALIGNER_AUTO_SHARD=0`` leave one device in the
    list: the huge pair stays on the single-plane routes (no pipeline call),
    with the same results."""
    device = torch.device("cpu", 0) if how == "named device" else "cpu"
    if how != "named device":
        monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")
    q, t = _pair(12, 300, 250)
    got = port.align_global(q, t, B62, 11.0, 2.0, device=device).alignment
    end = port.global_end_score(q, t, B62, 11.0, 2.0, device=device)
    assert huge_is_small == []
    o = ref_host.align_global(q, t, B62, 11.0, 2.0)
    assert np.array_equal(got.query, o.query_aligned)
    assert np.array_equal(got.target, o.target_aligned)
    assert end == o.score[250, 300]


def test_a_named_device_lists_itself():
    """The auto-shard's list (unpatched): the card alone for ``cuda:1``, the
    CPU alone, so the pipeline keeps every block on it."""
    assert port_align._shard_devices(torch.device("cuda", 1)) == [torch.device("cuda", 1)]
    assert port_align._shard_devices(CPU) == [CPU]
    assert port_align._pipeline_place(CPU) == (None, CPU)


# the engine pick's pipeline fill factor


@pytest.mark.parametrize("slots", [2, 3, 4, 8])
@pytest.mark.parametrize("qlen,tlen,n", [(524288, 524288, 4), (65536, 65536, 2),
                                         (262144, 262144, 2), (524288, 16384, 4)])
def test_auto_shard_config_fill_factor(qlen, tlen, n, slots):
    """On several slots the pick's rate is its engine's one-slot rate times
    J / (J + slots - 1), J the row blocks at its height, and no other
    candidate height (the row-scan engine's replay-tile doublings up to
    FORWARD_ROWS, the band engine's from 512) models faster."""
    cb = -(-qlen // n)
    r128 = -(-tlen // 128) * 128

    def factor(tr):
        j = -(-tlen // tr)
        return j / (j + slots - 1)

    for cap in (wf.BAND_ROWS, sp.TB_ROWS):
        e, tr, g = sp.auto_shard_config(qlen, tlen, n, max_band_tr=cap, slots=slots)
        one = (sp.rowscan_rate_model(cb, min(tr, r128)) if e == "pallas"
               else sp.band_rate_model(tr, cb))
        assert g == one * factor(tr)
        rows = [sp.rowscan_rate_model(cb, min(h, r128)) * factor(h)
                for h in (sp.TB_ROWS << k for k in range(4)) if h <= sp.FORWARD_ROWS]
        bands = [sp.band_rate_model(h, cb) * factor(h) for h in (512 << k for k in range(10))
                 if h <= min(cap, r128)]
        assert g == max(rows + bands)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_auto_shard_config_one_slot_is_unchanged(n):
    """On one slot the factor is 1 and every pick is the one-card pick: the
    row-scan engine at FORWARD_ROWS, or a taller-rated band."""
    for qlen, tlen in ((524288, 524288), (65536, 65536), (8192, 8192), (524288, 1000)):
        cb = max(-(-(-(-qlen // n)) // 128) * 128, 128)
        r128 = max(-(-tlen // 128) * 128, 128)
        for cap in (wf.BAND_ROWS, sp.TB_ROWS, 2048):
            best = ("pallas", sp.FORWARD_ROWS,
                    sp.rowscan_rate_model(cb, min(sp.FORWARD_ROWS, r128)))
            h = 512
            while h <= min(cap, r128):
                if sp.band_rate_model(h, cb) > best[2]:
                    best = ("band", h, sp.band_rate_model(h, cb))
                h *= 2
            assert sp.auto_shard_config(qlen, tlen, n, max_band_tr=cap) == best
            assert sp.auto_shard_config(qlen, tlen, n, max_band_tr=cap, slots=1) == best
