"""The port's column-blocked global pair against the JAX package, on the
CPU: the plain version of the column-block fill against the Pallas kernel
``run_block_cs`` in interpret mode (operands packed as
``parallel/wavefront_sp.py`` packs them), output by output; a grid of
blocks against the oracle's plane; ``sharded_global_end_score`` and
``sharded_global_align`` against the JAX functions with ``engine="pallas"``
on conftest's 8 virtual devices, the oracle and the port's single-plane
route; the replay walk with a column base; the rescoring of a walked path;
the routing of ``align_global`` and ``global_end_score``.  Tolerance: none.
Every value is an int32, a direction code or a string and is compared for
equality; cells of padded rows and columns are unspecified on both sides
and not compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.ops import wavefront as ref_wf
from aligner_tpu.parallel import wavefront_sp as ref_sp
from aligner_tpu_torch import oracle
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.parallel import wavefront_sp as sp

torch.set_num_threads(1)

B62 = np.asarray(port.blosum62())
DNA44 = np.array([[5, -4, -3, -4], [-4, 6, -4, -2], [-3, -4, 7, -4], [-4, -2, -4, 4]],
                 np.float64)  # asymmetric on purpose: catches a transposed lookup
SCORING = {"b62-11-2": (B62, 11, 2), "b62-7-3": (B62, 7, 3), "dna-5-2": (DNA44, 5, 2)}


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # align_global of the JAX package would otherwise shard over conftest's
    # 8 devices by itself; the sharded entry points get their mesh by hand
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()).reshape(-1), ("data",))


def _pair(seed, C, R, V=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, C).astype(np.int8), rng.integers(0, V, R).astype(np.int8)


def _related(seed, C, R, V=24):
    """A target that is the query with a quarter of its positions
    substituted, cut or extended to R: the walk follows the diagonal."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, V, C).astype(np.int8)
    t = np.resize(q, R).copy()
    mask = rng.random(R) < 0.25
    t[mask] = rng.integers(0, V, int(mask.sum()))
    return q, t


def _block_inputs(o, q, t, Cb, TR, j, d):
    """Block (j, d) of the oracle's plane as the block fill takes it: codes,
    the row above, the column to the left with its corner.  Slots of padded
    rows and columns are zero."""
    C, R = len(q), len(t)
    x0, y0 = d * Cb, j * TR
    n, rows = min(Cb, C - x0), min(TR, R - y0)
    qb, tb = np.zeros(Cb, np.int32), np.zeros(TR, np.int32)
    qb[:n], tb[:rows] = q[x0:x0 + n], t[y0:y0 + rows]
    h_prev, lb = np.zeros(Cb, np.int32), np.zeros(TR + 1, np.int32)
    h_prev[:n] = o.score[y0, x0 + 1:x0 + 1 + n]
    lb[:rows + 1] = o.score[y0:y0 + rows + 1, x0]
    return qb, tb, h_prev, lb, x0, y0, n, rows


def _pallas_block(qb, n, tb, h_prev, lb, x0, y0, C, R, m, d, e, with_dirs=True):
    """The JAX package's block kernel in interpret mode on the same block,
    its outputs flattened to the port's shapes."""
    V, Cb, TR = m.shape[0], len(qb), len(tb)
    S = Cb // ref_wf.LANES
    codes = np.where(np.arange(Cb) < n, qb, V)  # the reference pads columns with V
    pw = ref_wf.pack_query_words(jnp.asarray(codes.reshape(S, ref_wf.LANES)),
                                 jnp.asarray(ref_wf.pack_matrix_words(m)), V)
    outs = ref_wf.run_block_cs(
        pw, jnp.asarray(tb.reshape(1, TR)), jnp.asarray(h_prev.reshape(S, ref_wf.LANES)),
        jnp.asarray(lb.reshape(1, TR + 1)),
        jnp.asarray(np.array([[x0, y0, C, R]], np.int32)),
        S=S, TR=TR, V=V, del_=d, ext=e, interpret=True, with_dirs=with_dirs)
    words = np.asarray(outs[3]).reshape(TR // 16, Cb) if with_dirs else None
    return (np.asarray(outs[0]).reshape(Cb), np.asarray(outs[1]).reshape(TR),
            int(np.asarray(outs[2])[0, 0]), words)


# (C, R, Cb, TR): C on a block's last column and R on a block's last row;
# C on the first column of the last block; ragged both ways; one block
BLOCK_GRIDS = [(256, 64, 128, 32, "b62-11-2"), (257, 50, 128, 32, "b62-7-3"),
               (200, 33, 128, 16, "dna-5-2"), (100, 20, 128, 32, "b62-11-2")]


@pytest.mark.parametrize("C,R,Cb,TR,scoring", BLOCK_GRIDS,
                         ids=[f"{c}x{r}-{s}" for c, r, _, _, s in BLOCK_GRIDS])
def test_block_cs_plain_matches_pallas_kernel_and_plane(C, R, Cb, TR, scoring):
    """Every block of the grid, x0 and y_base zero and not, the block with
    cell (1,1) and the block that owns the end cell among them: the last
    row, the right column, the end cell and the direction words against the
    Pallas kernel, and all four against the oracle's plane."""
    m, d, e = SCORING[scoring]
    q, t = _pair(C * 100 + R, C, R, m.shape[0])
    o = oracle.align_global(q, t, m, float(d), float(e))
    mt = torch.as_tensor(m.astype(np.int32))
    for j in range(-(-R // TR)):
        for dd in range(-(-C // Cb)):
            qb, tb, h_prev, lb, x0, y0, n, rows = _block_inputs(o, q, t, Cb, TR, j, dd)
            got = wf.run_block_cs(*(torch.as_tensor(a) for a in (qb, tb)), mt,
                                  torch.as_tensor(h_prev), torch.as_tensor(lb), x0, y0, C,
                                  R, del_=d, ext=e, with_dirs=True, ckpt_every=16)
            h_new, rights, end, words, ckpts = (a.numpy() for a in got)
            h_r, rights_r, end_r, words_r = _pallas_block(qb, n, tb, h_prev, lb, x0, y0, C,
                                                          R, m, d, e)
            assert np.array_equal(h_new[:n], h_r[:n])
            assert int(end[0]) == end_r
            assert np.array_equal(words[:, :n], words_r[:, :n])
            owns = x0 < C <= x0 + Cb and y0 < R <= y0 + TR
            assert int(end[0]) == (o.score[R, C] if owns else 0)
            if x0 + Cb <= C:  # the right column is a real column
                assert np.array_equal(rights, rights_r)
                assert np.array_equal(rights[:rows], o.score[y0 + 1:y0 + 1 + rows, x0 + Cb])
            if y0 + TR <= R:
                assert np.array_equal(h_new[:n], o.score[y0 + TR, x0 + 1:x0 + 1 + n])
            assert ckpts.shape == (TR // 16, Cb)
            for k in range(rows // 16):  # the checkpoint rows inside the block
                assert np.array_equal(ckpts[k, :n],
                                      o.score[y0 + (k + 1) * 16, x0 + 1:x0 + 1 + n])
            dirs = wf._unpack_dir_words(words)[:rows, :n]
            assert np.array_equal(dirs, o.directions[y0 + 1:y0 + 1 + rows,
                                                     x0 + 1:x0 + 1 + n])


def test_block_cs_scores_only_and_refusals():
    q, t = _pair(5, 256, 32)
    o = oracle.align_global(q, t, B62, 11.0, 2.0)
    qb, tb, h_prev, lb, x0, y0, n, rows = _block_inputs(o, q, t, 128, 32, 0, 1)
    args = [torch.as_tensor(a) for a in (qb, tb, B62.astype(np.int32), h_prev, lb)]
    kw = dict(del_=11, ext=2)
    h_new, rights, end, words, ckpts = wf.run_block_cs(*args, x0, y0, 256, 32, **kw)
    assert words is None and ckpts is None and int(end) == o.score[32, 256]
    h_r, rights_r, end_r, none = _pallas_block(qb, n, tb, h_prev, lb, x0, y0, 256, 32, B62,
                                               11, 2, with_dirs=False)
    assert none is None and np.array_equal(h_new.numpy(), h_r)
    assert np.array_equal(rights.numpy(), rights_r) and int(end) == end_r
    with pytest.raises(TypeError):
        wf.run_block_cs(args[0].long(), *args[1:], x0, y0, 256, 32, **kw)
    with pytest.raises(ValueError):  # rows no multiple of 16
        wf.run_block_cs(args[0], args[1][:30], *args[2:], x0, y0, 256, 32, **kw)
    with pytest.raises(ValueError):  # the boundary needs TR + 1 slots
        wf.run_block_cs(*args[:4], args[4][:-1], x0, y0, 256, 32, **kw)
    with pytest.raises(ValueError):  # a cadence that does not divide the rows
        wf.run_block_cs(*args, x0, y0, 256, 32, **kw, ckpt_every=24)
    with pytest.raises(ValueError):  # codes out of range
        wf.run_block_cs(args[0] + 24, *args[1:], x0, y0, 256, 32, **kw)


# (C, R, column blocks, rows of a forward block, checkpoint cadence): a
# checkpoint after every forward block, after every second one, several
# inside one forward block, and the default forward block (the whole target)
GRIDS = [(600, 300, 3, 64, 64), (513, 130, 2, 32, 64), (256, 257, 1, 64, 32),
         (700, 100, 8, 48, 48), (520, 200, 3, None, 32)]


@pytest.mark.parametrize("C,R,n,tr,tb", GRIDS,
                         ids=[f"{c}x{r}-n{n}-tr{tr}-tb{tb}" for c, r, n, tr, tb in GRIDS])
def test_grid_of_blocks_matches_the_plane(C, R, n, tr, tb):
    """The forward fill's records against the oracle's plane: every left
    boundary a block consumed (each the right column of the block to its
    left), every checkpoint row (the last row of a forward block, or a row
    the block fill wrote inside a call) and the end score."""
    q, t = _pair(C + R, C, R)
    o = oracle.align_global(q, t, B62, 11.0, 2.0)
    pp = sp._prep_sharded(n, q, t, B62, 11, 2, tr, tb, None, "cpu")
    assert pp["tb"] == tb and pp["R_pad"] % max(pp["tr"], tb) == 0
    if tr is None:
        assert pp["J"] == 1 and pp["tr"] == -(-R // tb) * tb
    end, lb_hist, ckpts = sp._forward(pp, with_trace=True)
    assert int(end) == o.score[R, C]
    Cb = pp["Cb"]
    assert pp["n"] == -(-C // Cb) and lb_hist.shape == (pp["n"], pp["R_pad"])
    assert ckpts.shape == (pp["R_pad"] // tb, pp["C_pad"])
    for d in range(pp["n"]):
        assert np.array_equal(lb_hist[d, :R].numpy(), o.score[1:R + 1, d * Cb])
    for k in range(R // tb):
        assert np.array_equal(ckpts[k, :C].numpy(), o.score[(k + 1) * tb, 1:C + 1])


END_SHAPES = [(1000, 700, 64, 11, 2), (333, 190, 64, 11, 2), (1024, 257, 64, 11, 2),
              (7, 500, 32, 7, 3), (64, 64, 32, 7, 3), (129, 65, 32, 7, 3), (8, 8, 32, 7, 3)]


@pytest.mark.parametrize("C,R,tr,d,e", END_SHAPES,
                         ids=[f"{c}x{r}" for c, r, *_ in END_SHAPES])
def test_sharded_end_score_matches_reference(mesh, C, R, tr, d, e):
    """More blocks than the columns need, one row block, shapes that
    straddle block edges: the JAX pipeline on 8 devices, the oracle and the
    port's band engine."""
    q, t = _pair(C * 3 + R, C, R)
    got = sp.sharded_global_end_score(8, q, t, B62, d, e, tr=tr, device="cpu")
    want = ref_sp.sharded_global_end_score(mesh, q, t, B62, float(d), float(e), tr=tr,
                                           engine="pallas")
    assert got == want == oracle.align_global(q, t, B62, float(d), float(e)).score[R, C]
    assert got == wf.end_score_single_global_diag(q, t, B62, d, e, tb=128, device="cpu")
    assert got == sp.sharded_global_end_score(3, q, t, B62, d, e, engine="pallas",
                                              device="cpu")


ALIGN_SHAPES = [(1000, 700, 64, 11, 2), (333, 190, 64, 11, 2), (129, 257, 64, 11, 2),
                (64, 64, 64, 11, 2), (7, 500, 32, 7, 3), (8, 8, 32, 7, 3),
                (500, 30, 32, 7, 3)]


@pytest.mark.parametrize("C,R,tb,d,e", ALIGN_SHAPES,
                         ids=[f"{c}x{r}" for c, r, *_ in ALIGN_SHAPES])
def test_sharded_align_matches_reference(mesh, C, R, tb, d, e):
    """Strings, coordinates and end score against the JAX pipeline on 8
    devices and the oracle, on shapes that straddle row-block, column-block
    and checkpoint edges, with a path that crosses column blocks."""
    q, t = _pair(C * 5 + R, C, R)
    got = sp.sharded_global_align(8, q, t, B62, d, e, tr=32, tb_rows=tb, device="cpu")
    want = ref_sp.sharded_global_align(mesh, q, t, B62, float(d), float(e), tr=32,
                                       tb_rows=tb, engine="pallas")
    o = oracle.align_global(q, t, B62, float(d), float(e))
    assert got[0] == want[0] == o.score[R, C]
    assert got[3] == want[3] == ((1, C), (1, R))
    for x, y, z in zip(got[1:3], want[1:3], (o.query_aligned, o.target_aligned)):
        assert x.dtype == y.dtype and np.array_equal(x, y) and np.array_equal(x, z)


@pytest.mark.parametrize("C,R", [(300, 450), (520, 130), (130, 520)])
def test_sharded_align_matches_the_single_plane_route(C, R):
    q, t = _related(C + 2 * R, C, R)
    a = sp.sharded_global_align(3, q, t, B62, 11, 2, tr=64, tb_rows=128, device="cpu")
    # the default forward block, with its checkpoint rows written inside a call
    a2 = sp.sharded_global_align(3, q, t, B62, 11, 2, tb_rows=128, device="cpu")
    assert a[0] == a2[0] and all(np.array_equal(x, y) for x, y in zip(a[1:3], a2[1:3]))
    b = wf.align_single_global_chunked(q, t, B62, 11.0, 2.0, tb_rows=128, tr=16,
                                       device="cpu")
    assert a[0] == b[0] and a[3] == b[3]
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    pp = sp._prep_sharded(3, q, t, B62, 11, 2, 64, 128, None, "cpu")
    *_, info = sp._sharded_walk(pp)
    assert info["tb_rows"] == 128 and info["tr"] == 64 and info["syncs"] == info["tiles"] + 1
    assert info["tiles"] >= max(-(-R // 128), -(-C // pp["Cb"]))  # the path is diagonal


def test_replay_walk_with_a_column_base():
    """A tile's walk stops at the tile's left edge and reports a global
    column; a tile the cursor is not in is left alone."""
    C, R, Cb = 600, 128, 256
    q, t = _pair(9, C, R)
    t[:] = q[-R:]  # the end of the query: the path runs up the last diagonal
    pp = sp._prep_sharded(3, q, t, B62, 11, 2, 128, 128, None, "cpu")
    assert pp["Cb"] == Cb
    _, lb_hist, ckpts = sp._forward(pp, with_trace=True)
    o = oracle.align_global(q, t, B62, 11.0, 2.0)
    state, steps = wf.new_walk(R, C, pp["R_pad"] + pp["C_pad"] + 1, "cpu")
    tiles = {}
    for d in range(3):
        h0, lb = sp._tile_inputs(pp, lb_hist, ckpts, 0, d)
        tiles[d] = sp._block(pp, d, pp["t_dev"], h0, lb, 0, with_dirs=True)[3]
        n = min(Cb, C - d * Cb)
        assert np.array_equal(wf._unpack_dir_words(tiles[d].numpy())[:R, :n],
                              o.directions[1:R + 1, d * Cb + 1:d * Cb + n + 1])
    for d in (0, 1):  # foreign tiles: the cursor is in column block 2
        wf.replay_walk(tiles[d], state, steps, row_base=0, col_base=d * Cb)
        assert state.tolist() == [R, C, 0] and bool((steps == -1).all())
    wf.replay_walk(tiles[2], state, steps, row_base=0, col_base=2 * Cb)
    cy, cx, n = state.tolist()
    assert cx == 2 * Cb and 0 < cy < R and n >= C - 2 * Cb  # left by the left edge
    wf.replay_walk(tiles[2], state, steps, row_base=0, col_base=2 * Cb)  # not its column
    assert state.tolist() == [cy, cx, n]
    while cy > 0 and cx > 0:  # on through the tiles to the left, to a border
        d = (cx - 1) // Cb
        wf.replay_walk(tiles[d], state, steps, row_base=0, col_base=d * Cb)
        cy, cx, n = state.tolist()
        assert cy == 0 or cx == d * Cb
    qa, ta, _ = wf._assemble(pp, state, steps)
    assert np.array_equal(qa, o.query_aligned) and np.array_equal(ta, o.target_aligned)


def _walk(q, t, m, d, e):
    """(end score, packed steps, step count) of the port's walk."""
    pp = wf._prep(q, t, m, d, e, "cpu")
    end, _, state, steps, _ = wf._chunked_walk(pp, 64, 16, True)
    return int(end), steps.numpy(), int(state[2]), state.tolist()[:2]


W = int(np.argmax(np.diag(B62)))  # the residue with the highest self-score
HARSH = np.where(np.eye(4) > 0, 5.0, -100.0)  # a mismatch costs more than any gap
# name: (query, target, matrix, del, ext, where the walk meets the border)
RESCORE = {
    "random": (*_pair(1, 90, 70), B62, 11, 2, (0, 0)),
    "related": (*_related(2, 200, 230), B62, 11, 2, (0, 0)),
    "dna": (*_pair(3, 77, 120, 4), DNA44, 5, 2, (0, 0)),
    "identical": (*(_pair(6, 50, 1)[0],) * 2, B62, 11, 2, (0, 0)),
    # one strong match in the last column or row: the walk leaves the plane
    # on the border row, or on the border column
    "border-row": (np.array([0, W], np.int8), np.array([W], np.int8), B62, 11, 2, (0, 1)),
    "border-column": (np.array([W], np.int8), np.array([0, W], np.int8), B62, 11, 2,
                      (1, 0)),
    # a gap step at cell (1,1), the cell whose penalty is del, onto H[0, C],
    # the far corner
    "far-corner": (np.array([0], np.int8), np.array([1], np.int8), HARSH, 11, 2, (0, 1)),
}


@pytest.mark.parametrize("case", sorted(RESCORE))
def test_rescore_steps_equals_the_end_score(case):
    q, t, m, d, e, border = RESCORE[case]
    end, packed, n, cursor = _walk(q, t, m, d, e)
    o = oracle.align_global(q, t, m, float(d), float(e))
    assert end == o.score[len(t), len(q)] and tuple(cursor) == border
    assert wf.rescore_steps(packed, n, q, t, m, d, e) == end
    # the aligned strings give the same stream back
    packed2, n2 = wf.alignment_steps(o.query_aligned, o.target_aligned)
    assert n2 == n and np.array_equal(packed2, packed[:len(packed2)])


def test_rescore_steps_on_every_tiny_pair():
    """Every pair of up to 3 x 3 over two letters under a matrix whose
    mismatch costs more than any gap: walks made of gap steps, through cell
    (1,1) and along both borders."""
    seen = set()
    for C in (1, 2, 3):
        for R in (1, 2, 3):
            for bits in range(2 ** (C + R)):
                q = np.array([(bits >> k) & 1 for k in range(C)], np.int8)
                t = np.array([(bits >> (C + k)) & 1 for k in range(R)], np.int8)
                end, packed, n, cursor = _walk(q, t, HARSH, 11, 2)
                assert end == oracle.align_global(q, t, HARSH, 11.0, 2.0).score[R, C]
                assert wf.rescore_steps(packed, n, q, t, HARSH, 11, 2) == end
                seen.add(tuple(cursor))
    assert {(0, 0), (0, 1), (1, 0)} <= seen


def test_rescore_steps_takes_the_border_values_with_their_far_corners():
    """Paths that are real but far from optimal: all the way left along the
    last row to H[R, 0], all the way up the last column to H[0, C]."""
    q, t = _pair(11, 3, 2)
    end = oracle.align_global(q, t, B62, 11.0, 2.0).score[2, 3]
    left = wf._pack_step_codes(np.array([wf.LEFT] * 3 + [wf.BEG] * 13, np.uint8))
    assert wf.rescore_steps(left, 3, q, t, B62, 11, 2) == -3 * 2 - (2 + 1) * 11 < end
    up = wf._pack_step_codes(np.array([wf.TOP] * 2 + [wf.BEG] * 14, np.uint8))
    assert wf.rescore_steps(up, 2, q, t, B62, 11, 2) == -2 * 2 - (3 + 1) * 11 < end
    # the same runs one row or column in: plain border values, and the last
    # step, at cell (1,1), costs del
    one = wf._pack_step_codes(np.array([wf.TOP] + [wf.LEFT] * 3 + [wf.BEG] * 12, np.uint8))
    assert wf.rescore_steps(one, 4, q, t, B62, 11, 2) == -2 - 2 * 2 - 11 - 1 * 11


def test_rescore_steps_scores_a_worse_path_lower():
    """A real but suboptimal path scores below the end score; a stream that
    is no walk to a border is refused."""
    q, t = _related(10, 120, 120)
    end, packed, n, _ = _walk(q, t, B62, 11, 2)
    codes = wf._unpack_step_words(packed, len(packed) * 16).copy()
    k = int(np.flatnonzero(codes[:n] == wf.DIAG)[5])
    worse = np.concatenate([codes[:k], [wf.TOP, wf.LEFT], codes[k + 1:-1]])
    assert wf.rescore_steps(wf._pack_step_codes(worse), n + 1, q, t, B62, 11, 2) < end
    with pytest.raises(ValueError):  # stops inside the plane
        wf.rescore_steps(packed, n - 3, q, t, B62, 11, 2)
    longer = np.concatenate([codes[:n], [wf.DIAG], codes[n + 1:]])
    with pytest.raises(ValueError):  # goes on past the border
        wf.rescore_steps(wf._pack_step_codes(longer), n + 1, q, t, B62, 11, 2)


@pytest.mark.parametrize("C,R", [(300, 200), (90, 400)])
def test_wide_pairs_take_the_column_blocked_route(monkeypatch, C, R):
    """With the width cap set small, ``align_global`` and
    ``global_end_score`` go through the column-blocked pipeline by the
    pair's width alone and equal the reference."""
    from aligner_tpu_torch import align as port_align

    monkeypatch.setattr(wf, "MAX_WIDTH", 64)
    monkeypatch.setattr(sp, "CB_COLS", 256)
    monkeypatch.setattr(sp, "TB_ROWS", 64)
    calls = []
    for name in ("sharded_global_align", "sharded_global_end_score"):
        real = getattr(sp, name)
        monkeypatch.setattr(sp, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    assert port_align._route_sharded_pair(C, R, B62, 11.0, 2.0, backend=None, auto=True)
    q, t = _related(C + R, C, R)
    a = port.align_global(q, t, B62, 11.0, 2.0, device="cpu").alignment
    b = ref.align_global(q, t, B62, 11.0, 2.0, backend="oracle").alignment
    assert np.array_equal(a.query, b.query) and np.array_equal(a.target, b.target)
    assert a.coords == b.coords and a.f == 0.0
    s = port.global_end_score(q, t, B62, 11.0, 2.0, device="cpu")
    assert s == ref.global_end_score(q, t, B62, 11.0, 2.0, backend="host")
    assert calls == ["sharded_global_align", "sharded_global_end_score"]


def test_backend_wavefront_sp_on_a_narrow_pair(mesh):
    q, t = _related(21, 140, 100)
    a = port.align_global(q, t, B62, 11.0, 2.0, backend="wavefront_sp",
                          device="cpu").alignment
    b = port.align_global(q, t, B62, 11.0, 2.0, device="cpu").alignment
    assert np.array_equal(a.query, b.query) and np.array_equal(a.target, b.target)
    assert a.coords == b.coords
    want = ref_sp.sharded_global_align(mesh, q, t, B62, 11.0, 2.0, engine="pallas")
    assert np.array_equal(a.query, want[1]) and np.array_equal(a.target, want[2])
    s = port.global_end_score(q, t, B62, 11.0, 2.0, backend="wavefront_sp", device="cpu")
    assert s == want[0] == port.global_end_score(q, t, B62, 11.0, 2.0, device="cpu")


def test_column_blocked_route_refusals(monkeypatch):
    z8 = np.zeros(8, np.int8)
    half = np.full((24, 24), 0.5)  # non-integral
    wide = np.full((24, 24), 200.0)  # integral, beyond int8: the "lax" engine takes it
    huge = np.full((24, 24), 2.0**27)  # 8 x 2^27 = 2^30: past the range guard
    for fn in (port.align_global, port.global_end_score):
        with pytest.raises(port.ValidationError, match="integral"):
            fn(z8, z8, half, 11.0, 2.0, backend="wavefront_sp", device="cpu")
        with pytest.raises(port.ValidationError, match="int32"):
            fn(z8, z8, huge, 11.0, 2.0, backend="wavefront_sp", device="cpu")
        for e in (np.zeros(0, np.int8), ):
            with pytest.raises(port.ResultIsEmpty):
                fn(e, z8, B62, 11.0, 2.0, backend="wavefront_sp", device="cpu")
    want = ref.align_global(z8, z8, wide, 11.0, 2.0, backend="oracle").alignment
    got = port.align_global(z8, z8, wide, 11.0, 2.0, backend="wavefront_sp",
                            device="cpu").alignment
    assert np.array_equal(got.query, want.query) and np.array_equal(got.target, want.target)
    assert port.global_end_score(z8, z8, wide, 11.0, 2.0, backend="wavefront_sp",
                                 device="cpu") == 8 * 200.0
    with pytest.raises(ref.ValidationError) as want:
        ref.align_global(z8, z8, half, 11.0, 2.0, backend="wavefront_sp")
    with pytest.raises(port.ValidationError) as got:
        port.align_global(z8, z8, half, 11.0, 2.0, backend="wavefront_sp", device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(port.ValidationError, match="unknown backend"):
        port.align_global(z8, z8, B62, 11.0, 2.0, backend="nope", device="cpu")
    for fn in (sp.sharded_global_align, sp.sharded_global_end_score):
        with pytest.raises(ValueError):
            fn(2, np.zeros(0, np.int8), z8, B62, 11, 2, device="cpu")
        with pytest.raises(port.ValidationError):
            fn(2, z8, z8, half, 11, 2, device="cpu")
        with pytest.raises(port.ValidationError, match="unknown engine"):
            fn(2, z8, z8, B62, 11, 2, engine="nope", device="cpu")
        # refused by its length alone, before any per-element work
        t_huge = np.broadcast_to(np.int8(0), (2**30 // 11,))
        with pytest.raises(port.ValidationError, match="int32"):
            fn(2, z8, t_huge, B62, 11, 2, device="cpu")
    # a pair wider than one plane with a matrix beyond int8 is aligned by
    # its width alone; past the range guard the route declines it
    from aligner_tpu_torch import align as port_align

    monkeypatch.setattr(wf, "MAX_WIDTH", 4)
    want = ref.align_global(z8, z8, wide, 11.0, 2.0, backend="oracle").alignment
    got = port.align_global(z8, z8, wide, 11.0, 2.0, device="cpu").alignment
    assert np.array_equal(got.query, want.query) and np.array_equal(got.target, want.target)
    assert port.global_end_score(z8, z8, wide, 11.0, 2.0, device="cpu") == 8 * 200.0
    assert port_align._route_sharded_pair(8, 8, wide, 11.0, 2.0, backend=None, auto=True)
    assert not port_align._route_sharded_pair(8, 8, huge, 11.0, 2.0, backend=None,
                                              auto=True)
