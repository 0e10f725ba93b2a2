"""The port's huge-global-pair path against the JAX package, on the CPU:
the plain version of the row-scan fill (end cell, directions,
checkpoints, replayed blocks), the replay walk with its block loop,
``align_single_global_chunked``, ``align_global``/``align_local`` with
their routing and errors, and the ``aligner-align`` CLI.  The JAX side
runs its Pallas kernel in interpret mode, as ``tests/test_wavefront.py``
does.  Tolerance: none.  Scores, direction codes, step words and aligned
strings are integers and strings, compared for equality; padded rows and
columns are unspecified on both sides and not compared.  Also pins that
``device=None`` means the card and raises without one."""

import contextlib
import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu.cli import align as ref_cli
from aligner_tpu.ops import wavefront as ref_wf
from aligner_tpu_torch import oracle
from aligner_tpu_torch.cli import align as port_cli
from aligner_tpu_torch.cli import repeat_search as port_cli_repeat
from aligner_tpu_torch.cli import search as port_cli_search
from aligner_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
B62 = np.asarray(port.blosum62())
DNA44 = np.array([[5, -4, -3, -4], [-4, 6, -4, -2], [-3, -4, 7, -4], [-4, -2, -4, 4]],
                 np.float64)  # asymmetric on purpose: catches a transposed lookup
SCORING = {"blosum62": (B62, 11.0, 2.0), "dna": (DNA44, 5.0, 2.0)}


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the JAX side would otherwise see conftest's 8 devices and shard
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def _pair(seed, C, R, V):
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


# widths at and around the 128- and 256-column seams, rows that are no
# multiple of 16 or of the tile
SHAPES = [(1, 1), (1, 37), (127, 40), (128, 33), (129, 70), (257, 21), (60, 130),
          (299, 97)]


@pytest.mark.parametrize("scoring", ["blosum62", "dna"])
@pytest.mark.parametrize("C,R", SHAPES, ids=[f"{c}x{r}" for c, r in SHAPES])
def test_row_scan_plain_matches_reference_fill(C, R, scoring):
    m, d, e = SCORING[scoring]
    q, t = _pair(C * 1000 + R, C, R, m.shape[0])
    end, dirs = wf.fill_single_global(q, t, m, d, e, device="cpu")
    end_r, dirs_r = ref_wf.fill_single_global(q, t, m, d, e, interpret=True)
    assert end == end_r
    assert dirs.dtype == dirs_r.dtype and np.array_equal(dirs, dirs_r)
    o = oracle.align_global(q, t, m, d, e)
    assert end == o.score[R, C] and np.array_equal(dirs, o.directions)
    end_s, none = wf.fill_single_global(q, t, m, d, e, with_dirs=False, device="cpu")
    assert none is None and end_s == end


def _jax_forward(q, t, m, d, e, TB, tr):
    """The JAX package's forward fill with checkpoints, as
    ``align_single_global_chunked`` runs it: (pp, padded target, ckpts)."""
    pp = ref_wf._prep(q, t, m, d, e)
    R_pad = -(-len(t) // TB) * TB
    tp = np.zeros(R_pad, np.int32)
    tp[: len(t)] = t
    outs = ref_wf._run(
        pp["q_tile"], jnp.asarray(tp.reshape(R_pad // tr, 1, tr)), pp["pmat"],
        jnp.zeros((pp["S"], ref_wf.LANES), jnp.int32), S=pp["S"], TR=tr, V=pp["V"],
        C_real=len(q), R_real=len(t), del_=int(d), ext=int(e), with_dirs=False,
        interpret=True, ckpt_every=TB,
    )
    return pp, tp, outs


@pytest.mark.parametrize("C,R,TB", [(45, 128, 32), (130, 97, 32), (257, 70, 16)])
def test_checkpoints_and_replayed_blocks(C, R, TB):
    q, t = _pair(C + R, C, R, 24)
    pp_r, _, outs = _jax_forward(q, t, B62, 11.0, 2.0, TB, 16)
    ck_r = np.asarray(outs[1]).reshape(-1, pp_r["C_pad"])[:, :C]
    pp = wf._prep(q, t, B62, 11.0, 2.0, "cpu")
    t_dev = torch.as_tensor(wf._pad_rows(pp["t"], TB))
    end, _, ckpts = wf._scan(pp, t_dev, None, 0, with_dirs=False, ckpt_every=TB, tr=16,
                             check_codes=True)
    assert int(end) == int(np.asarray(outs[0])[0, 0])
    assert np.array_equal(ckpts.numpy()[:, :C], ck_r)
    # a block replayed from checkpoint j - 1 is rows j*TB+1 .. (j+1)*TB of
    # the direct plane
    _, plane = wf.fill_single_global(q, t, B62, 11.0, 2.0, device="cpu")
    for j in range(t_dev.numel() // TB):
        _, words, _ = wf._scan(pp, t_dev[j * TB:(j + 1) * TB], ckpts[j - 1] if j else None,
                               j * TB, with_dirs=True, tr=16)
        d = wf._unpack_dir_words(words.numpy())
        rows = min(TB, R - j * TB)
        assert np.array_equal(d[:rows, :C], plane[j * TB + 1:j * TB + 1 + rows, 1:])


@pytest.mark.parametrize("sync_each_block", [True, False], ids=["sync", "nosync"])
@pytest.mark.parametrize("C,R", [(200, 300), (130, 97), (40, 230), (230, 40)])
def test_replay_walk_and_block_loop_match_reference(C, R, sync_each_block):
    """Step words, step count and final cursor of the whole backward walk
    against the JAX package's one-dispatch ``_replay_walk_all``."""
    TB, tr = 64, 16
    q, t = _related(C * 7 + R, C, R)
    pp_r, tp, outs = _jax_forward(q, t, B62, 11.0, 2.0, min(TB, -(-R // tr) * tr), tr)
    TB_r = min(TB, -(-R // tr) * tr)
    packed_r, n_r, cy_r, cx_r = ref_wf._replay_walk_all(
        pp_r["q_tile"], jnp.asarray(tp), pp_r["pmat"], outs[1], S=pp_r["S"], TR=tr,
        V=pp_r["V"], C_real=C, R_real=R, del_=11, ext=2, interpret=True, TB=TB_r,
        NCK=len(tp) // TB_r,
    )
    pp = wf._prep(q, t, B62, 11.0, 2.0, "cpu")
    _, _, state, steps, info = wf._chunked_walk(pp, TB, tr, sync_each_block)
    cy, cx, n = state.tolist()
    assert (cy, cx, n) == (int(cy_r), int(cx_r), int(n_r))
    assert cy == 0 or cx == 0
    nw = -(-n // 16)
    assert np.array_equal(steps.numpy()[:nw], np.asarray(packed_r)[:nw])
    assert np.all(steps.numpy()[nw:] == -1)  # Beginning-padded
    assert info["tb_rows"] == TB_r and info["blocks"] <= info["n_blocks"]
    if not sync_each_block:
        assert info["blocks"] == (R - 1) // TB_r + 1


def test_replay_walk_leaves_a_foreign_block_alone():
    q, t = _pair(3, 50, 64, 24)
    pp = wf._prep(q, t, B62, 11.0, 2.0, "cpu")
    _, words, _ = wf._scan(pp, torch.as_tensor(wf._pad_rows(pp["t"], 16))[:32], None, 0,
                           with_dirs=True, tr=16)
    state, steps = wf.new_walk(64, 50, 200, "cpu")
    wf.replay_walk(words, state, steps, row_base=0)  # the cursor is in rows 33..64
    assert state.tolist() == [64, 50, 0] and bool((steps == -1).all())


BLOCK_SHAPES = [(45, 64), (45, 65), (45, 128), (45, 127), (200, 500), (130, 97), (50, 300),
                (300, 20), (20, 300)]


@pytest.mark.parametrize("C,R", BLOCK_SHAPES, ids=[f"{c}x{r}" for c, r in BLOCK_SHAPES])
def test_align_single_global_chunked_matches_reference(C, R):
    """Row counts at and one past the block size, several blocks, and
    walks that end on the top border (300 x 20) and on the left one."""
    q, t = _pair(C * 31 + R, C, R, 24)
    a = wf.align_single_global_chunked(q, t, B62, 11.0, 2.0, tb_rows=64, tr=16,
                                       device="cpu")
    b = ref_wf.align_single_global_chunked(q, t, B62, 11.0, 2.0, tb_rows=64, tr=16,
                                           interpret=True)
    assert a[0] == b[0] and a[3] == b[3] == ((1, C), (1, R))
    for x, y in zip(a[1:3], b[1:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    c = wf.align_single_global_direct(q, t, B62, 11.0, 2.0, tr=16, device="cpu")
    assert c[0] == b[0] and c[3] == b[3]
    assert np.array_equal(c[1], b[1]) and np.array_equal(c[2], b[2])


def _same_alignment(a, b):
    a, b = a.alignment, b.alignment
    assert np.array_equal(a.query, b.query) and np.array_equal(a.target, b.target)
    assert a.query.dtype == b.query.dtype
    assert a.coords == b.coords and a.f == b.f


@pytest.mark.parametrize("budget", [1000, None], ids=["chunked", "direct"])
def test_align_global_routes_match_reference(monkeypatch, budget):
    if budget is not None:
        monkeypatch.setattr(ref_wf, "DIRECT_PLANE_CELLS", budget)
        monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", budget)
    q, t = _pair(11, 80, 90, 24)
    a = port.align_global(q, t, port.blosum62(), 11.0, 2.0, device="cpu")
    _same_alignment(a, ref.align_global(q, t, ref.blosum62(), 11.0, 2.0,
                                        backend="wavefront"))
    _same_alignment(a, ref.align_global(q, t, ref.blosum62(), 11.0, 2.0,
                                        backend="oracle"))
    s = port.Protein.decode(q), port.Protein.decode(t)
    _same_alignment(port.align_global(*s, port.blosum62(), 11.0, 2.0, device="cpu"), a)


def test_align_global_unsupported_small_pair_is_a_batch_of_one():
    """A transformed (non-integral) matrix cannot run in int32: the pair
    goes through the batched fill and walk and equals the reference."""
    m = B62 * 0.37 - 0.11
    q, t = _pair(12, 33, 41, 24)
    assert not wf.supported(len(q), m, 11.0, 2.0, tlen=len(t))
    a = port.align_global(q, t, m, 11.0, 2.0, device="cpu")
    _same_alignment(a, ref.align_global(q, t, m, 11.0, 2.0))
    b = port.align_global(q, t, B62, 11.5, 2.0, device="cpu")  # non-integral del
    _same_alignment(b, ref.align_global(q, t, B62, 11.5, 2.0))


def test_align_global_refusals(monkeypatch):
    m = np.full((24, 24), 0.5)  # non-integral
    z4 = np.zeros(4, np.int8)
    assert not wf.supported(10, m, 11.0, 2.0) and not ref_wf.supported(10, m, 11.0, 2.0)
    with pytest.raises(ValueError):
        wf.fill_single_global(z4, z4, m, 11.0, 2.0, device="cpu")
    with pytest.raises(ValueError):
        wf.align_single_global_chunked(z4, z4, m, 11.0, 2.0, device="cpu")
    # unsupported and past the direct-plane budget: refused in the JAX
    # package's words, never a materialised plane
    monkeypatch.setattr(ref_wf, "DIRECT_PLANE_CELLS", 10)
    monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 10)
    with pytest.raises(ref.ValidationError) as want:
        ref.align_global(z4, z4, m, 11.0, 2.0)
    with pytest.raises(port.ValidationError) as got:
        port.align_global(z4, z4, m, 11.0, 2.0, device="cpu")
    assert str(got.value) == str(want.value)
    # too wide for one plane: the column-blocked route takes it, a matrix
    # beyond int8 on its "lax" engine; past the range guard for the matrix's
    # largest entry it declines, and the pair is refused as one past the
    # direct-plane budget, in the JAX package's words
    monkeypatch.setattr(wf, "MAX_WIDTH", 3)
    a = port.align_global(z4, z4, B62, 11.0, 2.0, device="cpu")
    _same_alignment(a, ref.align_global(z4, z4, B62, 11.0, 2.0, backend="oracle"))
    wide = np.full((24, 24), 200.0)
    _same_alignment(port.align_global(z4, z4, wide, 11.0, 2.0, device="cpu"),
                    ref.align_global(z4, z4, wide, 11.0, 2.0, backend="oracle"))
    past = np.full((24, 24), 2.0**28)
    with pytest.raises(ref.ValidationError) as want:
        ref.align_global(z4, z4, past, 11.0, 2.0)
    with pytest.raises(port.ValidationError) as got:
        port.align_global(z4, z4, past, 11.0, 2.0, device="cpu")
    assert str(got.value) == str(want.value)


def test_range_guard_matches_reference():
    for C, R, d, e in [(10, 10, 11, 2), (262_144, 90_000_000, 11, 2),
                       (262_144, 100_000_000, 11, 2), (1000, 48_000_000, 11, 20),
                       (200_000, 4_000_000, 127, 1), (8_000_000, 8_000_000, 1, 1)]:
        assert wf.range_ok(C, R, d, e) == ref_wf.range_ok(C, R, d, e)
        assert (wf.supported(C, B62, d, e, tlen=R)
                == ref_wf.supported(C, B62, d, e, tlen=R))
    assert not wf.range_ok(262_144, 100_000_000, 11, 2)
    assert (wf.MAX_WIDTH, wf.DIRECT_PLANE_CELLS, wf.ROWS_PER_WORD) == \
        (ref_wf.MAX_WIDTH, ref_wf.DIRECT_PLANE_CELLS, ref_wf.ROWS_PER_WORD)
    with pytest.raises(ValueError):  # refused, not wrapped
        wf._prep(np.zeros(4, np.int8), np.zeros(4, np.int8), B62, 2**28, 2.0, "cpu")


def test_empty_sequences_raise():
    e, z5 = np.zeros(0, np.int8), np.zeros(5, np.int8)
    for q, t in ((e, z5), (z5, e)):
        with pytest.raises(ValueError):
            wf.fill_single_global(q, t, B62, 11.0, 2.0, device="cpu")
        with pytest.raises(ValueError):
            wf.align_single_global_chunked(q, t, B62, 11.0, 2.0, device="cpu")
        for fn in (port.align_global, port.align_local):
            with pytest.raises(port.ResultIsEmpty):
                fn(q, t, B62, 11.0, 2.0, device="cpu")


def test_row_scan_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(256, dtype=torch.int32)
    t = torch.zeros(32, dtype=torch.int32)
    m = torch.as_tensor(B62.astype(np.int32))
    ok = dict(with_dirs=False)
    wf.row_scan(q, t, m, 11, 2, None, 0, 200, 30, **ok)
    with pytest.raises(TypeError):
        wf.row_scan(q.long(), t, m, 11, 2, None, 0, 200, 30, **ok)
    with pytest.raises(ValueError):
        wf.row_scan(q, t[:30], m, 11, 2, None, 0, 200, 30, **ok)  # rows not 16k
    with pytest.raises(ValueError):
        wf.row_scan(q, t, m, 11, 2, None, 16, 200, 30, **ok)  # no h0 for a replay
    with pytest.raises(ValueError):
        wf.row_scan(q + 24, t, m, 11, 2, None, 0, 200, 30, **ok)  # codes out of range
    with pytest.raises(ValueError):
        wf.row_scan(q, t, m, 11, 2, None, 0, 200, 30, with_dirs=False, ckpt_every=24)
    with pytest.raises(TypeError):
        wf.replay_walk(torch.zeros((2, 256)), *wf.new_walk(30, 200, 100, "cpu"),
                       row_base=0)


def test_align_local_matches_reference():
    q, t = _related(5, 60, 75)
    _same_alignment(port.align_local(q, t, B62, 11.0, 2.0, device="cpu"),
                    ref.align_local(q, t, B62, 11.0, 2.0))
    m = np.full((24, 24), -1.0)  # no positive-scoring cell
    with pytest.raises(port.ResultIsEmpty):
        port.align_local(q, t, m, 11.0, 2.0, device="cpu")


def test_align_local_huge_pair_streams_on_the_host(monkeypatch):
    monkeypatch.setattr(ref_wf, "DIRECT_PLANE_CELLS", 1000)
    monkeypatch.setattr(wf, "DIRECT_PLANE_CELLS", 1000)
    q, t = _related(6, 90, 110)
    _same_alignment(port.align_local(q, t, B62, 11.0, 2.0, device="cpu"),
                    ref.align_local(q, t, B62, 11.0, 2.0))


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("pretty", [False, True], ids=["debug", "pretty"])
@pytest.mark.parametrize("glob", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("example", ["book_example_1", "protein"])
def test_cli_align_stdout_matches_reference(example, glob, pretty, tmp_path):
    argv = ["-i", str(ROOT / "examples" / f"{example}.fasta")]
    argv += ["-g"] if glob else []
    argv += ["--pretty"] if pretty else []
    out = tmp_path / "out.txt"
    got = _stdout(port_cli.main, argv + ["--device", "cpu", "-o", str(out)])
    assert got == _stdout(ref_cli.main, argv)
    assert got.strip() and out.read_text() == got


def test_cli_align_dna_and_validation(tmp_path):
    rng = np.random.default_rng(2)
    fa = tmp_path / "dna.fasta"
    fa.write_text("".join(f">s{i}\n" + "".join("ATCG"[c] for c in rng.integers(0, 4, 70))
                          + "\n" for i in range(2)))
    mf = tmp_path / "dna.mat"
    mf.write_text("\n".join(" ".join(str(int(v)) for v in row) for row in DNA44) + "\n")
    argv = ["-i", str(fa), "--dna", "-m", str(mf), "-d", "5", "-e", "2", "-g"]
    assert _stdout(port_cli.main, argv + ["--device", "cpu"]) == _stdout(ref_cli.main, argv)
    with pytest.raises(port.ValidationError):
        port_cli.main(["-i", str(fa), "--dna", "--device", "cpu"])
    three = tmp_path / "three.fasta"
    three.write_text(">a\nACGT\n>b\nACGT\n>c\nACGT\n")
    with pytest.raises(port.ValidationError):
        port_cli.main(["-i", str(three), "--device", "cpu"])


# --- the two repairs: device=None means the card -----------------------------

_Q = np.arange(9, dtype=np.int8) % 4
_PWM = np.ones((4, 5))
_FASTA = str(ROOT / "examples" / "book_example_1.fasta")
NO_CARD = {
    "batch_align": lambda: port.batch_align([_Q], [_Q], B62, 11.0, 2.0),
    "batch_align_pwm": lambda: port.batch_align_pwm([_Q], _PWM, 30.0, 7.0),
    "align_pwm": lambda: port.align_pwm(_Q, _PWM, 30.0, 7.0),
    "heuristic_align_pwm": lambda: port.heuristic_align_pwm(
        _Q, _PWM, 30.0, 7.0, port.Heuristics(0.0, 200.0, np.full(4, 0.25))),
    "align_global": lambda: port.align_global(_Q, _Q, B62, 11.0, 2.0),
    "align_local": lambda: port.align_local(_Q, _Q, B62, 11.0, 2.0),
    "search_database": lambda: port.search_database(_Q, [_Q], B62, 11.0, 2.0),
    "calculate_p_value": lambda: port.calculate_p_value(_Q, _Q, 5.0, 11.0, 2.0, B62,
                                                        n_sequences=4),
    "repeat_engine": lambda: port.repeat.engine._scan_scores(
        np.zeros(40, np.int8), [(0, 8)], _PWM, port.repeat.SearchOptions()),
    "cli_align": lambda: port_cli.main(["-i", _FASTA, "-g"]),
    "cli_search": lambda: port_cli_search.main(["-q", _FASTA, "-i", _FASTA]),
    "cli_repeat_search": lambda: port_cli_repeat.main(
        ["-i", _FASTA, "-o", "/dev/null", "-r", "4", "-q", "2"]),
    "fill_single_global": lambda: wf.fill_single_global(_Q, _Q, B62, 11.0, 2.0),
    "global_end_score": lambda: port.global_end_score(_Q, _Q, B62, 11.0, 2.0),
    "local_max_score": lambda: port.local_max_score(_Q, _Q, B62, 11.0, 2.0),
    "end_score_single_global_diag": lambda: wf.end_score_single_global_diag(
        _Q, _Q, B62, 11.0, 2.0),
    "sharded_global_align": lambda: port.sharded_global_align(2, _Q, _Q, B62, 11.0, 2.0),
    "sharded_global_end_score": lambda: port.sharded_global_end_score(
        2, _Q, _Q, B62, 11.0, 2.0),
    "heuristic_align": lambda: port.heuristic_align(
        _Q, _Q, B62, 11.0, 2.0, port.Heuristics(0.0, 0.0, np.full(24, 1 / 24))),
    "HeuristicAligner": lambda: port.HeuristicAligner.from_seqs(_Q, _Q).perform_alignment(
        11.0, 2.0, B62, port.Heuristics(0.0, 0.0, np.full(24, 1 / 24))),
    "heuristic_align_population": lambda: port.heuristic_align_population(
        _Q, _Q, np.stack([B62, B62]), 11.0, 11.0,
        port.Heuristics(0.0, 1e5, np.full(24, 1 / 24))),
    "warmup_population": lambda: port.warmup_population(_Q, _Q, 4, 11.0, 11.0),
}


@pytest.mark.parametrize("entry", sorted(NO_CARD))
def test_no_device_means_the_card_and_raises_without_one(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)  # the repeat CLI writes beside itself
    with pytest.raises(port.DeviceUnavailable, match="CUDA"):
        NO_CARD[entry]()


def test_align_pwm_host_route_is_asked_for_by_name(monkeypatch):
    """No size picks the host engine silently: only ``device="host"``."""
    from aligner_tpu_torch import align as port_align, host

    assert not hasattr(port_align, "SMALL_PROBLEM_CELLS_NATIVE")
    calls = []
    real = host.align_pwm
    monkeypatch.setattr(host, "align_pwm", lambda *a: calls.append(1) or real(*a))
    a = port.align_pwm(_Q, _PWM, 30.0, 7.0, device="host")
    b = port.align_pwm(_Q, _PWM, 30.0, 7.0, device="cpu")
    assert calls == [1]
    assert np.array_equal(a.alignment.numbered, b.alignment.numbered)
    assert a.alignment.coords == b.alignment.coords and a.alignment.f == b.alignment.f
