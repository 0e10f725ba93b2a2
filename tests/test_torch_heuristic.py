"""The port's heuristic aligners against the JAX package, bit for bit: the
batched float64 transform (``transform_matrix_torch``) against numpy's
``transform_matrix`` (and ``transform_matrix_jax`` in x64 to 1e-12
relative), the population's frequency count (``count_pairs_plain``)
against ``Alignment.frequency_matrix()`` of the JAX package's batched
alignments, ``heuristic_align`` against ``backend="oracle"``, and
``heuristic_align_population`` against the JAX package's host loop
(``device_loop=False``) and against ``heuristic_align`` member by member,
with dead members, a NaN in the final state and members that spend
``max_iters``.  Every comparison is exact: equal floats, equal arrays.
The kernels' plain versions run here (``device="cpu"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aligner_tpu as ref
import aligner_tpu_torch as port
from aligner_tpu import heuristic as ref_h
from aligner_tpu.align import batch_align as ref_batch_align
from aligner_tpu.matrices import transform_matrix_jax
from aligner_tpu_torch import heuristic as port_h
from aligner_tpu_torch.matrices import transform_matrix_torch
from aligner_tpu_torch.ops import device_walk
from aligner_tpu_torch.ops.scan_engine import fill_batch

torch.set_num_threads(1)

B62 = np.asarray(ref.blosum62(), np.float64)


def heuristics(rng, V=24, kd=2.0, r_squared=1e4):
    freqs = rng.random(V)
    freqs /= freqs.sum()
    return (ref_h.Heuristics(kd=kd, r_squared=r_squared, frequencies=freqs),
            port.Heuristics(kd=kd, r_squared=r_squared, frequencies=freqs))


def same_result(a, b):
    """Two AlignmentResults, or two Nones, are one result."""
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.alignment.f == b.alignment.f
    assert np.array_equal(a.alignment.query, b.alignment.query)
    assert np.array_equal(a.alignment.target, b.alignment.target)
    assert tuple(map(tuple, a.alignment.coords)) == tuple(map(tuple, b.alignment.coords))
    assert np.array_equal(a.matrix, b.matrix)


def homologous(rng, L, subs, V=24):
    q = rng.integers(0, V, L).astype(np.int8)
    t = q.copy()
    t[rng.integers(1, L, subs)] = rng.integers(0, V, subs)
    return q, t


# --------------------------------------------------------------------------
# the transform
# --------------------------------------------------------------------------


def sample_matrices(rng, M, V):
    """Seeded starting matrices of the kinds a population meets: {-1, 0, 1}
    matrices as the service makes them, scaled, some with Gaussian noise,
    and frequency counts (non-negative integers, at least one pair: the
    seed pair of a live member)."""
    mats = rng.integers(-1, 2, (M, V, V)).astype(np.float64) * rng.random((M, 1, 1)) * 3
    noisy = rng.random(M) < 0.4
    mats[noisy] += rng.normal(size=(int(noisy.sum()), V, V))
    counts = np.flatnonzero(rng.random(M) < 0.3)
    mats[counts] = rng.poisson(0.5, (len(counts), V, V))
    mats[counts, rng.integers(0, V, len(counts)), rng.integers(0, V, len(counts))] += 1
    return mats


def branch(matrix, kd, r_squared, freqs):
    """Which branch numpy's ``transform_matrix`` takes: "none" (no real
    roots: it raises), "zero" (one root), "straddle" or "nearest", and for
    "nearest" its two candidates with their distances from the matrix."""
    V = matrix.shape[1]
    p = np.outer(freqs, np.full(V, 1.0 / V))
    ps = float((p * p).sum())
    a = (kd - float((p * matrix).sum())) / ps
    b = kd / ps
    base = matrix + p * (a - b)
    den = float((base * base).sum())
    ac = 2.0 * b * float((p * base).sum()) / den
    bc = (b * b * ps - r_squared) / den
    disc = ac * ac - 4.0 * bc
    if disc < 0.0:
        return "none", None
    if disc == 0.0:
        return "zero", None
    sq = np.sqrt(disc)
    r0, r1 = (-ac - sq) / 2.0, (-ac + sq) / 2.0
    if r0 < 0.0 < r1:
        return "straddle", None
    m0, m1 = p * b + r0 * base, p * b + r1 * base
    return "nearest", (m0, m1, float(np.linalg.norm(matrix - m0)),
                       float(np.linalg.norm(matrix - m1)))


TRANSFORM_CASES = [(V, kd, r2) for V in (24, 4) for kd in (0.0, 2.0)
                   for r2 in (1e2, 1e4, 1e5)]


@pytest.mark.parametrize("V,kd,r2", TRANSFORM_CASES,
                         ids=[f"V{v}-kd{k:g}-r{r:g}" for v, k, r in TRANSFORM_CASES])
def test_transform_is_numpys_bit_for_bit(V, kd, r2):
    """170 seeded matrices a case, 2,040 in all, batched (M = 170): each
    member equals numpy's transform exactly, or is NaN (and only that
    member) where numpy raises; and agrees with the JAX version in x64 to
    1e-12 relative."""
    rng = np.random.default_rng(TRANSFORM_CASES.index((V, kd, r2)))
    M = 170
    mats = sample_matrices(rng, M, V)
    freqs = rng.random(V)
    freqs /= freqs.sum()
    got = transform_matrix_torch(torch.as_tensor(mats), kd, r2, freqs).numpy()
    jx = np.asarray(jax.jit(jax.vmap(
        lambda m: transform_matrix_jax(m, kd, r2, jnp.asarray(freqs))))(jnp.asarray(mats)))
    for m in range(M):
        try:
            want = ref.transform_matrix(mats[m], kd, r2, freqs)
        except ref.WrongMatrixSpecified:
            assert np.isnan(got[m]).all(), m
            continue
        assert np.array_equal(got[m], want), m
        assert np.abs(jx[m] - want).max() <= 1e-12 * np.abs(want).max(), m


@pytest.mark.parametrize("V", [24, 4])
def test_transform_takes_every_branch(V):
    """The straddling root, the nearest root and no real root all occur,
    each equal to numpy's outcome.  Σ p∘base is zero but for rounding, so
    the roots straddle zero while r² > kd²/‖p‖², and there are none below
    it; at r² = b²‖p‖² as the transform rounds it the constant term is
    exactly zero, so one root is 0 and the other the rounding of Σ p∘base:
    the nearest-root branch (or, where that sum is exactly 0, the single
    root).  There the two candidates lie within rounding of each other, so
    the transform's one gap applies (its docstring): numpy's distances come
    from BLAS ``ddot``, whose order cannot be reproduced.  So a nearest-root
    member equals numpy's pick where numpy's two distances differ by more
    than 4 ULPs, and one of numpy's two candidates where they do not."""
    rng = np.random.default_rng(40 + V)
    freqs = rng.random(V)
    freqs /= freqs.sum()
    p = np.outer(freqs, np.full(V, 1.0 / V))
    ps = float((p * p).sum())
    b = 2.0 / ps
    seen = {}
    for kd, r2 in ((0.0, 1e4), (2.0, 0.5 * b * b * ps), (2.0, b * b * ps)):
        mats = sample_matrices(rng, 120, V)
        got = transform_matrix_torch(torch.as_tensor(mats), kd, r2, freqs).numpy()
        for m in range(len(mats)):
            kind, cand = branch(mats[m], kd, r2, freqs)
            seen[kind] = seen.get(kind, 0) + 1
            if kind == "none":
                with pytest.raises(ref.WrongMatrixSpecified):
                    ref.transform_matrix(mats[m], kd, r2, freqs)
                assert np.isnan(got[m]).all()
                continue
            want = ref.transform_matrix(mats[m], kd, r2, freqs)
            if kind == "nearest" and abs(cand[2] - cand[3]) <= 4 * np.spacing(
                    max(cand[2], cand[3])):
                assert np.array_equal(got[m], cand[0]) or np.array_equal(got[m], cand[1])
            else:
                assert np.array_equal(got[m], want)
    assert {"none", "straddle", "nearest"} <= set(seen), seen


def test_transform_of_a_degenerate_matrix_is_nan():
    """A matrix equal to its shift (all zero: Σ base² = 0) makes numpy divide
    a Python float by zero; the batched transform gives NaN there, for that
    member only."""
    freqs = np.full(4, 0.25)
    mats = np.zeros((2, 4, 4))
    mats[1, 0, 0] = 1.0
    with pytest.raises(ZeroDivisionError):
        ref.transform_matrix(mats[0], 0.0, 10.0, freqs)
    got = transform_matrix_torch(torch.as_tensor(mats), 0.0, 10.0, freqs).numpy()
    assert np.isnan(got[0]).all()
    assert np.array_equal(got[1], ref.transform_matrix(mats[1], 0.0, 10.0, freqs))


def test_transform_refuses_frequencies_of_another_width():
    with pytest.raises(port.WrongMatrixSpecified):
        transform_matrix_torch(torch.zeros((2, 24, 24), dtype=torch.float64), 0.0, 1.0,
                               np.full(20, 0.05))


# --------------------------------------------------------------------------
# the frequency count
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_iteration_counts_are_the_frequency_matrices(seed):
    """One population iteration's fill, walk and count on the plain
    versions equal, as integers, ``frequency_matrix()`` of each member's
    alignment from the JAX package's batched alignment; done members (zero
    length) count nothing.  The counting walk's plain version
    (``walk_counts_plain``, the population's path) gives the same counts."""
    rng = np.random.default_rng(seed)
    M, V = 10, 24
    q, t = homologous(rng, 52, 9)
    _, h = heuristics(rng)
    mats = np.stack([ref.transform_matrix(m, 0.0, 1e3, h.frequencies)
                     for m in rng.integers(-1, 2, (M, V, V)).astype(np.float64)])
    done = np.arange(M) % 3 == 2
    want = ref_batch_align([q] * M, [t] * M, mats, 11.0, 2.0, mode="local", backend="xla",
                           with_alignments=True, skip=done)
    q2, ql = port.align.pad_batch([q] * M)
    t2, tl = port.align.pad_batch([t] * M)
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)
    ql, tl = i32(np.where(done, 0, ql)), i32(np.where(done, 0, tl))
    r = fill_batch(i32(q2), ql, i32(t2), tl, torch.as_tensor(mats), 11.0, 2.0,
                   mode="local", with_dirs=True)
    steps, n, _, _ = device_walk.walk_plain(r.words, r.fy, r.fx,
                                            S=q2.shape[1] + t2.shape[1] + 1, mode="local")
    counts = device_walk.count_pairs_plain(steps, n, r.fy, r.fx, i32(q2), i32(t2),
                                           torch.as_tensor(~done), V).numpy()
    assert counts.dtype == np.int32
    walked = device_walk.walk_counts(r.words, r.fy, r.fx, i32(q2), i32(t2),
                                     torch.as_tensor(~done), V,
                                     S=q2.shape[1] + t2.shape[1] + 1)
    assert walked.dtype == torch.int32 and np.array_equal(walked.numpy(), counts)
    for m in range(M):
        if done[m]:
            assert want[m] is None and not counts[m].any()
        else:
            fm = want[m].alignment.frequency_matrix()
            assert np.array_equal(counts[m], fm.astype(np.int32)), m
            assert np.array_equal(counts[m].astype(np.float64), fm)


def test_population_loop_counts_by_the_counting_walk(monkeypatch):
    """``_population_loop`` makes one ``walk_counts`` call an iteration (one
    fill an iteration) and does not call the walk on its own; the
    population's results equal its members' ``heuristic_align``."""
    from aligner_tpu_torch.ops import dp_fill

    calls = {"fill": 0, "walk_counts": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def refused(*a, **kw):
        raise AssertionError("the population called the walk on its own")

    loop = port_h._population_loop

    def patched_loop(*a, **kw):
        with monkeypatch.context() as mp:
            mp.setattr(dp_fill, "fill", counted("fill", dp_fill.fill))
            mp.setattr(device_walk, "walk_counts",
                       counted("walk_counts", device_walk.walk_counts))
            mp.setattr(device_walk, "walk", refused)
            loop(*a, **kw)

    monkeypatch.setattr(port_h, "_population_loop", patched_loop)
    rng = np.random.default_rng(5)
    q, t = homologous(rng, 40, 6)
    _, h = heuristics(rng, kd=0.0, r_squared=1e5)
    mats = rng.integers(-1, 2, (6, 24, 24)).astype(np.float64) + 4 * np.eye(24)
    got = port.heuristic_align_population(q, t, mats, 11.0, 11.0, h, device="cpu")
    assert calls["fill"] >= 2 and calls["walk_counts"] == calls["fill"]
    for a, m in zip(got, mats):
        b = port.heuristic_align(q, t, m, 11.0, 11.0, h, device="cpu")
        assert a.alignment.f == b.alignment.f and np.array_equal(a.matrix, b.matrix)


# --------------------------------------------------------------------------
# heuristic_align
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_heuristic_align_is_the_oracles(seed):
    rng = np.random.default_rng(seed)
    h_ref, h_port = heuristics(rng, kd=float(seed % 2) * 2.0, r_squared=1e4)
    q, t = homologous(rng, 30 + 5 * seed, 6)
    seed_m = B62 + rng.integers(-2, 3, (24, 24))
    a = ref_h.heuristic_align(q, t, seed_m, 7.0, 3.0, h_ref, backend="oracle")
    b = port.heuristic_align(q, t, seed_m, 7.0, 3.0, h_port, device="cpu")
    same_result(a, b)


def test_heuristic_align_r_squared_default(rng):
    """r² == 0 → rows*cols of the seed matrix (heuristic/mod.rs:48-50)."""
    h_ref, h_port = heuristics(rng, kd=0.0, r_squared=0.0)
    q, t = homologous(rng, 20, 4)
    a = ref_h.heuristic_align(q, t, B62, 7.0, 3.0, h_ref, backend="oracle")
    b = port.heuristic_align(q, t, B62, 7.0, 3.0, h_port, device="cpu")
    same_result(a, b)
    assert np.isclose(float((b.matrix ** 2).sum()), 24 * 24)


def test_heuristic_align_missing_argument():
    with pytest.raises(port.MissingArgument):
        port.heuristic_align("HEAGAWGHEE", "PAWHEAE", B62, 7.0, 3.0, None, device="cpu")


def test_heuristic_align_exhaustion_attaches_the_producing_matrix(rng):
    """At ``max_iters`` the result carries the matrix that produced it:
    realigning with it gives the same alignment; as the oracle does."""
    q = rng.integers(0, 24, 16).astype(np.int8)
    seed_m = rng.integers(-1, 2, (24, 24)).astype(np.float64)
    h_ref = ref_h.Heuristics(kd=0.0, r_squared=30.0, frequencies=np.full(24, 1 / 24))
    h_port = port.Heuristics(kd=0.0, r_squared=30.0, frequencies=np.full(24, 1 / 24))
    for iters in (1, 2):
        a = ref_h.heuristic_align(q, q, seed_m, 4.0, 2.0, h_ref, backend="oracle",
                                  max_iters=iters)
        b = port.heuristic_align(q, q, seed_m, 4.0, 2.0, h_port, device="cpu",
                                 max_iters=iters)
        same_result(a, b)
        again = port.align_local(q, q, b.matrix, 4.0, 2.0, device="cpu")
        assert again.alignment.f == b.alignment.f
        assert np.array_equal(again.alignment.query, b.alignment.query)


def test_heuristic_align_max_iters_zero_raises_after_the_transform(rng):
    _, h = heuristics(rng)
    q = rng.integers(0, 24, 16).astype(np.int8)
    with pytest.raises(port.ValidationError):
        port.heuristic_align(q, q, B62, 4.0, 2.0, h, max_iters=0, device="cpu")
    # the first transform runs before the bound is checked, as in the JAX package
    bad = port.Heuristics(kd=0.0, r_squared=1.0, frequencies=np.full(20, 0.05))
    with pytest.raises(port.WrongMatrixSpecified):
        port.heuristic_align(q, q, B62, 4.0, 2.0, bad, max_iters=0, device="cpu")


def test_heuristic_aligner_wrappers(rng):
    h_ref, h_port = heuristics(rng)
    a = ref_h.HeuristicAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE").perform_alignment(
        7.0, 3.0, B62, h_ref, backend="oracle")
    b = port.HeuristicAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE").perform_alignment(
        7.0, 3.0, B62, h_port, device="cpu")
    same_result(a, b)
    q, t = homologous(rng, 25, 5)
    a = ref_h.HeuristicAligner.from_seqs(q, t).perform_alignment(7.0, 3.0, B62, h_ref,
                                                                backend="oracle")
    b = port.HeuristicAligner.from_seqs(q, t).perform_alignment(7.0, 3.0, B62, h_port,
                                                               device="cpu")
    same_result(a, b)


# --------------------------------------------------------------------------
# heuristic_align_population
# --------------------------------------------------------------------------


def both_populations(q, t, mats, d, e, h_ref, h_port, **kw):
    a = ref_h.heuristic_align_population(q, t, mats, d, e, h_ref, backend="xla",
                                         device_loop=False, **kw)
    b = port.heuristic_align_population(q, t, mats, d, e, h_port, device="cpu", **kw)
    assert len(a) == len(b) == len(mats)
    for x, y in zip(a, b):
        same_result(x, y)
    return b


def test_population_matches_the_host_loop_and_the_singles(rng):
    """Mirror of tests/test_heuristic_stats.py::test_heuristic_population_matches_singles."""
    h_ref, h_port = heuristics(rng)
    q = rng.integers(0, 24, 25).astype(np.int8)
    t = rng.integers(0, 24, 25).astype(np.int8)
    mats = np.stack([B62 + rng.integers(-2, 3, (24, 24)) for _ in range(4)])
    pop = both_populations(q, t, mats, 7.0, 3.0, h_ref, h_port)
    for m in range(4):
        single = ref_h.heuristic_align(q, t, mats[m], 7.0, 3.0, h_ref, backend="oracle")
        same_result(single, pop[m])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_population_at_the_services_shape_scaled_down(seed):
    """The service's population (bench_service.py: kd 0, r² 1e5, del = ext,
    {-1, 0, 1} starting matrices, V = 24) at 8 members and pairs of about
    60, against the JAX host loop and against heuristic_align member by
    member."""
    rng = np.random.default_rng(seed)
    h_ref, h_port = heuristics(rng, kd=0.0, r_squared=1e5)
    q, t = homologous(rng, 60, 15)
    t = t[: 56 + seed]
    mats = rng.integers(-1, 2, (8, 24, 24)).astype(np.float64)
    pop = both_populations(q, t, mats, 11.0, 11.0, h_ref, h_port)
    for m in range(8):
        same_result(ref_h.heuristic_align(q, t, mats[m], 11.0, 11.0, h_ref,
                                          backend="oracle"), pop[m])


def test_population_dead_members_are_none(rng):
    """A member whose matrix admits no alignment is None on both sides."""
    q = np.zeros(10, np.int8)
    t = np.full(10, 5, np.int8)
    mats = np.zeros((2, 24, 24))
    mats[:, 5, 0] = -3.0
    h_ref, h_port = heuristics(rng, kd=0.0, r_squared=10.0)
    assert both_populations(q, t, mats, 5.0, 2.0, h_ref, h_port) == [None, None]


def test_population_surfaces_a_nan_transform(rng, monkeypatch):
    """A NaN in the final state raises WrongMatrixSpecified, also for a
    member the NaN fill marked dead (the JAX package's rule, its
    stubbed-loop test mirrored)."""
    q = rng.integers(0, 24, 16).astype(np.int8)
    M = 3

    def fake_loop(q2, ql0, t2, tl0, state, *a, **kw):
        state.trans = state.trans.clone()
        state.trans[1] = float("nan")  # member 1 accepted a no-real-roots transform
        state.dead = state.dead.clone()
        state.dead[1] = True  # ...and the NaN fill then marked it dead
        state.done = torch.ones_like(state.done)

    monkeypatch.setattr(port_h, "_population_loop", fake_loop)
    _, h = heuristics(rng, kd=0.0, r_squared=120.0)
    mats = rng.integers(-1, 2, (M, 24, 24)).astype(np.float64)
    with pytest.raises(port.WrongMatrixSpecified):
        port.heuristic_align_population(q, q, mats, 5.0, 2.0, h, device="cpu")


@pytest.mark.parametrize("iters", [1, 2])
def test_population_exhaustion_attaches_the_producing_matrix(rng, iters):
    """A member that spends ``max_iters`` while still improving returns its
    last accepted alignment with the matrix that produced it: realigning
    with ``res.matrix`` gives the same alignment back."""
    q, t = homologous(rng, 40, 6)
    mats = rng.integers(-1, 2, (3, 24, 24)).astype(np.float64)
    h_ref, h_port = heuristics(rng, kd=0.0, r_squared=120.0)
    out = both_populations(q, t, mats, 5.0, 2.0, h_ref, h_port, max_iters=iters)
    assert any(r is not None for r in out)
    for m, res in enumerate(out):
        if res is None:
            continue
        redo = port.batch_align([q], [t], res.matrix[None], 5.0, 2.0, mode="local",
                                with_alignments=True, device="cpu")[0]
        assert redo.alignment.f == res.alignment.f, m
        assert np.array_equal(redo.alignment.query, res.alignment.query)
        assert np.array_equal(redo.alignment.target, res.alignment.target)


def test_population_refusals(rng):
    q, t = homologous(rng, 20, 3)
    mats = rng.integers(-1, 2, (2, 24, 24)).astype(np.float64)
    _, h = heuristics(rng)
    with pytest.raises(port.ValidationError):
        port.heuristic_align_population(q, t, mats, 5.0, 2.0, h, max_iters=0, device="cpu")
    with pytest.raises(port.MissingArgument):
        port.heuristic_align_population(q, t, mats, 5.0, 2.0, None, device="cpu")
    with pytest.raises(port.ResultIsEmpty):
        port.heuristic_align_population(q[:0], t, mats, 5.0, 2.0, h, device="cpu")


@pytest.mark.parametrize("side", ["query", "target"])
def test_population_refuses_codes_outside_the_matrices(rng, monkeypatch, side):
    """A Protein pair holding an X (code 23) against (M, 20, 20) matrices,
    as a request with dimValue 20 gives it: ValidationError before any
    fill, not a count or a matrix read outside the (20, 20) matrices."""
    q, t = homologous(rng, 30, 4, V=20)
    (q if side == "query" else t)[11] = port.Protein.encode("X")[0]
    mats = rng.integers(-1, 2, (3, 20, 20)).astype(np.float64)
    _, h = heuristics(rng, V=20)
    from aligner_tpu_torch.ops import dp_fill

    calls = []
    monkeypatch.setattr(dp_fill, "fill", lambda *a, **kw: calls.append(a))
    with pytest.raises(port.ValidationError, match=f"{side} codes"):
        port.heuristic_align_population(q, t, mats, 11.0, 11.0, h, device="cpu")
    assert calls == []


def test_warmup_population_does_no_work(monkeypatch):
    """One with-alignments launch, every problem skipped, and no result."""
    calls = []
    real = port_h.batch_align
    monkeypatch.setattr(port_h, "batch_align",
                        lambda *a, **kw: calls.append(kw["skip"]) or real(*a, **kw))
    assert port.warmup_population("HEAGAWGHEE", "PAWHEAE", 5, 11.0, 11.0,
                                  device="cpu") is None
    assert len(calls) == 1 and calls[0].all() and len(calls[0]) == 5
