"""CUDA kernels against their plain PyTorch versions on the card, bit for
bit (the cases of chip_smoke.py's kernel phase): the fill kernel in pair
mode (K1/K2) and in PWM mode (K3), and the walk (K4).

Marked ``cuda``; every test skips where no CUDA device is present.  The
machine with the card has no JAX, so run this file there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from aligner_tpu_torch.matrices import blosum62
from aligner_tpu_torch.ops import device_walk, dp_fill
from aligner_tpu_torch.ops.scan_engine import fill_batch, fill_pwm_batch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

V = 24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batch(seed, B, C, R, dense, dev):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, V, (B, C)).astype(np.int32)
    t = rng.integers(0, V, (B, R)).astype(np.int32)
    if dense:
        ql, tl = np.full(B, C, np.int32), np.full(B, R, np.int32)
    else:
        ql = rng.integers(0, C + 1, B).astype(np.int32)
        tl = rng.integers(0, R + 1, B).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)]


def _equal(a, b):
    for f in ("fmax", "fy", "fx", "end", "words"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("track", [True, False], ids=["argmax", "noargmax"])
@pytest.mark.parametrize("dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("dense", [False, True], ids=["ragged", "dense"])
def test_fill_kernel_matches_plain(dev, dtype, mode, track, dirs, dense):
    q, ql, t, tl = _batch(1, 300, 40, 37, dense, dev)
    m = torch.as_tensor(np.array(blosum62()), dtype=dtype, device=dev)
    kw = dict(mode=mode, track_argmax=track, with_dirs=dirs)
    got = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, **kw)
    torch.cuda.synchronize()
    _equal(got, fill_batch(q, ql, t, tl, m, 11.0, 2.0, **kw))


@pytest.mark.parametrize("mode", ["local", "global"])
def test_fill_kernel_batched_float_matrix_f64(dev, mode):
    q, ql, t, tl = _batch(2, 130, 24, 29, False, dev)
    rng = np.random.default_rng(3)
    m = torch.as_tensor(rng.normal(0.0, 3.0, (130, V, V)), device=dev)
    kw = dict(mode=mode, with_dirs=True)
    _equal(dp_fill.fill(q, ql, t, tl, m, 3.5, 1.25, **kw),
           fill_batch(q, ql, t, tl, m, 3.5, 1.25, **kw))


@pytest.mark.parametrize("mode", ["local", "global"])
def test_walk_kernel_matches_plain(dev, mode):
    q, ql, t, tl = _batch(4, 257, 40, 45, False, dev)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32, device=dev)
    r = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, mode=mode, with_dirs=True)
    sy, sx = (tl, ql) if mode == "global" else (r.fy, r.fx)
    S = t.shape[1] + q.shape[1] + 1
    got = device_walk.walk(r.words, sy, sx, S=S, mode=mode)
    want = device_walk.walk_plain(r.words, sy, sx, S=S, mode=mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_launch_counters_count_kernel_launches(dev):
    q, ql, t, tl = _batch(5, 40, 16, 16, False, dev)
    m = torch.as_tensor(np.array(blosum62()), dtype=torch.float32, device=dev)
    s0, d0, w0 = dp_fill.launches.scores, dp_fill.launches.dirs, device_walk.launches.walk
    r = dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0, with_dirs=True)
    dp_fill.fill(q, ql, t, tl, m, 11.0, 2.0)
    device_walk.walk(r.words, r.fy, r.fx, S=33, mode="local")
    assert (dp_fill.launches.scores, dp_fill.launches.dirs, device_walk.launches.walk) \
        == (s0 + 1, d0 + 1, w0 + 1)


def _pwm_batch(seed, B, R, W, batched, integral, dev):
    """B ragged queries (lengths 0..R, some 0) and a shared or per-problem
    asymmetric PWM: integral for f32, non-integral for f64."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, R)).astype(np.int32)
    ql = rng.integers(0, R + 1, B).astype(np.int32)
    ql[::17] = 0
    shape = (B, 4, W) if batched else (4, W)
    if integral:
        pwm = torch.as_tensor(rng.integers(-4, 6, shape), dtype=torch.float32)
    else:
        pwm = torch.as_tensor(rng.normal(0.0, 3.0, shape), dtype=torch.float64)
    return torch.from_numpy(q).to(dev), torch.from_numpy(ql).to(dev), pwm.to(dev)


@pytest.mark.parametrize("integral", [True, False], ids=["f32int", "f64"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
@pytest.mark.parametrize("track", [True, False], ids=["argmax", "noargmax"])
@pytest.mark.parametrize("dirs", [False, True], ids=["scores", "dirs"])
def test_pwm_fill_kernel_matches_plain(dev, integral, batched, track, dirs):
    # R and W multiples of neither 8 nor 32
    q, ql, pwm = _pwm_batch(6, 300, 45, 37, batched, integral, dev)
    kw = dict(track_argmax=track, with_dirs=dirs)
    got = dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, **kw)
    torch.cuda.synchronize()
    _equal(got, fill_pwm_batch(q, ql, pwm, 6.5, 1.75, **kw))


def test_pwm_fill_kernel_reads_the_row_layout_in_place(dev):
    q, ql, pwm = _pwm_batch(7, 200, 40, 29, False, False, dev)
    rows = q.T.contiguous()  # (R, B), R a multiple of 8: read in place
    a = dp_fill.fill_pwm(rows.T, ql, pwm, 6.5, 1.75, track_argmax=False)
    _equal(a, fill_pwm_batch(q, ql, pwm, 6.5, 1.75, track_argmax=False))


@pytest.mark.parametrize("W", [2000, 8000], ids=["optin-smem", "l1"])
def test_pwm_fill_kernel_large_shared_pwm(dev, W):
    """A shared f64 PWM above 48 KB opts in to the larger dynamic shared
    memory (W = 2000: 64 KB); above that limit (W = 8000: 256 KB) it is
    read through the cache."""
    q, ql, pwm = _pwm_batch(8, 40, 16, W, False, False, dev)
    kw = dict(with_dirs=True)
    _equal(dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, **kw),
           fill_pwm_batch(q, ql, pwm, 6.5, 1.75, **kw))


def test_walk_kernel_on_pwm_words(dev):
    q, ql, pwm = _pwm_batch(9, 257, 45, 37, False, False, dev)
    r = dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, with_dirs=True)
    S = q.shape[1] + pwm.shape[-1] + 1
    got = device_walk.walk(r.words, r.fy, r.fx, S=S, mode="local")
    want = device_walk.walk_plain(r.words, r.fy, r.fx, S=S, mode="local")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pwm_launch_counters_count_kernel_launches(dev):
    q, ql, pwm = _pwm_batch(10, 40, 16, 20, False, False, dev)
    s0, d0 = dp_fill.launches.pwm_scores, dp_fill.launches.pwm_dirs
    p0 = dp_fill.launches.scores + dp_fill.launches.dirs
    dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75, with_dirs=True)
    dp_fill.fill_pwm(q, ql, pwm, 6.5, 1.75)
    assert (dp_fill.launches.pwm_scores, dp_fill.launches.pwm_dirs) == (s0 + 1, d0 + 1)
    assert dp_fill.launches.scores + dp_fill.launches.dirs == p0
