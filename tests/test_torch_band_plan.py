"""The band walk's launch plan (``ops/wavefront.py:plan_band``), pure
arithmetic held on the CPU: the groups, the grid, the warps a block, the
zeroed row and ticket, the lag between groups and the critical path, at
the shapes the end-score paths give the band fill (K6):
one band as tall as the 65,536 x 65,536 pair and as the 262,144 x 262,144
pair, and a 262,144 x 262,144 block of ``band_grid``; and at the edges (one
group, more groups than the card holds warps, never more warps than
groups, the refusals).  The card is an H100 SXM: 132 SMs.  The copies of
the score table and a block's shared memory are the kernel's own
(``wavefront_band_occupancy``, held on the card); here they are passed
through.  Also: every text variant ``ops/band_probe.py`` can time still
applies to the source."""

import pytest

from aligner_tpu_torch.ops import band_probe
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.ops.wavefront import plan_band

SMS = 132
# what the kernel lays out for BLOSUM62 (V = 24) with 4 warps reading 32
# slots ahead: 32 copies of the (24, 25) table and 4 arrays of 32 slots a warp
COPIES, SMEM = 32, 4 * (32 * 24 * 25 + 4 * 32 * 4)

# (rows, columns, stream slots) of one call: the bands of the end score
# (streams padded to a multiple of BAND_TD) and band_grid's block
PATH_SHAPES = {
    "band-65536": (65_536, 65_536, 131_072),
    "band-262144": (262_144, 262_144, 524_288),
    "grid-block": (262_144, 262_144, 524_287),
}


def _plan(TB, Cb, D=None, K=wf.BAND_ROWS_PER_LANE, P=wf.BAND_READ_AHEAD, blocks_per_sm=8,
          sms=SMS, **kw):
    D = Cb + TB - 1 if D is None else D
    return plan_band(TB, Cb, D, K, P, sms=sms, blocks_per_sm=blocks_per_sm, copies=COPIES,
                     smem_bytes=SMEM, **kw)


@pytest.mark.parametrize("shape", list(PATH_SHAPES), ids=list(PATH_SHAPES))
def test_plan_at_the_paths_shapes(shape):
    TB, Cb, D = PATH_SHAPES[shape]
    K, P = wf.BAND_ROWS_PER_LANE, wf.BAND_READ_AHEAD
    p = _plan(TB, Cb, D)
    RW = 32 * K
    assert (p.RW, p.n_g, p.K, p.P) == (RW, TB // RW, K, P)
    assert p.warps == wf.BAND_WARPS
    assert (p.blocks - 1) * p.warps < p.n_g  # no block without a group
    assert (p.copies, p.smem_bytes) == (COPIES, SMEM)
    assert p.sync_ints == 1 and p.hand_words == D
    assert p.steps_per_group == RW - 1 + Cb
    assert p.lag_steps == RW + P
    assert p.under_way == -(-p.steps_per_group // p.lag_steps)
    assert p.blocks == min(-(-p.n_g // p.warps), 8 * SMS)
    assert p.critical_steps >= (p.n_g - 1) * p.lag_steps + p.steps_per_group
    # fewer steps on the critical path than the per-anti-diagonal launches
    # had: (n_g + n_c - 1) tiles of 128 steps
    assert p.critical_steps < (p.n_g + -(-D // 128) - 1) * 128


def test_plan_band_65536_in_numbers():
    """One band of the 65,536 x 65,536 pair in groups of 64 rows read 32
    slots ahead: 1,024 groups of 65,599 steps; a group lags the one above by
    64 + 32 steps, so 684 are under way at once; the card holds 2 blocks
    of 4 warps an SM, 264 blocks, so the grid is one warp a group: 256
    blocks of 4."""
    p = _plan(65_536, 65_536, 131_072, K=2, P=32, blocks_per_sm=2)
    assert (p.n_g, p.RW, p.warps) == (1_024, 64, 4)
    assert p.steps_per_group == 63 + 65_536 == 65_599
    assert p.lag_steps == 96 and p.under_way == 684
    assert p.blocks == 256
    assert p.critical_steps == 1_023 * 96 + 65_599 == 163_807
    assert SMEM == 78_848


def test_plan_band_262144_in_rounds():
    """One band of the 262,144 x 262,144 pair: 4,096 groups on the 264
    blocks of 4 warps the card holds go in 4 rounds, and the critical path
    is the rounds'."""
    p = _plan(262_144, 262_144, 524_288, K=2, P=32, blocks_per_sm=2)
    assert (p.n_g, p.warps, p.blocks) == (4_096, 4, 264)
    assert p.critical_steps == 3 * p.steps_per_group + p.steps_per_group


def test_one_group():
    p = _plan(128, 65_536, K=4)
    assert (p.n_g, p.warps, p.blocks, p.sync_ints) == (1, 1, 1, 1)
    assert p.critical_steps == p.steps_per_group == 127 + 65_536


def test_more_groups_than_resident_warps():
    """1 SM holding 1 block of 4 warps, 40 groups: the warps take 10 rounds
    of groups, and the critical path is the rounds, not the lags."""
    p = _plan(40 * 64, 4_096, K=2, sms=1, blocks_per_sm=1)
    assert (p.n_g, p.warps, p.blocks) == (40, 4, 1)
    assert p.critical_steps == 9 * p.steps_per_group + p.steps_per_group
    assert p.critical_steps > 39 * p.lag_steps + p.steps_per_group


@pytest.mark.parametrize("n_g,warps", [(1, 1), (3, 3), (4, 4), (5, 4), (4_096, 4)])
def test_no_more_warps_than_groups(n_g, warps):
    p = _plan(n_g * 32, 16_384, K=1)
    assert p.warps == warps and p.blocks * p.warps >= min(n_g, 8 * SMS * warps)
    assert (p.blocks - 1) * p.warps < n_g


@pytest.mark.parametrize("Cb", [1, 256, 4_096, 65_536, 262_144])
def test_grid_is_what_the_card_holds(Cb):
    """Whatever the width, the grid is the card's resident blocks, cut to
    one warp a group: the warps that find no group ready poll with back-off."""
    for bps in (1, 2, 8):
        p = _plan(262_144, Cb, blocks_per_sm=bps)
        assert p.blocks == min(bps * SMS, -(-p.n_g // p.warps))
        assert p.under_way == -(-p.steps_per_group // p.lag_steps)


@pytest.mark.parametrize("K,P", [(k, p) for k in (1, 2, 4, 8) for p in (16, 32, 64)])
def test_every_shape_the_kernel_takes(K, P):
    p = _plan(4_096, 1_000, K=K, P=P)
    assert p.RW == 32 * K and p.n_g == 4_096 // (32 * K) and p.lag_steps == 32 * K + P


@pytest.mark.parametrize("warps", [1, 2, 8])
def test_warps_a_block_forced(warps):
    p = _plan(65_536, 65_536, warps=warps)
    assert p.warps == warps and p.blocks == min(8 * SMS, -(-p.n_g // warps))


@pytest.mark.parametrize("TB,Cb,D,K,P,bps,warps", [
    (96, 100, None, 2, 32, 1, 4),      # TB not a multiple of 32 K
    (0, 100, None, 1, 32, 1, 4),       # no rows
    (128, 0, None, 1, 32, 1, 4),       # no columns
    (128, 100, 200, 1, 32, 1, 4),      # fewer slots than Cb + TB - 1
    (128, 100, None, 3, 32, 1, 4),     # K not 1, 2, 4 or 8
    (128, 100, None, 2, 48, 1, 4),     # P not 16, 32 or 64
    (128, 100, None, 2, 32, 0, 4),     # no block fits on an SM
    (128, 100, None, 2, 32, 1, 0),     # no warps
    (-64, 100, None, 2, 32, 1, 4),     # negative rows
])
def test_plan_refuses(TB, Cb, D, K, P, bps, warps):
    with pytest.raises(ValueError):
        _plan(TB, Cb, D, K=K, P=P, blocks_per_sm=bps, warps=warps)


@pytest.mark.parametrize("name", list(band_probe.VARIANTS))
def test_probe_variants_still_apply(name):
    """Every variant ``ops/band_probe.py`` can time still finds its anchor
    in the kernel's source exactly once."""
    import os

    with open(os.path.join(os.path.dirname(wf.__file__), "..", "csrc",
                           "wavefront_band.cu")) as fh:
        assert band_probe.variant_source(name) != fh.read()
