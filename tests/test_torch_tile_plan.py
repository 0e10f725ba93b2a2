"""The strip walk's launch plan (``ops/wavefront.py:plan_strips``), pure
arithmetic held on the CPU: the grid, the warps a block, the shared memory,
the ring, the counter buffer, the steps of a chunk and of a strip and the
critical path, at the shapes the huge-pair and column-blocked paths give
the row-scan fill (K5) and the column-block fill (K7), and at the edges
(one strip, one chunk, 16- and 32-row strips, more strips than the card
holds warps).  The card is an H100 SXM: 132 SMs."""

import math
import os

import pytest

from aligner_tpu_torch.ops import tile_probe
from aligner_tpu_torch.ops import wavefront as wf
from aligner_tpu_torch.ops.wavefront import plan_strips

SMS = 132
V = 24  # BLOSUM62's alphabet

# (rows, width) of one call at the paths' shapes, the shipped strip shape:
# K5's forward fill of the 65,536 x 65,536 pair, one of its 32,768-row
# replay blocks, K7's forward block of the 524,288 x 524,288 pair and one
# of its replay tiles
PATH_SHAPES = {
    "k5-forward": (65_536, 65_536),
    "k5-replay-block": (32_768, 65_536),
    "k7-forward-block": (262_144, 131_072),
    "k7-replay-tile": (32_768, 131_072),
}


def _plan(rows, width, TR=wf.TILE_ROWS, K=wf.COLS_PER_THREAD, blocks_per_sm=6, sms=SMS,
          **kw):
    return plan_strips(rows, width, TR, K, V, sms=sms, blocks_per_sm=blocks_per_sm, **kw)


@pytest.mark.parametrize("shape", list(PATH_SHAPES), ids=list(PATH_SHAPES))
def test_plan_at_the_paths_shapes(shape):
    rows, width = PATH_SHAPES[shape]
    TR, K = wf.TILE_ROWS, wf.COLS_PER_THREAD
    p = _plan(rows, width)
    n_tr, n_tc = rows // TR, width // (32 * K)
    assert (p.n_tr, p.n_tc) == (n_tr, n_tc)
    assert p.warps == wf.STRIP_WARPS
    assert p.blocks * p.warps <= n_tr + p.warps - 1  # no block without a strip
    assert p.smem_bytes == 4 * (V * V + 2 * TR * p.warps)
    assert p.ring_slots == TR and p.sync_ints == 1 and p.hand_words == width
    Q = TR // 2  # two rows a step
    P = max(Q, 32)
    assert p.steps_per_chunk == P
    assert p.steps_per_strip == (n_tc - 1) * P + Q + 31
    assert p.lag_steps == Q + 31
    assert p.under_way == -(-p.steps_per_strip // p.lag_steps)
    spare = math.ceil(wf.STRIP_SPARE * p.under_way)
    assert p.blocks == min(-(-n_tr // p.warps), 6 * SMS, -(-spare // p.warps))
    assert p.critical_steps >= (n_tr - 1) * p.lag_steps + p.steps_per_strip


def test_plan_k7_forward_block_in_numbers():
    """The 262,144 x 131,072 block in 64-row strips of 128-column chunks:
    4,096 strips, 1,024 chunks of 32 steps (two rows a step); a strip lags
    the one above by 32 + 31 steps, so 521 strips are under way at once, and the
    grid holds 1.25 times as many warps: 163 blocks of 4."""
    p = _plan(262_144, 131_072, TR=64, K=4)
    assert (p.n_tr, p.n_tc, p.warps) == (4_096, 1_024, 4)
    assert p.steps_per_chunk == 32
    assert p.steps_per_strip == 1_023 * 32 + 32 + 31 == 32_799
    assert p.lag_steps == 63 and p.under_way == 521
    assert p.blocks == -(-math.ceil(1.25 * 521) // 4) == 163
    # 652 warps take the strips in rounds no slower than the lags
    assert p.critical_steps == 4_095 * 63 + 32_799 == 290_784
    assert p.smem_bytes == 4 * (576 + 2 * 64 * 4) == 4_352


def test_one_strip():
    p = _plan(64, 65_536, TR=64)
    assert (p.n_tr, p.warps, p.blocks, p.sync_ints) == (1, 1, 1, 1)
    assert p.critical_steps == p.steps_per_strip


def test_one_chunk():
    p = _plan(640, 128, TR=64, K=4)
    assert p.n_tc == 1
    assert p.steps_per_strip == 32 + 31  # the lanes drain once, at the strip's end
    assert p.critical_steps == 9 * p.lag_steps + p.steps_per_strip


@pytest.mark.parametrize("TR,P", [(16, 32), (32, 32), (64, 32), (96, 48), (128, 64),
                                  (256, 128)])
def test_steps_of_a_chunk(TR, P):
    """A chunk takes max(TR / 2, 32) steps, two rows a step: below 64 rows
    lane 0 waits for lane 31 to finish the rows in the chunk before."""
    p = _plan(TR * 8, 1_024, TR=TR, K=2)
    assert p.steps_per_chunk == P
    assert p.steps_per_strip == (p.n_tc - 1) * P + TR // 2 + 31
    assert p.lag_steps == TR // 2 + 31


def test_more_strips_than_resident_warps():
    """1 SM holding 1 block of 4 warps, 40 strips: the warps take 10 rounds
    of strips, and the critical path is the rounds, not the lags."""
    p = _plan(40 * 64, 8 * 128, TR=64, K=4, sms=1, blocks_per_sm=1)
    assert (p.n_tr, p.warps, p.blocks) == (40, 4, 1)
    assert p.critical_steps == 9 * p.steps_per_strip + p.steps_per_strip
    assert p.critical_steps > 39 * p.lag_steps + p.steps_per_strip


@pytest.mark.parametrize("n_tr,warps", [(1, 1), (3, 3), (4, 4), (5, 4), (1_000, 4)])
def test_no_more_warps_than_strips(n_tr, warps):
    p = _plan(n_tr * 32, 16_384, TR=32, K=8)
    assert p.warps == warps and p.blocks * p.warps >= min(n_tr, p.under_way)
    assert (p.blocks - 1) * p.warps < n_tr


@pytest.mark.parametrize("width", [256, 4_096, 65_536, 262_144])
def test_no_more_warps_than_strips_under_way(width):
    """A narrow call has few strips under way at once: the grid holds
    about that many warps, not the card's fill, so few warps spin."""
    p = _plan(262_144, width, TR=64, K=4)
    assert p.under_way == -(-p.steps_per_strip // p.lag_steps)
    assert (p.blocks - 1) * p.warps < math.ceil(wf.STRIP_SPARE * p.under_way)
    assert p.blocks * p.warps >= min(math.ceil(wf.STRIP_SPARE * p.under_way),
                                     6 * SMS * p.warps)


@pytest.mark.parametrize("warps", [1, 2, wf.STRIP_MAX_WARPS])
def test_warps_a_block_forced(warps):
    p = _plan(65_536, 65_536, warps=warps)
    assert p.warps == warps and p.smem_bytes == 4 * (V * V + 2 * wf.TILE_ROWS * warps)


@pytest.mark.parametrize("rows,width,TR,K,bps,warps", [
    (64, 256, 8, 4, 1, 4),        # TR below a direction word
    (96, 256, 24, 4, 1, 4),       # TR not a multiple of 16
    (100, 256, 16, 4, 1, 4),      # rows not a multiple of TR
    (64, 200, 16, 4, 1, 4),       # width not a multiple of 32 K
    (64, 256, 16, 3, 1, 4),       # K not 2, 4 or 8
    (64, 256, 16, 4, 0, 4),       # no block fits on an SM
    (64, 256, 16, 4, 1, 0),       # no warps
    (64, 256, 16, 4, 1, wf.STRIP_MAX_WARPS + 1),  # past the launch bounds
])
def test_plan_refuses(rows, width, TR, K, bps, warps):
    with pytest.raises(ValueError):
        _plan(rows, width, TR=TR, K=K, blocks_per_sm=bps, warps=warps)


@pytest.mark.parametrize("name", list(tile_probe.VARIANTS))
def test_probe_variants_still_apply(name):
    """Every variant ``ops/tile_probe.py`` can time still finds its anchor
    in the kernel's source exactly once."""
    with open(os.path.join(os.path.dirname(wf.__file__), "..", "csrc",
                           "wavefront_tile.cuh")) as fh:
        assert tile_probe.variant_header(name) != fh.read()


def test_chosen_tile_is_a_valid_plan_for_every_cadence():
    """The column-blocked pipeline picks the tile as gcd(rows, cadence,
    TILE_ROWS), which can be 16 at a padded edge: every such tile plans."""
    import math

    for rows in (16, 48, 1_024, 32_768):
        for cadence in (16, 32, 1_024):
            if rows % cadence:
                continue
            tile = math.gcd(rows, cadence, wf.TILE_ROWS)
            p = _plan(rows, 1_024, TR=tile)
            assert p.n_tr * tile == rows and p.steps_per_chunk == max(tile // 2, 32)


@pytest.mark.parametrize("rows,ckpt_every,tile_rows,dirs,want", [
    (64, 0, None, True, 64), (1_024, 64, None, False, 64),
    (32_768, 0, None, True, wf.TILE_ROWS), (48, 0, None, False, 16),
    (262_144, 32_768, None, False, wf.FORWARD_TILE_ROWS), (640, 0, 32, True, 32),
    (65_536, 32_768, None, False, wf.FORWARD_TILE_ROWS), (384, 0, None, False, 128)])
def test_default_strip_rows(rows, ckpt_every, tile_rows, dirs, want):
    """Left to its default, a call's strip height is the largest up to
    TILE_ROWS (FORWARD_TILE_ROWS without directions) that divides its rows
    and its checkpoint cadence, so a block of 64 rows or a cadence of 64
    still plans; a height asked for stays."""
    got = wf._strip_rows(rows, ckpt_every, tile_rows, dirs)
    assert got == want and rows % got == 0 and ckpt_every % got == 0
    assert wf.plan_strips(rows, 256, got, 8, V, sms=SMS, blocks_per_sm=6).TR == got
