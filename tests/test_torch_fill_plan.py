"""The batched fill kernel's launch plan (``ops/dp_fill.py:plan_fill``),
pure arithmetic held on the CPU: what fits in a block's shared memory, the
rows of each column kept on chip, how a batch spreads over the SMs, and
where ``launch_plan`` puts the matrix.  The numbers are an H100 SXM's (132
SMs, 227 KB of shared memory a block, 228 KB an SM, 1 KB kept by the
runtime for each block).  Which launches take the lone design: the
pair-mode fills with directions and argmax tracking of at most one
problem an SM, never PWM mode, the plane or scores only.  Also the
variants of ``ops/fill_probe.py``: each still applies to the kernel's
source, and its forced plans."""

import pytest
import torch

from aligner_tpu_torch.ops import dp_fill, fill_probe
from aligner_tpu_torch.ops.dp_fill import CardLimits, plan_fill

H100 = CardLimits(sms=132, smem_per_block=232_448, smem_per_sm=233_472, smem_reserved=1_024)

BLOSUM_F32, BLOSUM_F64 = 24 * 24 * 4, 24 * 24 * 8
PWM_F64 = 4 * 300 * 8

# (B, R8, itemsize, shared matrix bytes) of the main path: the repeat
# scan's chunk, its survivors, the p-value launch, the full-mode batch
PATH_SHAPES = {
    "scan": (65_536, 336, 8, PWM_F64),
    "survivors": (1_024, 336, 8, PWM_F64),
    "p-value": (4_999, 344, 4, BLOSUM_F32),
    "full-batch": (4_096, 400, 4, BLOSUM_F32),
}

# shapes around the path's: search buckets, tall columns, big matrices
SHAPES = [
    *PATH_SHAPES.values(),
    (65_536, 336, 4, 4 * 300 * 4),
    (17_388, 376, 4, BLOSUM_F32),
    (166, 2_000, 4, BLOSUM_F32),
    (359, 1_800, 4, BLOSUM_F32),
    (1, 8, 8, BLOSUM_F64),
    (40, 0, 4, BLOSUM_F32),
    (300, 40, 8, 0),
    (10_000, 2_000, 8, 116_000),
    (100_000, 64, 4, 0),
]
SHAPE_IDS = [f"{B}x{R8}x{it}B+{mat}" for B, R8, it, mat in SHAPES]


def _column_bytes(plan, itemsize):
    """What a block holds besides the matrix: each problem's S rows and the
    codes of rows 1..S-1."""
    S = plan.rows_on_chip
    return plan.threads * (S * itemsize + S - 1)


@pytest.mark.parametrize("B,R8,itemsize,mat", SHAPES, ids=SHAPE_IDS)
def test_plan_fits_the_block(B, R8, itemsize, mat):
    p = plan_fill(R8, itemsize, B, H100, mat)
    assert p.threads % 32 == 0 and 32 <= p.threads <= 32 * dp_fill.MAX_WARPS
    assert p.smem_bytes == -(-mat // 16) * 16 + _column_bytes(p, itemsize)
    assert p.smem_bytes <= H100.smem_per_block and p.mat_bytes == mat
    blocks = H100.smem_per_sm // (p.smem_bytes + H100.smem_reserved)
    assert p.resident_per_sm == p.threads * min(blocks, 32, 2048 // p.threads) > 0


@pytest.mark.parametrize("B,R8,itemsize,mat", SHAPES, ids=SHAPE_IDS)
def test_rows_on_chip_end_on_an_8_row_block(B, R8, itemsize, mat):
    p = plan_fill(R8, itemsize, B, H100, mat)
    S = p.rows_on_chip
    assert (S - 1) % 8 == 0 and 1 <= S <= R8 + 1
    if S < R8 + 1:
        # the largest that fits: one more 8-row block would not
        more = -(-mat // 16) * 16 + p.threads * ((S + 8) * itemsize + S + 7)
        assert more > H100.smem_per_block


@pytest.mark.parametrize("shape", list(PATH_SHAPES), ids=list(PATH_SHAPES))
def test_path_shapes_keep_the_whole_column_on_chip(shape):
    B, R8, itemsize, mat = PATH_SHAPES[shape]
    assert plan_fill(R8, itemsize, B, H100, mat).rows_on_chip == R8 + 1


def test_scan_keeps_two_warps_an_sm():
    """The repeat scan's chunk in float64: shared memory holds two warps of
    337-row columns (2,696 B and 336 B of codes a problem) an SM, beside the
    PWM."""
    B, R8, itemsize, mat = PATH_SHAPES["scan"]
    p = plan_fill(R8, itemsize, B, H100, mat)
    assert (p.rows_on_chip, p.resident_per_sm, p.mat_bytes) == (337, 64, mat)


@pytest.mark.parametrize("B,R8", [(166, 2_000), (359, 1_800), (10_000, 2_000)])
def test_tall_search_buckets_spill_in_f32(B, R8):
    p = plan_fill(R8, 4, B, H100, BLOSUM_F32)
    assert p.rows_on_chip < R8 + 1
    assert p.threads == 32  # spilling more rows would not buy a larger block


def test_p_value_batch_gives_every_sm_a_block_first():
    p = plan_fill(344, 4, 4_999, H100, BLOSUM_F32)
    assert p.threads == 32
    assert -(-4_999 // p.threads) >= H100.sms


def test_survivor_batch_runs_as_one_warp_blocks():
    p = plan_fill(336, 8, 1_024, H100, PWM_F64)
    assert (p.threads, -(-1_024 // p.threads)) == (32, 32)


@pytest.mark.parametrize("B", [4_225, 8_448, 16_896, 65_536])
def test_a_block_of_several_warps_still_leaves_every_sm_a_block(B):
    p = plan_fill(336, 4, B, H100, 4 * 300 * 4)
    assert -(-B // p.threads) >= H100.sms


@pytest.mark.parametrize("itemsize,mat,warps", [(8, PWM_F64, 1), (4, 4 * 300 * 4, 2)],
                         ids=["f64", "f32"])
def test_scan_takes_the_block_that_keeps_most_problems_resident(itemsize, mat, warps):
    p = plan_fill(336, itemsize, 65_536, H100, mat)
    assert p.threads == 32 * warps and p.rows_on_chip == 337
    for w in range(1, dp_fill.MAX_WARPS + 1):
        other = plan_fill(336, itemsize, 65_536, H100, mat, warps=w)
        assert (other.rows_on_chip, other.resident_per_sm) <= (p.rows_on_chip,
                                                               p.resident_per_sm)


@pytest.mark.parametrize("warps", [1, 2, 3, 4])
def test_forced_warps(warps):
    p = plan_fill(336, 8, 100, H100, PWM_F64, warps=warps)
    assert p.threads == 32 * warps and p.smem_bytes <= H100.smem_per_block


def test_a_matrix_that_leaves_no_room_is_refused():
    with pytest.raises(ValueError, match="no launch"):
        plan_fill(64, 8, 100, H100, H100.smem_per_block)


@pytest.mark.parametrize("W,in_smem", [(300, True), (2_000, True), (8_000, False)])
def test_launch_plan_puts_a_shared_matrix_in_smem_up_to_half_a_block(monkeypatch, W,
                                                                    in_smem):
    monkeypatch.setattr(dp_fill, "card_limits", lambda dev: H100)
    pwm = torch.zeros((4, W), dtype=torch.float64)
    p = dp_fill.launch_plan(40, 16, pwm)
    assert p.mat_bytes == (4 * W * 8 if in_smem else 0)


def test_launch_plan_reads_a_per_problem_matrix_through_the_cache(monkeypatch):
    monkeypatch.setattr(dp_fill, "card_limits", lambda dev: H100)
    p = dp_fill.launch_plan(130, 32, torch.zeros((130, 24, 24), dtype=torch.float64))
    assert p.mat_bytes == 0 and p.rows_on_chip == 33


@pytest.mark.parametrize("name", list(fill_probe.VARIANTS))
def test_fill_probe_variant_applies_to_the_kernel_source(name):
    """Every variant's anchors occur once in ``csrc/dp_fill_core.cuh``, so an edit
    of the kernel that retires one fails here, not on the card."""
    src = fill_probe.variant_sources([name])
    assert src[name] != src["shipped"]


def test_fill_probe_refuses_a_variant_whose_anchor_is_gone():
    with pytest.raises(ValueError, match="occurs 0 times"):
        fill_probe.variant_sources(["fmax-f64"], base="// no kernel here\n")


@pytest.mark.parametrize("warps", [1, 2, 3])
def test_fill_probe_forces_the_warps_of_the_wrappers_plan(monkeypatch, warps):
    """The probe's forced plan is the wrapper's with the warps a block
    given; the wrapper's own plan is back afterwards."""
    monkeypatch.setattr(dp_fill, "card_limits", lambda dev: H100)
    pwm = torch.zeros((4, 300), dtype=torch.float64)
    shipped = dp_fill.launch_plan
    forced = fill_probe._forced(warps, lambda: dp_fill.launch_plan(65_536, 336, pwm))()
    assert forced == plan_fill(336, 8, 65_536, H100, 4 * 300 * 8, warps=warps)
    assert dp_fill.launch_plan is shipped


def _h100(monkeypatch):
    monkeypatch.setattr(dp_fill, "card_limits", lambda dev: H100)


def _matrices(B):
    """The search's shared f32 BLOSUM62 and the population's per-problem
    f64 matrices."""
    return [torch.zeros((24, 24), dtype=torch.float32),
            torch.zeros((B, 24, 24), dtype=torch.float64)]


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("B", [1, 10, 64, 132])
def test_a_small_pair_fill_with_directions_takes_the_lone_design(monkeypatch, B, mode):
    """A block a problem: the problem's matrix, three columns, two score
    buffers and the row codes in shared memory (global mode always
    tracks)."""
    _h100(monkeypatch)
    for m in _matrices(B):
        it = m.element_size()
        p = dp_fill.launch_plan(B, 2_000, m, dirs=True, track=True)
        assert p.lone and p.threads == dp_fill.LONE_THREADS == 64
        assert p.rows_on_chip == 2_001 and p.mat_bytes == 24 * 24 * it
        assert p.smem_bytes == -(-24 * 24 * it // 16) * 16 + 2_000 * (5 * it + 1)


@pytest.mark.parametrize("B", [133, 1_024, 4_999, 65_536])
def test_a_batch_larger_than_the_sms_keeps_one_thread_a_problem(monkeypatch, B):
    _h100(monkeypatch)
    for m in _matrices(B):
        p = dp_fill.launch_plan(B, 344, m, dirs=True, track=True)
        assert not p.lone
        assert p == plan_fill(344, m.element_size(), B, H100, p.mat_bytes)


INSTANCES = {
    "pwm-dirs": dict(pwm=True, dirs=True),
    "pwm-plane": dict(pwm=True, dirs=True, plane=True),
    "plane": dict(dirs=True, plane=True),
    "scores": dict(dirs=False),
    "scores-no-argmax": dict(dirs=False, track=False),
    "dirs-no-argmax": dict(dirs=True, track=False),
}


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("B", [1, 10, 64, 132])
def test_other_instances_never_take_the_lone_design(monkeypatch, B, instance):
    _h100(monkeypatch)
    kw = INSTANCES[instance]
    m = torch.zeros((4, 300), dtype=torch.float64) if kw.get("pwm") else _matrices(B)[0]
    assert not dp_fill.launch_plan(B, 336, m, **kw).lone


def test_columns_too_tall_for_the_lone_design_keep_one_thread_a_problem(monkeypatch):
    """Five f64 values and a code a row: 5,700 rows do not fit a block."""
    _h100(monkeypatch)
    m = torch.zeros((24, 24), dtype=torch.float64)
    assert dp_fill.launch_plan(10, 5_600, m, dirs=True).lone
    p = dp_fill.launch_plan(10, 5_704, m, dirs=True)
    assert not p.lone and p.rows_on_chip < 5_705
    with pytest.raises(ValueError, match="lone design"):
        plan_fill(5_704, 8, 10, H100, 0, own_mat_bytes=24 * 24 * 8, lone=True)


def test_a_large_matrix_is_read_where_it_lies(monkeypatch):
    """A 256-symbol f64 matrix (512 KB) leaves the columns the block."""
    _h100(monkeypatch)
    p = dp_fill.launch_plan(10, 2_000, torch.zeros((256, 256), dtype=torch.float64), dirs=True)
    assert p.lone and p.mat_bytes == 0 and p.smem_bytes == 2_000 * 41


def test_the_design_can_be_forced_either_way():
    own = 24 * 24 * 4
    assert not plan_fill(2_000, 4, 10, H100, own, own_mat_bytes=own, lone=False).lone
    assert plan_fill(2_000, 4, 5_000, H100, own, own_mat_bytes=own, lone=True).lone
    with pytest.raises(ValueError, match="lone design"):
        plan_fill(2_000, 4, 10, H100, own, lone=True)


def test_fill_probe_forces_the_design_of_the_wrappers_plan(monkeypatch):
    """The probe's thread-a-problem twin of a lone launch; the wrapper's
    own plan is back afterwards."""
    _h100(monkeypatch)
    m = torch.zeros((24, 24), dtype=torch.float32)
    shipped = dp_fill.plan_fill
    thread = fill_probe._design(False, lambda: dp_fill.launch_plan(10, 2_000, m, dirs=True))()
    assert not thread.lone and dp_fill.launch_plan(10, 2_000, m, dirs=True).lone
    assert dp_fill.plan_fill is shipped
