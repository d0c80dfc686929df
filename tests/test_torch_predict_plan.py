"""B4's launch geometry (``kernel.glm_predict_plan``) on the CPU, and the
inputs of B4's parity cases, shared by ``test_torch_cuda.py`` and
``chip_smoke.py`` (the kernel against its plain version on the card); numpy
and the port only, so the card's machine can import it.

The plan is plain Python, so its promises are checked here: the tiles cover
every row once, each tile starts on the 16-byte grid when x does, shared
memory fits a block and two blocks fit an SM, and rows too wide for a stage
take the wide body.
"""
import math

import numpy as np
import pytest

from repro_torch.kernels.engine import kernel

# an H100's shared memory per block and per SM, and what each resident block
# reserves; the kernel's kMaxTileRows (32 rows a consumer warp) and kMaxStages
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
MAX_TILE_ROWS = 32 * kernel.PREDICT_CONSUMER_WARPS
MAX_STAGES = 4

# (name, n, d, kind): the scan's chunk and the reference test's shapes, ragged
# N, odd D, wide D (2,000 four rows a stage; 20,000 wider than a stage), x at
# a base off the 16-byte grid (``x = buf[1:]`` of an (N + 1, D) buffer), no
# live row, and one tile with no live row among live ones
CASES = [
    ("chunk", 70_656, 54, "plain"),
    ("odd", 217, 31, "plain"),
    ("one", 1, 1, "plain"),
    ("ragged", 257, 54, "plain"),
    ("ragged_chunk", 70_657, 54, "plain"),
    ("odd_d31", 4_099, 31, "plain"),
    ("odd_d53", 70_657, 53, "plain"),
    ("wide", 1_029, 2_000, "plain"),
    ("wider_than_a_stage", 257, 20_000, "plain"),
    ("misaligned", 70_657, 53, "misaligned"),
    ("misaligned_chunk", 70_656, 54, "misaligned"),
    ("misaligned_wide", 259, 2_001, "misaligned"),
    ("misaligned_wider_than_a_stage", 65, 20_001, "misaligned"),
    ("all_dead", 70_656, 54, "all_dead"),
    ("dead_tile", 70_656, 54, "dead_tile"),
]


def make(n, d, kind="plain"):
    """(buf, w, mask) f32 numpy for a case: x is ``buf`` ((n, d)), or
    ``buf[1:]`` of an (n + 1, d) buffer for ``kind="misaligned"``. A fifth of
    the rows are dead, half of them inf and the rest 1e6 (a dead row must
    come back 0, never NaN); w ~ N(0, 0.1) scaled by sqrt(54 / d) past
    d = 54, so |x.w| stays below ~4, where atol=2e-6 is about 8 f32 ulps."""
    rng = np.random.default_rng(n + d + 1)
    rows = n + (kind == "misaligned")
    x = rng.normal(0, 1, (rows, d)).astype(np.float32)
    w = (rng.normal(0, 0.1, d) * min(1.0, math.sqrt(54 / d))).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    if n > 1:
        mask[0] = 1.0
    if kind == "all_dead":
        mask[:] = 0.0
    if kind == "dead_tile":
        r = kernel.glm_predict_plan(n, d).rows
        mask[r:2 * r] = 0.0
    body = x[rows - n:]
    dead = np.flatnonzero(mask == 0)
    body[dead] = 1e6
    body[dead[::2]] = np.inf
    return x, w, mask


def test_cases_are_well_formed():
    for name, n, d, kind in CASES:
        buf, w, mask = make(n, d, kind)
        assert buf.shape == (n + (kind == "misaligned"), d) and w.shape == (d,)
        assert mask.shape == (n,)
        if kind == "misaligned":  # buf[1:] is off the 16-byte grid
            assert (4 * d) % 16
        if kind == "all_dead":
            assert not mask.any()
        if kind == "dead_tile":
            plan = kernel.glm_predict_plan(n, d)
            tiles = [mask[r0:r0 + k] for r0, k in
                     (t for c in range(plan.grid) for t in plan.tiles_of(c))]
            assert plan.tiles > 2 and sum(not t.any() for t in tiles) == 1
    assert {kernel.glm_predict_plan(n, d).body for _, n, d, _ in CASES} == {
        "staged_few", "staged_many", "wide"}


@pytest.mark.parametrize("n", [1, 255, 256, 257, 70_656, 70_657])
@pytest.mark.parametrize("d", [1, 31, 54, 2_000, 20_000])
def test_predict_plan_covers_rows_once_aligned_within_shared_memory(d, n):
    plan = kernel.glm_predict_plan(n, d)
    seen = np.zeros(n, np.int64)
    for cta in range(plan.grid):
        for r0, rows in plan.tiles_of(cta):
            assert 1 <= rows <= plan.rows
            seen[r0:r0 + rows] += 1
            # a tile of X starts on the 16-byte grid whenever x's base does
            assert (4 * r0 * d) % 16 == 0
    assert (seen == 1).all()
    assert 1 <= plan.grid <= min(plan.tiles, 132 * kernel.PREDICT_CTAS_PER_SM)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert kernel.PREDICT_CTAS_PER_SM * (plan.smem_bytes + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM
    # a stage holds fewer than 4 rows of X exactly where the wide body is taken
    wide = (kernel.PREDICT_STAGE_FLOATS - 3) // d < 4
    assert (plan.body == "wide") == wide == (d == 20_000)
    if wide:
        assert plan.rows == kernel.PREDICT_CONSUMER_WARPS and plan.smem_bytes == 0
        return
    assert plan.rows % 4 == 0 and plan.rows <= MAX_TILE_ROWS
    assert 1 <= plan.stages <= MAX_STAGES
    # each stage holds its rows of X at any of the 4 word offsets
    assert plan.stage_bytes >= 4 * (plan.rows * d + 3) and plan.stage_bytes % 16 == 0
    assert plan.smem_bytes >= kernel.PREDICT_BARRIER_BYTES + plan.stages * plan.stage_bytes
    # a row's segment leaves each lane at most 8 features (D <= 256)
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    few = plan.lanes * kernel.PREDICT_ZCACHE >= d
    assert plan.body == ("staged_few" if few else "staged_many")
    if few:
        assert plan.lanes == 1 or (plan.lanes // 2) * kernel.PREDICT_ZCACHE < d
    else:
        assert plan.lanes == 32


def test_predict_plan_at_the_scan_chunk():
    """The main path's chunk: 128-row tiles of 27.6 KB, two stages, three
    CTAs an SM, a row on 8 lanes."""
    plan = kernel.glm_predict_plan(70_656, 54)
    assert (plan.body, plan.rows, plan.tiles, plan.stages, plan.lanes, plan.grid) == (
        "staged_few", 128, 552, 2, 8, 396)
    assert plan.stage_bytes == 4 * (128 * 54 + 4)
    # a row's 54 features on 8 lanes: at most 7 a lane
    assert -(-54 // plan.lanes) <= kernel.PREDICT_ZCACHE


def test_predict_plan_rejects_empty_input():
    with pytest.raises(ValueError, match="n >= 1"):
        kernel.glm_predict_plan(0, 54)
