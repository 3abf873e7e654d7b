"""The float32 prefill kernel's launch plan
(``repro_torch.kernels.flash_attention.f32_plan`` and ``f32_blocks``),
which states the tiling ``csrc/flash_attention.cu`` sets; ``chip_smoke.py``
holds ``f32_plan`` against the library's own report on the card.

Checked here as pure functions: shared memory within what an H100 block
may use, two CTAs an SM at the serving head dim (D = 64), the scores and
outputs of a lane within a register budget, every query row in exactly
one block, each block's causal K/V tile count equal to what the plain
mask needs, and the heaviest blocks first.
"""

import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa

#: bytes of shared memory an H100 block may use, and an SM holds (the
#: runtime reserves 1 KB of it per CTA)
BLOCK_SMEM, SM_SMEM, CTA_RESERVED = 232_448, 233_472, 1024


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_plan_fits_a_block_and_the_registers(d):
    plan = fa.f32_plan(d)
    rows, lane_rows = plan["block_rows"], plan["rows_per_lane"]
    assert plan["smem_bytes"] <= BLOCK_SMEM
    # four lanes' rows a warp, the warps cover the block's rows
    assert plan["threads"] == 32 * rows // (4 * lane_rows)
    # a lane's scores (8 keys a row) and outputs (D / 8 columns a row)
    assert lane_rows * (8 + d // 8) <= 128


@pytest.mark.parametrize("d", (16, 32, 48, 64))
def test_head_dims_up_to_the_serving_one_run_two_ctas_an_sm(d):
    plan = fa.f32_plan(d)
    assert plan["threads"] == 256 and plan["rows_per_lane"] == 4
    assert 2 * (plan["smem_bytes"] + CTA_RESERVED) <= SM_SMEM


def test_plan_refuses_a_head_dim_the_kernel_is_not_built_for():
    with pytest.raises(ValueError, match="head dim"):
        fa.f32_plan(24)


def _needed_tiles(first, sq, sk, q_offset, causal):
    """K/V tiles up to the last one holding a key that some real row of
    the block keeps under the plain mask."""
    qpos = q_offset + np.arange(first, min(first + fa.F32_BLOCK_ROWS, sq))
    kpos = np.arange(sk)
    keep = (qpos[:, None] >= kpos[None, :]) if causal \
        else np.ones((len(qpos), sk), bool)
    cols = np.flatnonzero(keep.any(axis=0))
    return 0 if cols.size == 0 else int(cols.max()) // fa.F32_BLOCK_KEYS + 1


# (b, h, sq, sk, q_offset, causal): the serving shape, no multiple of a
# tile, Sq < Sk (q_offset > 0), Sq > Sk (rows that see no key), a block
# that sees no key at all, non-causal, one row
BLOCK_CASES = [
    (2, 3, 1024, 1024, 0, True),
    (1, 2, 1000, 1000, 0, True),
    (1, 2, 300, 1000, 700, True),
    (2, 1, 300, 170, -130, True),
    (1, 1, 200, 60, -140, True),
    (1, 2, 200, 333, 0, False),
    (3, 2, 1, 1, 0, True),
]


@pytest.mark.parametrize("b,h,sq,sk,q_offset,causal", BLOCK_CASES)
def test_blocks_cover_every_row_once_with_the_tiles_the_mask_needs(
        b, h, sq, sk, q_offset, causal):
    blocks = fa.f32_blocks(b, h, sq, sk, q_offset, causal)
    covered = np.zeros((b, h, sq), int)
    for bi, hi, first, tiles in blocks:
        covered[bi, hi, first:first + fa.F32_BLOCK_ROWS] += 1
        assert tiles == _needed_tiles(first, sq, sk, q_offset, causal)
    assert (covered == 1).all()
    tiles = [t for *_, t in blocks]
    assert tiles == sorted(tiles, reverse=True)      # heaviest first
    # neighbouring blocks take neighbouring heads of one batch
    assert [(bi, hi) for bi, hi, _, _ in blocks[:b * h]] == [
        (bi, hi) for bi in range(b) for hi in range(h)]
