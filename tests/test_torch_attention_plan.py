"""The float32 prefill kernel's launch plan
(``repro_torch.kernels.flash_attention.f32_plan`` and ``f32_blocks``),
which states the tiling ``csrc/flash_attention.cu`` sets; ``chip_smoke.py``
holds ``f32_plan`` against the library's own report on the card.

Checked here as pure functions: shared memory within what an H100 block
may use, two CTAs an SM at the serving head dim (D = 64), the scores and
outputs of a lane within a register budget, every query row in exactly
one block, each block's causal (and windowed: hymba's sliding window)
K/V tile count equal to what the plain mask needs (on 32-key tiles at
MLA's prefill head, D = 192), and the heaviest blocks first.
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
    # a lane's scores (block_keys / 8 keys a row) and outputs (D / 8
    # columns a row); 64-key tiles below D = 192, 32-key tiles there
    keys = plan["block_keys"]
    assert keys == (32 if d == 192 else 64)
    assert lane_rows * (keys // 8 + d // 8) <= 128


@pytest.mark.parametrize("d", (16, 32, 48, 64))
def test_head_dims_up_to_the_serving_one_run_two_ctas_an_sm(d):
    plan = fa.f32_plan(d)
    assert plan["threads"] == 256 and plan["rows_per_lane"] == 4
    assert 2 * (plan["smem_bytes"] + CTA_RESERVED) <= SM_SMEM


def test_plan_refuses_a_head_dim_the_kernel_is_not_built_for():
    with pytest.raises(ValueError, match="head dim"):
        fa.f32_plan(24)


def _needed_tiles(first, sq, sk, q_offset, causal, window=0,
                  keys=fa.F32_BLOCK_KEYS):
    """K/V tiles of ``keys`` keys from the first to the last one holding
    a key that some real row of the block keeps under the plain mask."""
    qpos = q_offset + np.arange(first, min(first + fa.F32_BLOCK_ROWS, sq))
    kpos = np.arange(sk)
    keep = (qpos[:, None] >= kpos[None, :]) if causal \
        else np.ones((len(qpos), sk), bool)
    if window > 0:
        keep &= qpos[:, None] - kpos[None, :] < window
    cols = np.flatnonzero(keep.any(axis=0))
    if cols.size == 0:
        return 0
    return int(cols.max()) // keys + 1 - int(cols.min()) // keys


# (b, h, sq, sk, q_offset, causal, window): the serving shape, no
# multiple of a tile, Sq < Sk (q_offset > 0), Sq > Sk (rows that see no
# key), a block that sees no key at all, non-causal, one row; then
# sliding windows: hymba's prefill (window 1024 over 2048 tokens, group
# 5), a window that is no multiple of a tile, window 1, a window past
# Sk, a window with q_offset > 0 and with rows that see no key, and a
# non-causal window
BLOCK_CASES = [
    (2, 3, 1024, 1024, 0, True, 0),
    (1, 2, 1000, 1000, 0, True, 0),
    (1, 2, 300, 1000, 700, True, 0),
    (2, 1, 300, 170, -130, True, 0),
    (1, 1, 200, 60, -140, True, 0),
    (1, 2, 200, 333, 0, False, 0),
    (3, 2, 1, 1, 0, True, 0),
    (1, 25, 2048, 2048, 0, True, 1024),
    (1, 5, 1536, 1536, 0, True, 1000),
    (2, 2, 300, 300, 0, True, 1),
    (1, 2, 300, 300, 0, True, 5000),
    (1, 2, 300, 1000, 700, True, 333),
    (2, 1, 300, 170, -130, True, 77),
    (1, 2, 400, 400, 0, False, 130),
]
# MLA's prefill head (D = 192, 32-key tiles): deepseek-v2-lite's prefill,
# a ragged one, Sq < Sk, Sq > Sk, one row, non-causal
MLA_BLOCK_CASES = [
    (2, 16, 1024, 1024, 0, True, 0),
    (1, 3, 1000, 1000, 0, True, 0),
    (1, 2, 300, 1000, 700, True, 0),
    (2, 1, 300, 170, -130, True, 0),
    (3, 2, 1, 1, 0, True, 0),
    (1, 2, 200, 333, 0, False, 0),
]


@pytest.mark.parametrize("b,h,sq,sk,q_offset,causal,window", BLOCK_CASES)
def test_blocks_cover_every_row_once_with_the_tiles_the_mask_needs(
        b, h, sq, sk, q_offset, causal, window):
    _check_blocks(b, h, sq, sk, q_offset, causal, window, 64)


@pytest.mark.parametrize("b,h,sq,sk,q_offset,causal,window",
                         MLA_BLOCK_CASES)
def test_mla_head_blocks_run_the_32_key_tiles_the_mask_needs(
        b, h, sq, sk, q_offset, causal, window):
    _check_blocks(b, h, sq, sk, q_offset, causal, window, 192)


def _check_blocks(b, h, sq, sk, q_offset, causal, window, d):
    keys = fa.f32_plan(d)["block_keys"]
    blocks = fa.f32_blocks(b, h, sq, sk, q_offset, causal, window, d)
    covered = np.zeros((b, h, sq), int)
    for bi, hi, first, tiles in blocks:
        covered[bi, hi, first:first + fa.F32_BLOCK_ROWS] += 1
        assert tiles == _needed_tiles(first, sq, sk, q_offset, causal,
                                      window, keys)
    assert (covered == 1).all()
    tiles = [t for *_, t in blocks]
    if window == 0:
        assert tiles == sorted(tiles, reverse=True)  # heaviest first
    elif causal:
        # a causal window bounds every block's work: its rows reach back
        # window - 1 keys from the first row, on tiles of 64 keys
        span = fa.F32_BLOCK_ROWS + window - 1
        assert max(tiles) <= -(-span // keys) + 1
    # neighbouring blocks take neighbouring heads of one batch
    assert [(bi, hi) for bi, hi, _, _ in blocks[:b * h]] == [
        (bi, hi) for bi in range(b) for hi in range(h)]
