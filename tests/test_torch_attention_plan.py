"""Host-side planning of the port's attention kernels, in plain Python.

K5 (``kernels/flash_attention.py``): the tile plan that the tensor-core
kernel reads from the card (the order in which its blocks take the q tiles,
heaviest first, and the range of keys each q tile visits), the check of
strides and alignment that decides how q, k and v are read, and the
backward's plan (the order in which its dk/dv blocks take the key tiles and
the q rows each walks, then the dq pass's tile plan). K6
(``kernels/decode_attention.py``): how the split plan streams tiles and
fills the card (its coverage of the valid range is held in
``test_torch_model_kernels.py``). Each is held against a brute-force mask or
a direct count.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

BQ, BK = fa.BLOCK_Q, fa.BLOCK_K


def _mask(sq, sk, causal, window):
    """(sq, sk) bool: key j visible to query i, as the plain version masks."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    m = np.ones((sq, sk), dtype=bool)
    if causal:
        m &= k <= q
    if window:
        m &= k > q - window
    return m


FLASH_PLANS = [
    (2048, 2048, True, 0),       # qwen3-4b's prefill
    (2048, 2048, True, 4096),    # zamba2's shared block: a window wider than the prompt
    (1, 1, True, 0),
    (127, 127, True, 0),
    (129, 129, True, 0),
    (2047, 2047, True, 0),
    (300, 300, True, 100),       # a window that starts inside a tile
    (129, 129, True, 33),
    (1000, 1000, True, 64),
    (127, 300, True, 0),         # Sq != Sk
    (129, 2047, False, 0),
    (2047, 2047, False, 300),    # a window without the causal mask
    (333, 77, False, 0),
]


@pytest.mark.parametrize("sq,sk,causal,window", FLASH_PLANS)
def test_kv_tile_range_holds_every_visible_key(sq, sk, causal, window):
    mask = _mask(sq, sk, causal, window)
    plan = fa.tile_plan(sq, sk, causal, window)
    assert sorted(qt for qt, _, _ in plan) == list(range(-(-sq // BQ)))  # each q tile once
    for qt, begin, end in plan:
        assert begin % BK == 0 and 0 <= begin <= end <= sk
        visible = np.flatnonzero(mask[qt * BQ:(qt + 1) * BQ].any(axis=0))
        if visible.size:
            assert begin <= visible.min() and visible.max() < end
            assert visible.min() < begin + BK  # the first tile visited holds a visible key
        # the tiles the kernel skips hold no visible key of the tile's rows
        assert not mask[qt * BQ:(qt + 1) * BQ, :begin].any()
        assert not mask[qt * BQ:(qt + 1) * BQ, end:].any()


@pytest.mark.parametrize("sq,sk,causal,window", FLASH_PLANS)
def test_q_tile_order_is_heaviest_first(sq, sk, causal, window):
    plan = fa.tile_plan(sq, sk, causal, window)
    work = [-(-(end - begin) // BK) for _, begin, end in plan]  # K/V tiles each block computes
    if causal and 0 < window < sq and sq % BQ:
        # a ragged last q tile under a narrow window goes first, maybe lighter
        assert work[1:] == sorted(work[1:], reverse=True)
    else:
        assert work == sorted(work, reverse=True)
    # and every tile it computes holds a key that one of its rows can see
    mask = _mask(sq, sk, causal, window)
    for qt, begin, end in plan:
        rows = mask[qt * BQ:(qt + 1) * BQ]
        for k0 in range(begin, end, BK):
            assert rows[:, k0:k0 + BK].any(), (qt, k0)


def test_plan_tensor_is_the_plan_in_the_kernels_layout():
    # the kernel reads three int32 per q tile, row i for the i-th block of heads
    got = fa._plan_on(torch.device("cpu"), 300, 300, True, 100)
    assert got.dtype == torch.int32 and got.is_contiguous() and got.shape == (3, 3)
    assert got.tolist() == [list(e) for e in fa.tile_plan(300, 300, True, 100)]


BWD = fa.BWD_BLOCK


@pytest.mark.parametrize("sq,sk,causal,window", FLASH_PLANS)
def test_key_tile_plan_walks_every_visible_row_once(sq, sk, causal, window):
    mask = _mask(sq, sk, causal, window)
    plan = fa.key_tile_plan(sq, sk, causal, window)
    assert sorted(kt for kt, _, _ in plan) == list(range(-(-sk // BWD)))  # each key tile once
    for kt, begin, end in plan:
        assert 0 <= begin <= end <= sq
        rows = np.flatnonzero(mask[:, kt * BWD:(kt + 1) * BWD].any(axis=1))
        if rows.size:
            assert begin <= rows.min() and rows.max() < end
            assert rows.min() < begin + BWD  # the first q tile walked holds a row that sees a key
        # the rows the block does not walk see none of its keys
        assert not mask[:begin, kt * BWD:(kt + 1) * BWD].any()
        assert not mask[end:, kt * BWD:(kt + 1) * BWD].any()


@pytest.mark.parametrize("sq,sk,causal,window", FLASH_PLANS)
def test_key_tile_order_is_heaviest_first(sq, sk, causal, window):
    plan = fa.key_tile_plan(sq, sk, causal, window)
    work = [-(-(end - begin) // BWD) for _, begin, end in plan]  # q tiles each block walks (a head)
    assert work == sorted(work, reverse=True)
    for a, b in zip(plan, plan[1:]):  # ties in key order
        if -(-(a[2] - a[1]) // BWD) == -(-(b[2] - b[1]) // BWD):
            assert a[0] < b[0]
    if causal and sq >= sk:
        # the first key tiles are seen by the most q rows, and go first
        assert [kt for kt, _, _ in plan] == list(range(-(-sk // BWD)))
    # every q tile a block walks holds a row that sees one of its keys
    mask = _mask(sq, sk, causal, window)
    for kt, begin, end in plan:
        cols = mask[:, kt * BWD:(kt + 1) * BWD]
        for i0 in range(begin, end, BWD):
            assert cols[i0:i0 + BWD].any(), (kt, i0)


def test_bwd_plan_is_the_key_tiles_then_the_q_tiles_in_the_kernels_layout():
    plan = fa.bwd_plan(300, 200, True, 100)
    assert plan == fa.key_tile_plan(300, 200, True, 100) + fa.tile_plan(300, 200, True, 100, BWD, BWD)
    assert len(plan) == -(-200 // BWD) + -(-300 // BWD)
    got = fa._bwd_plan_on(torch.device("cpu"), 300, 200, True, 100)
    assert got.dtype == torch.int32 and got.is_contiguous() and got.shape == (len(plan), 3)
    assert got.tolist() == [list(e) for e in plan]
    # qwen3-4b's training layer: 32 key tiles for 32 x 8 dk/dv blocks, 32 q tiles for 32 x 32 dq blocks
    plan = fa.bwd_plan(2048, 2048, True, 0)
    assert plan[:2] == [(0, 0, 2048), (1, 64, 2048)] and plan[31] == (31, 1984, 2048)
    assert plan[32:34] == [(31, 0, 2048), (30, 0, 1984)]


def test_load_route_takes_aligned_bf16_and_any_f32():
    qwen3 = [2048 * 32 * 128, 32 * 128, 128]  # (batch, seq, head) strides of a packed q
    zamba2 = [2048 * 32 * 80, 32 * 80, 80]
    fused = [200 * 48 * 128, 48 * 128, 128]  # a slice of a fused (q, k, v) projection
    for strides in (qwen3, zamba2, fused):
        assert fa.load_route(torch.bfloat16, 2, [4096, 8192, 1 << 20], strides * 3) == "cp.async"
    assert fa.load_route(torch.float32, 4, [4, 8, 12], [3, 5, 7] * 3) == "simt"


@pytest.mark.parametrize("ptrs,strides", [
    ([4096 + 2, 8192, 16384], [2048 * 512, 512, 64]),  # q's base pointer off by one element
    ([4096, 8192, 16384], [2048 * 544, 544, 68]),      # a head stride of 136 bytes
    ([4096, 8192, 16384], [2048 * 512, 500, 64]),      # a seq stride of 1000 bytes
])
def test_load_route_refuses_what_16_byte_copies_cannot_take(ptrs, strides):
    with pytest.raises(ValueError, match="16 bytes"):
        fa.load_route(torch.bfloat16, 2, ptrs, strides * 3)


def test_load_route_refuses_other_types():
    with pytest.raises(TypeError):
        fa.load_route(torch.float16, 2, [0, 0, 0], [8, 8, 8] * 3)


SPLIT_PLANS = [
    (0, 2048, 8, 132),     # qwen3-4b: 8 KV heads, 2048 cached positions
    (0, 2048, 32, 132),    # zamba2-2.7b's shared block: 32 KV heads
    (0, 1, 8, 132),
    (0, 63, 8, 132),
    (0, 65, 8, 132),
    (0, 0, 8, 132),
    (186, 250, 2, 132),
    (1948, 2048, 32, 132),  # a window of 100
    (0, 4096, 1, 132),      # one KV head: the cap on the splits
    (5, 6, 64, 132),
    (0, 4000, 48, 132),
    (0, 100, 1000, 132),
]


@pytest.mark.parametrize("lo,hi,blocks,sms", SPLIT_PLANS)
def test_decode_split_plan_streams_tiles_and_fills_the_card(lo, hi, blocks, sms):
    chunk, splits = da.split_plan(lo, hi, blocks, sms)
    assert chunk % da.TILE == 0 and chunk >= da.MIN_TILES * da.TILE  # several tiles a block
    assert splits <= da.MAX_SPLITS
    tiles = -(-(hi - lo // da.TILE * da.TILE) // da.TILE) if hi > lo else 0
    # as many blocks as the card has SMs, where the range has tiles enough
    assert blocks * splits >= min(sms, blocks * -(-tiles // da.MIN_TILES), blocks * da.MAX_SPLITS)


# -- K5's wide forward at head dim 192 (flash_fwd_wide) -------------------------------------


@pytest.mark.parametrize("pair", fa.WIDE_PAIRS)
def test_the_wide_forward_fits_a_block_beside_its_ring(pair):
    # 1 KB of alignment slack, Q of 128 rows, the ring's stages of 64 keys of K
    # and V, 128 B of barriers: as many stages as fit the block's 232448 bytes
    hd, hd_v = pair
    smem, stages = fa.fwd_smem(hd, hd_v, torch.bfloat16), fa.fwd_stages(hd, hd_v)
    assert smem == 1024 + 128 * hd * 2 + stages * 64 * (hd + hd_v) * 2 + 128 <= fa.SMEM_PER_BLOCK
    assert smem + 64 * (hd + hd_v) * 2 > fa.SMEM_PER_BLOCK  # one stage more does not fit
    assert stages >= 3


def test_the_wide_forward_at_mla_and_nemotron():
    # MLA: Q 48 KB and four stages of 24 KB of K and 16 KB of V; 192: three of 48 KB
    assert (fa.fwd_stages(192, 128), fa.fwd_smem(192, 128, torch.bfloat16)) == (4, 214144)
    assert (fa.fwd_stages(192, 192), fa.fwd_smem(192, 192, torch.bfloat16)) == (3, 197760)
    assert fa.fwd_smem(128, 128, torch.bfloat16) == 132096  # flash_fwd_wg, unchanged
    assert fa.fwd_launch_plan(1, 2048, 128, 192, 128, torch.bfloat16) == (
        "1 launch at (192, 128): 132 blocks of 3 warpgroups (a TMA producer at 24 registers a thread, 2 "
        "consumers of 64 q rows at 240) over 2048 items of 128 q rows in snake order, a 4-stage K/V ring of "
        "64 keys, 214144 B of shared memory, 1 an SM")
    assert "1 launch at (192, 192): 12 blocks" in fa.fwd_launch_plan(1, 129, 6, 192, 192, torch.bfloat16)
    with pytest.raises(ValueError, match="no build"):
        fa.fwd_smem(192, 128, torch.float32)


@pytest.mark.parametrize("dtype,hd,hd_v,wide,route_a", [
    (torch.bfloat16, 192, 128, True, False),
    (torch.bfloat16, 192, 192, True, False),
    (torch.bfloat16, 160, 160, True, False),   # padded to 192, the wide build at (192, 192)
    (torch.float32, 192, 128, False, True),
    (torch.float32, 192, 192, False, False),
    (torch.bfloat16, 192, 96, True, True),     # an unbuilt pair: v padded to 192, then the wide build
    (torch.bfloat16, 128, 128, False, False),
])
def test_route_names_the_build_that_runs(dtype, hd, hd_v, wide, route_a):
    name = fa.route(dtype, hd, hd_v)
    assert name.startswith("flash_fwd_wide") == wide and ("route (a)" in name) == route_a


@pytest.mark.parametrize("sq,sk,causal,window", [(2048, 2048, True, 0), (300, 300, True, 64), (77, 203, False, 0)])
def test_the_wide_backward_plan_takes_the_forwards_q_tiles(sq, sk, causal, window):
    # the dq pass of the wide build: a block of 128 q rows (two consumers of 64)
    # on the forward's tile plan, after the dk/dv pass's key tiles of 64
    wide = fa.bwd_plan(sq, sk, causal, window, wide_build=True)
    keys = fa.key_tile_plan(sq, sk, causal, window)
    assert wide[:len(keys)] == keys == fa.bwd_plan(sq, sk, causal, window)[:len(keys)]
    assert wide[len(keys):] == fa.tile_plan(sq, sk, causal, window, fa.BLOCK_Q, fa.BWD_BLOCK)
    assert len(wide) - len(keys) == -(-sq // fa.BLOCK_Q)
