"""Host-side planning of K7's tensor-core build, in plain Python.

``kernels/ssd.py:head_group`` picks how many heads one block of the output
kernel serves (C·Bᵀ of a chunk is formed once per block and shared by its
heads): the fewest that fit the blocks in one wave. ``_scratch_for`` sizes
the per-chunk state buffers, cached per (device, stream); ``launches``
counts the kernels of one call. The plan is held against a brute-force
enumeration of the blocks and their heads, and the scratch against the
sizes the kernels index. The backward's bf16 build (``ssd.bwd_plan``)
takes the same head groups for its chunk launch; its shared memory, its
blocks and its one scratch allocation are held here for every shape it
takes (the CUDA source's sizes are held equal to these on the card).
"""
import pytest
import torch

from repro_torch.kernels import ssd

H100_SMS = 132

PLANS = [
    (1, 16, 80, H100_SMS),     # zamba2-2.7b's 2048-token prefill
    (1, 9, 80, H100_SMS),      # its ragged 1109-token prompt
    (1, 16, 81, H100_SMS),     # a head count the group does not divide
    (2, 3, 6, H100_SMS),       # batch 2
    (1, 1, 1, H100_SMS),       # one token, one head
    (1, 256, 4, H100_SMS),     # more chunks than one wave of blocks
    (4, 32, 80, 2 * H100_SMS),  # two blocks per SM
    (1, 0, 8, H100_SMS),       # no positions
]


def _blocks(batch, chunks, nh, group):
    """The output kernel's grid in launch order: (chunk, group, batch), x
    fastest, each block with the heads it serves."""
    return [((c, k, b), list(range(k * group, min(nh, k * group + group))))
            for b in range(batch) for k in range(-(-nh // group)) for c in range(chunks)]


@pytest.mark.parametrize("batch,chunks,nh,slots", PLANS)
def test_head_group_is_the_cheapest_whole_wave_plan(batch, chunks, nh, slots):
    # the smallest group whose blocks fit in one wave; where none does, all
    # the heads in one block per (batch, chunk)
    group = ssd.head_group(batch, chunks, nh, slots)
    assert 1 <= group <= nh
    one_wave = [g for g in range(1, nh + 1) if len(_blocks(batch, chunks, nh, g)) <= slots]
    assert group == (min(one_wave) if one_wave else nh)


@pytest.mark.parametrize("batch,chunks,nh,slots", PLANS)
def test_head_groups_cover_every_head_once(batch, chunks, nh, slots):
    group = ssd.head_group(batch, chunks, nh, slots)
    seen = {}
    for (c, _k, b), heads in _blocks(batch, chunks, nh, group):
        assert heads, "a block without heads"
        for h in heads:
            seen[(b, c, h)] = seen.get((b, c, h), 0) + 1
    assert seen == {(b, c, h): 1 for b in range(batch) for c in range(chunks) for h in range(nh)}


def test_zamba2_prefill_fills_the_card_in_one_wave():
    group = ssd.head_group(1, 16, 80, H100_SMS)
    blocks = len(_blocks(1, 16, 80, group))
    assert group == 10 and blocks == 128 <= H100_SMS


@pytest.mark.parametrize("chunks,group", [(1, 1), (4, 3), (8, 5), (9, 6), (16, 10)])
def test_head_group_at_the_zamba2_serving_prompts(chunks, group):
    # the chunk counts of the serving smoke's prompts (128 to 2048 tokens) at
    # 80 heads: one wave of at most 132 blocks each
    assert ssd.head_group(1, chunks, 80, H100_SMS) == group


@pytest.mark.parametrize("b,s,nh,bf16,want", [
    (1, 2048, 80, True, 3), (2, 1, 4, True, 3), (1, 0, 4, True, 1), (0, 64, 4, True, 0),
    (1, 64, 0, True, 0), (1, 2048, 80, False, 1), (1, 0, 4, False, 1), (0, 64, 4, False, 0),
])
def test_launches_per_call(b, s, nh, bf16, want):
    # bf16: the chunk states, the state pass and the outputs, only the state
    # pass (h = h0) without positions; f32: the SIMT kernel; nothing for an
    # empty batch
    assert ssd.launches(b, s, nh, bf16) == want


def test_scratch_grows_and_is_reused():
    dev = torch.device("cpu")
    key = (dev, 12345)
    ssd._scratch.pop(key, None)
    try:
        states, hsplit, el = ssd._scratch_for(dev, 12345, 16 * 80 * 64 * 64, 16 * 80)
        assert states.numel() == hsplit.numel() == 16 * 80 * 64 * 64 and el.numel() == 16 * 80
        assert all(t.dtype == torch.float32 for t in (states, hsplit, el))
        # a smaller call reuses the same buffers
        again = ssd._scratch_for(dev, 12345, 9 * 80 * 64 * 64, 9 * 80)
        assert all(a is b for a, b in zip(again, (states, hsplit, el)))
        # a larger one grows them, never below what was there
        grown = ssd._scratch_for(dev, 12345, 100, 32 * 80)
        assert grown[0].numel() == 16 * 80 * 64 * 64 and grown[2].numel() == 32 * 80
        # an empty sequence still gets buffers the kernels may point at
        ssd._scratch.pop(key)
        assert all(t.numel() >= 1 for t in ssd._scratch_for(dev, 12345, 0, 0))
    finally:
        ssd._scratch.pop(key, None)


# -- the backward's bf16 build (csrc/ssd_bwd.cu, launches A-D) -----------------------------

def _bwd_shapes():
    """PLANS' batches, chunk counts, heads and slots at zamba2's chunk, N and P."""
    for batch, chunks, nh, slots in PLANS:
        if chunks:
            yield batch, chunks * 128 - (chunks > 1) * 37, nh, 128, 64, 64, slots


@pytest.mark.parametrize("batch,s,nh,chunk,n,p,slots", list(_bwd_shapes()))
def test_bwd_plan_groups_blocks_and_scratch(batch, s, nh, chunk, n, p, slots):
    pl = ssd.bwd_plan(batch, s, nh, chunk, n, p, slots)
    nc = -(-s // chunk)
    # launch C's blocks: the forward's head group, every head in one group
    assert pl.group == ssd.head_group(batch, nc, nh, slots)
    assert (pl.groups - 1) * pl.group < nh <= pl.groups * pl.group
    assert pl.chunk_blocks == nc * pl.groups * batch
    assert pl.state_blocks == nc * nh * batch and pl.pass_threads == batch * nh * pl.np * pl.pp
    assert pl.sum_blocks == -(-batch * s * n // 256) + 1
    assert max(pl.state_smem, pl.chunk_smem) <= ssd.MAX_SMEM
    # the scratch: one allocation, 256-byte aligned buffers in order, none overlapping
    sizes = dict(zip(ssd.BWD_WORK, (size for _, size in pl.work)))
    slot = batch * nc * nh
    assert sizes == {"su": 4 * slot * 2 * 64 * 64, "el": 4 * slot, "dyp": 2 * slot * 2 * 128 * 64,
                     "ghp": 2 * slot * 4 * 64 * 64, "dbp": 4 * batch * pl.groups * s * n,
                     "dcp": 4 * batch * pl.groups * s * n, "dap": 4 * slot}
    end = 0
    for off, size in pl.work:
        assert off % 256 == 0 and off >= end
        end = off + size
    assert end <= pl.work_bytes < end + 256


def test_bwd_plan_covers_every_chunk_n_and_p():
    # every shape the build takes (chunk to 128, N and P to 64) fits a block
    # of launches A and C; the layout's padding is whole 16-wide tiles
    for chunk in range(1, ssd.BWD_MAX_CHUNK + 1):
        for n in range(1, ssd.BWD_MAX_NP + 1):
            for p in range(1, ssd.BWD_MAX_NP + 1):
                a_smem, c_smem = ssd.bwd_smem(chunk, n, p)
                assert a_smem <= c_smem <= ssd.MAX_SMEM
    for chunk in (1, 8, 16, 100, 128):
        for n in (1, 3, 16, 64):
            for p in range(1, ssd.BWD_MAX_NP + 1):
                pl = ssd.bwd_plan(1, 1000, 3, chunk, n, p, 132)
                assert (pl.lp, pl.np, pl.pp) == tuple(-(-v // 16) * 16 for v in (chunk, n, p))
                assert max(pl.state_smem, pl.chunk_smem) <= ssd.MAX_SMEM
    for chunk, n, p in ((129, 64, 64), (128, 65, 64), (128, 64, 65), (0, 64, 64)):
        with pytest.raises(ValueError, match="ROADMAP"):
            ssd.bwd_plan(1, 2048, 80, chunk, n, p, 132)


def test_bwd_launch_plan_at_zamba2s_training_step():
    # xh (1, 2048, 80, 64), N 64, chunk 128 on an H100's 132 slots: launch C
    # takes the forward's groups of 10 heads, 128 blocks in one wave
    assert ssd.bwd_smem(128, 64, 64) == (94208, 212544)
    assert ssd.bwd_route(torch.bfloat16) == "mma" and ssd.bwd_route(torch.float32) == "simt"
    assert ssd.bwd_launch_plan(1, 2048, 80, 128, 64, 64, torch.bfloat16, H100_SMS) == (
        "4 launches per call: 1280 state blocks; 327680 pass threads; 128 chunk blocks of 10 heads "
        "(8 groups, 212544 bytes of shared memory each); 513 sum blocks; mma.sync bf16, inputs as 1 "
        "and f32 operands as 2 bf16 terms")
    assert ssd.bwd_launch_plan(1, 2048, 80, 128, 64, 64, torch.float32, H100_SMS) == (
        "5 launches per call: 1280 blocks of the chunk terms (512 threads, one head each); per-head "
        "partials of dB and dC; f32 FMAs")
    pl = ssd.bwd_plan(1, 2048, 80, 128, 64, 64, H100_SMS)
    assert pl.work_bytes == 134227968  # about 134 MB of scratch a call
