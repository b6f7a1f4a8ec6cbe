"""Host-side planning of K7's tensor-core build, in plain Python.

``kernels/ssd.py:head_group`` picks how many heads one block of the output
kernel serves (C·Bᵀ of a chunk is formed once per block and shared by its
heads): the fewest that fit the blocks in one wave. ``_scratch_for`` sizes
the per-chunk state buffers, cached per (device, stream); ``launches``
counts the kernels of one call. The plan is held against a brute-force
enumeration of the blocks and their heads, and the scratch against the
sizes the kernels index.
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
