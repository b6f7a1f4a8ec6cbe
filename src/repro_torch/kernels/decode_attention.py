"""K6 · decode attention on Hopper (CUDA C++, ``csrc/decode_attention.cu``).

One query token per sequence, q (B, 1, H, hd), against a cache
(B, S, KV, hd) of which positions ``[max(0, cache_len - window), cache_len)``
are valid (``window=0``: all below ``cache_len``). ``cache_len`` is one host
integer for the whole batch, as the Pallas kernel takes one scalar. The
cache may be a strided view (one layer of the stacked (L, B, S, KV, hd)
cache). The G = H / KV q heads of a KV head share each cache tile; the
positions are split across blocks and merged by a second kernel, so a
batch-1 decode fills the card. Port of the Pallas kernel
``repro/kernels/decode_attention.py:decode_attention``. The plain version
is :func:`repro_torch.kernels.ref.decode_attention_ref`.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build
from ._launch import stream_ptr
from .flash_attention import check_heads

TILE = 64  # cache positions per tile (kBS in the source)
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
BLOCKS_PER_SM = 2  # split target: this many blocks per SM in all


def split_plan(lo: int, hi: int, blocks: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits): positions per split block and the number of splits.

    The valid range [lo, hi), taken from ``lo`` rounded down to a tile, is
    cut into whole tiles shared out over at most ``BLOCKS_PER_SM * sms /
    blocks`` splits, so ``blocks`` (B·KV) times the splits about fill the
    card; never fewer than one split, whose range may be empty.
    """
    base = lo // TILE * TILE
    tiles = -(-(hi - base) // TILE) if hi > lo else 0
    target = max(1, -(-BLOCKS_PER_SM * sms // max(blocks, 1)))
    splits = max(1, min(tiles, target))
    per = max(1, -(-tiles // splits))
    return per * TILE, max(1, -(-tiles // per))


@functools.lru_cache(maxsize=None)
def _smem_bytes(groups: int, hd: int) -> int:
    """Shared memory of one split block, checked against Hopper's limit."""
    smem = build.library().rt_decode_attention_smem(groups, hd)
    if smem > MAX_SMEM:
        raise ValueError(f"{groups} q heads per kv head need {smem} B of shared memory")
    return smem


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: int,
    *,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    check_heads(q, k_cache, v_cache, "decode_attention")
    b, one, h, hd = q.shape
    if one != 1:
        raise ValueError(f"decode_attention takes one query token, got q {tuple(q.shape)}")
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    hi = int(cache_len)
    if not 0 <= hi <= s_max:
        raise ValueError(f"cache_len {hi} outside [0, {s_max}]")
    lo = max(0, hi - window) if window else 0
    groups = h // kv
    _smem_bytes(groups, hd)
    chunk, splits = split_plan(lo, hi, b * kv, _sm_count(q.device))
    scale = float(scale if scale is not None else hd ** -0.5)
    o = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b * kv, splits, groups, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b * kv, splits, groups, 2), dtype=torch.float32, device=q.device)
    strides = build.strides_arg([
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(2),
    ])
    err = build.library().rt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), strides,
        b, kv, groups, hd, lo, hi, chunk, splits, scale,
        int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "decode_attention")
    build.count_launch("decode_attention")
    return o
