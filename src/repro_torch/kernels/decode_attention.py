"""K6 · decode attention on Hopper (CUDA C++, ``csrc/decode_attention.cu``).

One query token per sequence, q (B, 1, H, hd), against a cache
(B, S, KV, hd) of which positions ``[max(0, cache_len - window), cache_len)``
are valid (``window=0``: all below ``cache_len``). ``cache_len`` is one host
integer for the whole batch, as the Pallas kernel takes one scalar. The
cache may be a strided view (one layer of the stacked (L, B, S, KV, hd)
cache). The q heads of a KV head share each cache row; the positions are
split across blocks (:func:`split_plan`) and merged in the same launch by
the last block to finish, so a batch-1 decode fills the card. Port of the
Pallas kernel ``repro/kernels/decode_attention.py:decode_attention``. The
plain version is :func:`repro_torch.kernels.ref.decode_attention_ref`. A
head dim the kernel is not built for runs zero-padded to the next built
one, as K5's does (:func:`repro_torch.kernels.flash_attention.padded_head_dim`);
one above the largest built runs K5's pieces kernel in its decode form
(``csrc/attention_pieces.cuh``): a block per (batch, KV head, group of up
to 32 q heads) over every valid position, no splits.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import build
from ._launch import stream_ptr
from .flash_attention import COPY_BYTES, HEAD_DIMS, check_heads, pad_head_dim, padded_head_dim

TILE = 64  # cache positions per tile: splits start on tile boundaries
MIN_TILES = 2  # tiles per split at least, so a block keeps loads in flight
BLOCKS_PER_SM = 2  # split target: this many blocks per SM in all
MAX_SPLITS = 128  # the kernel's merge holds this many splits' (m, l) (kMaxSplits)

# (device, stream) -> (partials, split counters); grown, never shrunk. The
# counters start at 0 and every launch leaves them at 0, so calls on one
# stream may share them.
_scratch: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def split_plan(lo: int, hi: int, blocks: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits): positions per split block and the number of splits.

    The valid range [lo, hi), taken from ``lo`` rounded down to a tile, is
    cut into splits of whole tiles, at least ``MIN_TILES`` each, and into
    at most ``BLOCKS_PER_SM * sms / blocks`` splits (and ``MAX_SPLITS``), so
    ``blocks`` (B·KV) times the splits about fill the card; never fewer
    than one split, whose range may be empty.
    """
    base = lo // TILE * TILE
    tiles = -(-(hi - base) // TILE) if hi > lo else 0
    target = max(1, min(MAX_SPLITS, -(-BLOCKS_PER_SM * sms // max(blocks, 1))))
    per = max(MIN_TILES, -(-tiles // target))
    return per * TILE, max(1, -(-tiles // per))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scratch_for(device: torch.device, stream: int, n_part: int, n_count: int):
    buf = _scratch.get((device, stream))
    if buf is None or buf[0].numel() < n_part or buf[1].numel() < n_count:
        n_part = max(n_part, 0 if buf is None else buf[0].numel())
        n_count = max(n_count, 0 if buf is None else buf[1].numel())
        buf = (torch.empty(n_part, dtype=torch.float32, device=device),
               torch.zeros(n_count, dtype=torch.int32, device=device))
        _scratch[(device, stream)] = buf
    return buf


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
    if hd > HEAD_DIMS[-1]:
        return _decode_pieces(q, k_cache, v_cache, int(cache_len), window, scale)
    width = padded_head_dim(hd)
    if width != hd:
        q, k_cache, v_cache = pad_head_dim((q, k_cache, v_cache), width)
        scale = hd ** -0.5 if scale is None else scale
        o = decode_attention(q, k_cache, v_cache, cache_len, window=window, scale=scale)
        return o[..., :hd].contiguous()
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    hi = int(cache_len)
    if not 0 <= hi <= s_max:
        raise ValueError(f"cache_len {hi} outside [0, {s_max}]")
    el = q.element_size()
    for t, n, dims in ((q, "q", (0, 2)), (k_cache, "k_cache", (0, 1, 2)),
                       (v_cache, "v_cache", (0, 1, 2))):
        if t.data_ptr() % COPY_BYTES or any((t.stride(d) * el) % COPY_BYTES for d in dims):
            raise ValueError(f"decode_attention: {n} is read in {COPY_BYTES}-byte pieces: its base "
                             f"pointer and strides {tuple(t.stride())} must be multiples of "
                             f"{COPY_BYTES} bytes")
    lo = max(0, hi - window) if window else 0
    groups = h // kv
    chunk, splits = split_plan(lo, hi, b * kv, _sm_count(q.device))
    scale = float(scale if scale is not None else hd ** -0.5)
    o = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    stream = stream_ptr(q)
    rows = b * kv * groups
    part, counters = _scratch_for(q.device, stream, rows * splits * (hd + 2), rows)
    strides = build.strides_arg([
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(2),
    ])
    err = build.library().rt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        part.data_ptr(), counters.data_ptr(), strides,
        b, kv, groups, hd, lo, hi, lo // TILE * TILE, chunk, splits, scale,
        int(q.dtype == torch.bfloat16), stream,
    )
    build.check(err, "decode_attention")
    build.count_launch("decode_attention")
    return o


def _decode_pieces(q, k_cache, v_cache, hi, window, scale) -> torch.Tensor:
    """K6 above the built head dims: the pieces kernel over positions
    [max(0, hi - window), hi), f32 or bf16, any strides with inner stride 1."""
    b, _, h, hd = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    if not 0 <= hi <= s_max:
        raise ValueError(f"cache_len {hi} outside [0, {s_max}]")
    lo = max(0, hi - window) if window else 0
    o = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    strides = build.strides_arg([
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(2),
    ])
    err = build.library().rt_decode_attention_pieces(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(), strides,
        b, kv, h // kv, hd, lo, hi, float(scale if scale is not None else hd ** -0.5),
        int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "decode_attention")
    build.count_launch("decode_attention")
    return o
