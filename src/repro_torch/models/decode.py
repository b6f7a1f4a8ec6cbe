"""Serving path of the dense family: KV cache layout, prefill (fills the
cache, returns last-token logits) and single-token decode (port of the
dense part of ``repro/models/decode.py``, its default ``"scan"`` cache
layout).

The cache keeps the reference's layout, stacked per layer:
``{"len": int, "layers": {"k": (L, B, M, KV, hd), "v": ...}}`` with
``M = max_len``, or ``min(max_len, window)`` under a sliding window, where
the cache is a ring: position ``p`` lives in slot ``p % M``. Unlike the
reference, whose functions return new arrays, :func:`prefill` and
:func:`decode_step` write the cache IN PLACE and return the same dict
(with ``len`` advanced): a full-width cache is hundreds of MB per slot,
and a copy per token would double the bytes a decode step moves.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .attention import attn_out, chunked_attention, gqa_decode, gqa_project_qkv
from .common import add_norm
from .config import ModelConfig
from .transformer import _dt, _mlp_seam, lm_head, require_dense, run_blocks

PyTree = Any


def _ring(cfg: ModelConfig, max_len: int) -> int:
    """Effective cache length: ring of size `window` under SWA."""
    return min(max_len, cfg.swa_window) if cfg.swa_window else max_len


# ===================================================================== caches

def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: torch.device | str = "cpu"
) -> PyTree:
    """Empty cache for a serving session of ≤ max_len absolute positions."""
    require_dense(cfg)
    m = _ring(cfg, max_len)
    shape = (cfg.n_layers, batch, m, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "len": 0,
        "layers": {
            "k": torch.zeros(shape, dtype=_dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dt(cfg), device=device),
        },
    }


# ============================================================ cache writers

def _write_linear(cache_arr: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Prefill fill from position 0 (cache assumed fresh), in place."""
    cache_arr[:, : new.shape[1]] = new
    return cache_arr


def _write_ring(cache_arr: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Fill a ring buffer of size M with the last ≤M of S new entries, in place.

    For S ≥ M the kept positions p ∈ [S−M, S) map bijectively onto slots
    p % M — a roll by (S−M) % M.  For S < M it is a plain prefix write.
    """
    m = cache_arr.shape[1]
    s = new.shape[1]
    if s < m:
        return _write_linear(cache_arr, new)
    cache_arr.copy_(torch.roll(new[:, s - m :], shifts=(s - m) % m, dims=1))
    return cache_arr


def _write(cfg: ModelConfig, cache_arr: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return _write_ring(cache_arr, new) if cfg.swa_window else _write_linear(cache_arr, new)


# ==================================================== dense-family prefill

def _gqa_prefill_layer(bp, h, a_in, positions, cfg, cl, next_norm, last_only: bool = False):
    """One attn + ffn layer that also fills its cache layer ``cl`` (views
    of the stacked cache). Returns ``(h, next_norm(h))``; with
    ``last_only`` (the last layer) only the last position goes on."""
    q, k, v = gqa_project_qkv(bp["attn"], a_in, positions, cfg)
    out = chunked_attention(q, k, v, causal=True, window=cfg.swa_window)
    _write(cfg, cl["k"], k)
    _write(cfg, cl["v"], v)
    y = attn_out(out, bp["attn"]["wo"])
    if last_only:  # nothing after the last layer reads the other positions
        y, h = y[:, -1:], h[:, -1:]
    m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
    return _mlp_seam(bp, h, m_in, cfg, next_norm)


def _cache_layer(cache: PyTree, i: int) -> Dict[str, torch.Tensor]:
    return {"k": cache["layers"]["k"][i], "v": cache["layers"]["v"][i]}


def prefill(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache: PyTree
) -> Tuple[torch.Tensor, PyTree]:
    """Process a fresh prompt (B, S); returns (last-token logits (B, V), cache)."""
    require_dense(cfg)
    S = tokens.shape[1]
    h = params["embed"][tokens].to(_dt(cfg))
    positions = torch.arange(S, device=h.device)[None, :]
    last = cfg.n_layers - 1
    _, normed = run_blocks(
        params, cfg, h,
        lambda i, bp, h, a_in, nxt: _gqa_prefill_layer(
            bp, h, a_in, positions, cfg, _cache_layer(cache, i), nxt, last_only=i == last),
    )
    cache["len"] = S
    return (normed @ lm_head(params, cfg))[:, 0], cache


# ================================================================ decode

def decode_step(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache: PyTree
) -> Tuple[torch.Tensor, PyTree]:
    """One decode step on tokens (B, 1); returns (logits (B, V), cache)."""
    require_dense(cfg)
    pos = int(cache["len"])
    h = params["embed"][tokens].to(_dt(cfg))

    def layer(i, bp, h, a_in, nxt):
        y, _ = gqa_decode(bp["attn"], a_in, {**_cache_layer(cache, i), "len": pos}, cfg)
        m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
        return _mlp_seam(bp, h, m_in, cfg, nxt)

    _, normed = run_blocks(params, cfg, h, layer)
    cache["len"] = pos + 1
    return (normed @ lm_head(params, cfg))[:, 0], cache
