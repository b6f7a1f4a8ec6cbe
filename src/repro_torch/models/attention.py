"""Attention for the dense family (port of the GQA part of
``repro/models/attention.py``).

``chunked_attention`` and ``decode_attention`` keep the reference's names
and signatures (minus the jnp chunking knobs) and call the port's kernels:
K5 ``flash_attention`` for prefill and K6 ``decode_attention`` for each
decode step, on the card; their plain versions on the CPU. Both take the
KV heads natively, so no repeated K/V is built. GQA projections carry the
optional bias, qk-norm (K1 at the head dim) and RoPE; decode appends to the
cache in place, in a ring slot under a sliding window. Cross-attention and
MLA come with their families (ROADMAP).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops
from .common import apply_rope, dense_init, rms_norm


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,  # sliding window (0 = full)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of every query over the visible keys (K5 on the card)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    cache_len: int,  # valid entries, one for the whole batch
    *,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over a KV cache (K6 on the card)."""
    return ops.decode_attention(q, k_cache, v_cache, cache_len, window=window, scale=scale)


# -- GQA attention block ----------------------------------------------------------

def gqa_params(gen: torch.Generator, cfg, dtype: torch.dtype, layers: int) -> Dict[str, Any]:
    """Attention weights of ``layers`` layers, stacked on a leading axis."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dev = gen.device
    p: Dict[str, Any] = {
        "wq": dense_init(gen, (layers, D, H, hd), dtype, fan_in=D),
        "wk": dense_init(gen, (layers, D, KV, hd), dtype, fan_in=D),
        "wv": dense_init(gen, (layers, D, KV, hd), dtype, fan_in=D),
        "wo": dense_init(gen, (layers, H, hd, D), dtype, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((layers, H, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((layers, KV, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((layers, KV, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((layers, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((layers, hd), dtype=dtype, device=dev)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, N, hd) -> (B, S, N, hd), as one matrix product."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).view(*x.shape[:-1], n, hd)


def gqa_project_qkv(
    p: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor, cfg, *, rope: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D)."""
    h, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def gqa_attention(
    p: Dict[str, Any],
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) or (1, S)
    cfg,
    *,
    causal: bool = True,
) -> torch.Tensor:
    q, k, v = gqa_project_qkv(p, x, positions, cfg)
    out = chunked_attention(q, k, v, causal=causal, window=cfg.swa_window)
    return attn_out(out, p["wo"])


def gqa_decode(
    p: Dict[str, Any],
    x: torch.Tensor,  # (B, 1, D)
    cache: Dict[str, Any],  # {k: (B, S_max, KV, hd), v: ..., len: int}
    cfg,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token: project, append k/v to the cache IN PLACE (the returned
    dict holds the same tensors), attend over the valid entries.

    Under a sliding window the cache is a ring of ``S_max`` slots: position
    ``pos`` goes to slot ``pos % S_max``. Without one, a position past the
    last slot is written to the last slot, as the reference's
    ``dynamic_update_slice`` clamps its start. Either way, once ``S_max``
    positions are in all slots are valid (effective length
    ``min(len, S_max)``), as in the reference.
    """
    pos = int(cache["len"])
    s_max = cache["k"].shape[1]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = gqa_project_qkv(p, x, positions, cfg)
    slot = pos % s_max if cfg.swa_window else min(pos, s_max - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    new_len = pos + 1
    out = decode_attention(q, cache["k"], cache["v"], min(new_len, s_max))
    return attn_out(out, p["wo"]), {"k": cache["k"], "v": cache["v"], "len": new_len}
