"""Serving path of the dense, moe and hybrid families: cache layouts, prefill
(fills the cache, returns last-token logits) and single-token decode (port
of the dense, moe and hybrid parts of ``repro/models/decode.py``, its
default ``"scan"`` cache layout).

The caches keep the reference's layouts, stacked per layer:
  * dense: ``{"len": int, "layers": {"k": (L, B, M, KV, hd), "v": ...}}``;
  * moe: the same, with the ``first_k_dense`` dense layers' stack first
    under ``"dense_layers"`` (when there are any) and the MoE layers'
    under ``"layers"``;
  * hybrid: ``{"len": int, "mamba": {"conv": (L, B, d_conv - 1, di + 2N),
    "h": (L, B, nh, N, P) float32}, "shared": {"k": (L / every, B, M, KV,
    hd), "v": ...}}``, one KV stack entry per application of the shared
    block;
with ``M = max_len``, or ``min(max_len, window)`` under a sliding window,
where the KV cache is a ring: position ``p`` lives in slot ``p % M``.
Unlike the reference, whose functions return new arrays, :func:`prefill`
and :func:`decode_step` write the cache IN PLACE and return the same dict
(with ``len`` advanced): a full-width cache is hundreds of MB per slot, and
a copy per token would double the bytes a decode step moves. Prefill
overwrites every Mamba layer's conv tail and state and positions ``[0, S)``
of the KV cache, and attention reads only positions below ``len``, so
setting ``len`` to 0 empties a cache.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .attention import attn_out, chunked_attention, gqa_decode, gqa_project_qkv
from .common import add_norm
from .config import ModelConfig
from .ssm import _mamba_seq, mamba_decode, mamba_init_cache
from .transformer import (
    _dt,
    _mlp_seam,
    block_stacks,
    lm_head,
    require_supported,
    run_blocks,
    run_hybrid,
)

PyTree = Any


def _ring(cfg: ModelConfig, max_len: int) -> int:
    """Effective cache length: ring of size `window` under SWA."""
    return min(max_len, cfg.swa_window) if cfg.swa_window else max_len


# ===================================================================== caches

def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: torch.device | str = "cpu"
) -> PyTree:
    """Empty cache for a serving session of ≤ max_len absolute positions."""
    require_supported(cfg)
    m = _ring(cfg, max_len)
    if cfg.family in ("dense", "moe"):
        cache = {"len": 0}
        for _, key, n in block_stacks(cfg):
            cache[key] = _kv_stack(cfg, n, batch, m, device)
        return cache
    one = mamba_init_cache(cfg, batch, _dt(cfg), device)
    cache = {"len": 0, "mamba": {
        k: torch.zeros((cfg.n_layers, *t.shape), dtype=t.dtype, device=device)
        for k, t in one.items()
    }}
    if cfg.shared_attn_every:
        n_shared = cfg.n_layers // cfg.shared_attn_every
        cache["shared"] = _kv_stack(cfg, n_shared, batch, m, device)
    return cache


def _kv_stack(cfg: ModelConfig, n: int, batch: int, m: int, device) -> Dict[str, torch.Tensor]:
    shape = (n, batch, m, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=_dt(cfg), device=device),
        "v": torch.zeros(shape, dtype=_dt(cfg), device=device),
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
    # nothing after the last layer reads the other positions; an MoE layer
    # still routes them all, since they compete for its experts' capacity
    if last_only and "moe" not in bp:
        y, h = y[:, -1:], h[:, -1:]
    m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
    return _mlp_seam(bp, h, m_in, cfg, next_norm)


def _cache_layer(cache: PyTree, i: int, stack: str = "layers") -> Dict[str, torch.Tensor]:
    """Layer ``i`` of one of the cache's stacks, as views."""
    return {k: t[i] for k, t in cache[stack].items()}


def _block_cache(cache: PyTree, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    """The cache layer of attention block ``i``, counted over every stack of
    :func:`~repro_torch.models.transformer.block_stacks`."""
    for _, key, n in block_stacks(cfg):
        if i < n:
            return _cache_layer(cache, i, key)
        i -= n
    raise IndexError(f"block {i} past the last layer")


# ==================================================== hybrid-family prefill

def _mamba_prefill(p, x, cfg, cl) -> torch.Tensor:
    """Like ``mamba_block``, and fills the layer's cache ``cl`` IN PLACE:
    the conv tail (the last ``d_conv - 1`` inputs of the conv, left-padded
    with zeros for a shorter prompt, as the causal conv pads them; the
    reference keeps only the prompt's rows there, from which its decode
    cannot go on) and the final state. Both are overwritten whole."""
    out, xbc, h_final = _mamba_seq(p, x, cfg)
    conv = cl["conv"]
    k = conv.shape[1]
    tail = xbc[:, -k:]
    conv[:, : k - tail.shape[1]] = 0
    conv[:, k - tail.shape[1] :] = tail
    cl["h"].copy_(h_final)
    return out


def prefill(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache: PyTree
) -> Tuple[torch.Tensor, PyTree]:
    """Process a fresh prompt (B, S); returns (last-token logits (B, V), cache)."""
    require_supported(cfg)
    S = tokens.shape[1]
    h = params["embed"][tokens].to(_dt(cfg))
    positions = torch.arange(S, device=h.device)[None, :]
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        _, normed = run_hybrid(
            params, cfg, h,
            lambda i, mp, x: _mamba_prefill(mp, x, cfg, _cache_layer(cache, i, "mamba")),
            lambda g, sp, h, a_in, nxt: _gqa_prefill_layer(
                sp, h, a_in, positions, cfg, _cache_layer(cache, g, "shared"), nxt,
                last_only=(g + 1) * every == cfg.n_layers),
        )
    else:
        last = cfg.n_layers - 1
        _, normed = run_blocks(
            params, cfg, h,
            lambda i, bp, h, a_in, nxt: _gqa_prefill_layer(
                bp, h, a_in, positions, cfg, _block_cache(cache, cfg, i), nxt,
                last_only=i == last),
        )
    cache["len"] = S
    return (normed[:, -1:] @ lm_head(params, cfg))[:, 0], cache


# ================================================================ decode

def decode_step(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache: PyTree
) -> Tuple[torch.Tensor, PyTree]:
    """One decode step on tokens (B, 1); returns (logits (B, V), cache)."""
    require_supported(cfg)
    pos = int(cache["len"])
    h = params["embed"][tokens].to(_dt(cfg))

    def attn_mlp(bp, h, a_in, nxt, cl):
        y, _ = gqa_decode(bp["attn"], a_in, {**cl, "len": pos}, cfg)
        m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
        return _mlp_seam(bp, h, m_in, cfg, nxt)

    if cfg.family == "hybrid":
        _, normed = run_hybrid(
            params, cfg, h,
            lambda i, mp, x: mamba_decode(mp, x, _cache_layer(cache, i, "mamba"), cfg)[0],
            lambda g, sp, h, a_in, nxt: attn_mlp(sp, h, a_in, nxt, _cache_layer(cache, g, "shared")),
        )
    else:
        _, normed = run_blocks(
            params, cfg, h,
            lambda i, bp, h, a_in, nxt: attn_mlp(bp, h, a_in, nxt,
                                                 _block_cache(cache, cfg, i)),
        )
    cache["len"] = pos + 1
    return (normed @ lm_head(params, cfg))[:, 0], cache
