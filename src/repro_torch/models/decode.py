"""Serving path of the dense, moe, vlm, ssm, hybrid and audio families:
cache layouts, prefill (fills the cache, returns last-token logits), the
encoder and single-token decode (port of ``repro/models/decode.py``, with
its default ``"scan"`` cache layout).

The caches keep the reference's layouts, stacked per layer:
  * dense: ``{"len": int, "layers": {"k": (L, B, M, KV, hd), "v": ...}}``;
  * moe: the same, with the ``first_k_dense`` dense layers' stack first
    under ``"dense_layers"`` (when there are any) and the MoE layers'
    under ``"layers"``; with MLA (deepseek-v2) each stack holds the latent
    pair instead, ``{"c_kv": (L, B, M, kv_lora_rank), "k_rope": (L, B, M,
    qk_rope_head_dim)}``;
  * vlm: the self blocks' ``"layers"`` (``L - L / every`` of them) and
    ``"cross": {"k": (L / every, B, memory_len, KV, hd), "v": ...}``, the
    image tokens' K/V per cross block;
  * audio: the decoder's ``"layers"`` (L) and its ``"cross"`` stack (L),
    the encoder states' K/V per layer;
  * hybrid: ``{"len": int, "mamba": {"conv": (L, B, d_conv - 1, di + 2N),
    "h": (L, B, nh, N, P) float32}, "shared": {"k": (L / every, B, M, KV,
    hd), "v": ...}}``, one KV stack entry per application of the shared
    block;
  * ssm: ``{"len": int, "mlstm": {"conv": (Lm, B, 3, inner), "C": (Lm, B,
    nh, P, P), "n": (Lm, B, nh, P), "m": (Lm, B, nh)}, "slstm": {"conv":
    (Ls, B, 3, D), "h", "c", "n": (Ls, B, nh, hd), "m": (Ls, B, nh)}}``, all
    float32, ``m`` starting at -1e30 (no ``"slstm"`` for ``slstm_every``
    0): O(1) state, whatever ``max_len``;
with ``M = max_len``, or ``min(max_len, window)`` under a sliding window,
where the KV cache is a ring: position ``p`` lives in slot ``p % M``.
Unlike the reference, whose functions return new arrays, :func:`prefill`
and :func:`decode_step` write the cache IN PLACE and return the same dict
(with ``len`` advanced): a full-width cache is hundreds of MB per slot, and
a copy per token would double the bytes a decode step moves. Prefill
overwrites every Mamba, mLSTM and sLSTM layer's conv tail and state (the
tail left-padded with zeros for a prompt shorter than it), positions ``[0, S)``
of the KV (or latent) cache and the whole ``cross`` stack, and attention
reads only positions below ``len``, so setting ``len`` to 0 empties a
cache. The reference's ``CACHE_LAYOUT = "carry"`` variant
(``_gqa_decode_carry``, ``_mla_decode_carry``, ``_attn_decode_carry``) is
a way to lay XLA's buffers out for a scan that carries the cache; writing
in place gives one layout for both, so it has no counterpart here.

A decoded token's cross-attention is K6 over all ``memory_len`` positions
of its block's ``cross`` entry; MLA's decode is the reference's absorbed
form (:func:`repro_torch.models.attention.mla_decode`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .attention import (
    attn_out,
    chunked_attention,
    cross_attend,
    cross_kv,
    gqa_decode,
    gqa_project_qkv,
    mla_decode,
    mla_qkv,
    mla_scale,
)
from .common import add_norm
from .config import ModelConfig
from .ssm import _mamba_seq, conv_tail, mamba_decode, mamba_init_cache
from .transformer import (
    _dt,
    _mlp_seam,
    block_stacks,
    encode,  # noqa: F401 — the reference keeps encode in this module
    lm_head,
    memory_states,
    run_blocks,
    run_hybrid,
    run_ssm,
    ssm_counts,
)
from .xlstm import (
    mlstm_decode,
    mlstm_init_cache,
    mlstm_prefill,
    slstm_decode,
    slstm_init_cache,
    slstm_prefill,
)

PyTree = Any


def _ring(cfg: ModelConfig, max_len: int) -> int:
    """Effective cache length: ring of size `window` under SWA."""
    return min(max_len, cfg.swa_window) if cfg.swa_window else max_len


# ===================================================================== caches

def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, memory_len: int = 0,
    device: torch.device | str = "cpu",
) -> PyTree:
    """Empty cache for a serving session of ≤ max_len absolute positions;
    ``memory_len`` is the length of the memory (image tokens, encoder
    frames) the vlm and audio families attend to."""
    m = _ring(cfg, max_len)
    fam = cfg.family
    cache: Dict[str, Any] = {"len": 0}
    if fam in ("dense", "moe"):
        for _, key, n in block_stacks(cfg):
            cache[key] = _attn_stack(cfg, n, batch, m, device)
    elif fam in ("vlm", "audio"):
        n_cross = cfg.n_layers // cfg.cross_attn_every if fam == "vlm" else cfg.n_layers
        n_self = cfg.n_layers - n_cross if fam == "vlm" else cfg.n_layers
        cache["layers"] = _attn_stack(cfg, n_self, batch, m, device)
        cache["cross"] = _kv_stack(cfg, n_cross, batch, memory_len, device)
    elif fam == "ssm":
        counts = ssm_counts(cfg)
        for key, n, init in zip(("mlstm", "slstm"), counts, (mlstm_init_cache, slstm_init_cache)):
            if n:
                cache[key] = {k: t.expand(n, *t.shape).clone()
                              for k, t in init(cfg, batch, device).items()}
    else:
        one = mamba_init_cache(cfg, batch, _dt(cfg), device)
        cache["mamba"] = {
            k: torch.zeros((cfg.n_layers, *t.shape), dtype=t.dtype, device=device)
            for k, t in one.items()
        }
        if cfg.shared_attn_every:
            n_shared = cfg.n_layers // cfg.shared_attn_every
            cache["shared"] = _kv_stack(cfg, n_shared, batch, m, device)
    return cache


def _attn_stack(cfg: ModelConfig, n: int, batch: int, m: int, device) -> Dict[str, torch.Tensor]:
    """A self-attention stack: K/V, or MLA's latent pair."""
    if cfg.mla is None:
        return _kv_stack(cfg, n, batch, m, device)
    a = cfg.mla
    return {
        "c_kv": torch.zeros((n, batch, m, a.kv_lora_rank), dtype=_dt(cfg), device=device),
        "k_rope": torch.zeros((n, batch, m, a.qk_rope_head_dim), dtype=_dt(cfg), device=device),
    }


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


# ============================================================ prefill layers

def _attn_prefill_layer(bp, h, a_in, positions, cfg, cl, next_norm, last_only: bool = False):
    """One attn + ffn layer that also fills its cache layer ``cl`` (views
    of the stacked cache): K/V, or for MLA the latent pair. Returns ``(h,
    next_norm(h))``; with ``last_only`` (the last layer) only the last
    position goes on."""
    p = bp["attn"]
    if "w_dq" in p:
        q, k, v, c_kv, k_rope = mla_qkv(p, a_in, positions, cfg)
        out = chunked_attention(q, k, v, causal=True, scale=mla_scale(cfg))
        _write(cfg, cl["c_kv"], c_kv)
        _write(cfg, cl["k_rope"], k_rope[:, :, 0])
    else:
        q, k, v = gqa_project_qkv(p, a_in, positions, cfg)
        out = chunked_attention(q, k, v, causal=True, window=cfg.swa_window)
        _write(cfg, cl["k"], k)
        _write(cfg, cl["v"], v)
    y = attn_out(out, p["wo"])
    # nothing after the last layer reads the other positions; an MoE layer
    # still routes them all, since they compete for its experts' capacity
    if last_only and "moe" not in bp:
        y, h = y[:, -1:], h[:, -1:]
    m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
    return _mlp_seam(bp, h, m_in, cfg, next_norm)


def _cross_prefill_layer(bp, h, a_in, memory, cfg, cl, next_norm, last_only: bool = False):
    """One cross-attention + MLP layer that writes the memory's K/V into
    its ``cross`` entry ``cl`` whole. Returns ``(h, next_norm(h))``; with
    ``last_only`` only the last position is computed and goes on (each
    position's cross-attention reads the memory alone)."""
    k, v = cross_kv(bp["attn"], memory, cfg)
    if k.shape != cl["k"].shape:
        raise ValueError(f"memory of {memory.shape[1]} positions for a cache made with "
                         f"memory_len {cl['k'].shape[1]}")
    cl["k"].copy_(k)
    cl["v"].copy_(v)
    if last_only:
        a_in, h = a_in[:, -1:], h[:, -1:]
    return _cross_seams(bp, h, a_in, cl, cfg, next_norm)


def _cross_seams(bp, h, a_in, cl, cfg, next_norm):
    """A cross block over the K/V of ``cl``: returns ``(h, next_norm(h))``."""
    y = cross_attend(bp["attn"], a_in, cl["k"], cl["v"], cfg)
    m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
    return _mlp_seam(bp, h, m_in, cfg, next_norm)


def _cache_layer(cache: PyTree, i: int, stack: str = "layers") -> Dict[str, torch.Tensor]:
    """Layer ``i`` of one of the cache's stacks, as views."""
    return {k: t[i] for k, t in cache[stack].items()}


# ==================================================== hybrid-family prefill

def _mamba_prefill(p, x, cfg, cl) -> torch.Tensor:
    """Like ``mamba_block``, and fills the layer's cache ``cl`` IN PLACE:
    the conv tail (the last ``d_conv - 1`` inputs of the conv, left-padded
    with zeros for a shorter prompt, as the causal conv pads them; the
    reference keeps only the prompt's rows there, from which its decode
    cannot go on) and the final state. Both are overwritten whole."""
    out, xbc, h_final = _mamba_seq(p, x, cfg)
    conv_tail(cl["conv"], xbc)
    cl["h"].copy_(h_final)
    return out


# the ssm family's blocks by kind (transformer.ssm_plan)
_SSM_PREFILL = {"mlstm": mlstm_prefill, "slstm": slstm_prefill}
_SSM_DECODE = {"mlstm": mlstm_decode, "slstm": slstm_decode}


def prefill(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache: PyTree, *,
    memory: Optional[torch.Tensor] = None,  # vlm image tokens / audio frames (B, Sm, D)
) -> Tuple[torch.Tensor, PyTree]:
    """Process a fresh prompt (B, S); returns (last-token logits (B, V), cache)."""
    S = tokens.shape[1]
    h = params["embed"][tokens].to(_dt(cfg))
    positions = torch.arange(S, device=h.device)[None, :]
    if cfg.family == "ssm":
        _, normed = run_ssm(params, cfg, h, lambda kind, i, cell, x: _SSM_PREFILL[kind](
            cell, x, cfg, _cache_layer(cache, i, kind)))
    elif cfg.family == "hybrid":
        every = cfg.shared_attn_every
        _, normed = run_hybrid(
            params, cfg, h,
            lambda i, mp, x: _mamba_prefill(mp, x, cfg, _cache_layer(cache, i, "mamba")),
            lambda g, sp, h, a_in, nxt: _attn_prefill_layer(
                sp, h, a_in, positions, cfg, _cache_layer(cache, g, "shared"), nxt,
                last_only=(g + 1) * every == cfg.n_layers),
        )
    else:
        mem = memory_states(params, cfg, memory)

        def layer(b, bp, h, a_in, nxt):
            cl = _cache_layer(cache, b.index, b.cache_key)
            if b.cache_key == "cross":
                return _cross_prefill_layer(bp, h, a_in, mem, cfg, cl, nxt, last_only=b.last)
            return _attn_prefill_layer(bp, h, a_in, positions, cfg, cl, nxt, last_only=b.last)

        _, normed = run_blocks(params, cfg, h, layer)
    cache["len"] = S
    return (normed[:, -1:] @ lm_head(params, cfg))[:, 0], cache


# ================================================================ decode

def decode_step(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache: PyTree
) -> Tuple[torch.Tensor, PyTree]:
    """One decode step on tokens (B, 1); returns (logits (B, V), cache)."""
    pos = int(cache["len"])
    h = params["embed"][tokens].to(_dt(cfg))

    def attn_mlp(bp, h, a_in, nxt, cl):
        dec = mla_decode if "w_dq" in bp["attn"] else gqa_decode
        y, _ = dec(bp["attn"], a_in, {**cl, "len": pos}, cfg)
        m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
        return _mlp_seam(bp, h, m_in, cfg, nxt)

    if cfg.family == "ssm":
        _, normed = run_ssm(params, cfg, h, lambda kind, i, cell, x: _SSM_DECODE[kind](
            cell, x, _cache_layer(cache, i, kind), cfg)[0])
    elif cfg.family == "hybrid":
        _, normed = run_hybrid(
            params, cfg, h,
            lambda i, mp, x: mamba_decode(mp, x, _cache_layer(cache, i, "mamba"), cfg)[0],
            lambda g, sp, h, a_in, nxt: attn_mlp(sp, h, a_in, nxt, _cache_layer(cache, g, "shared")),
        )
    else:
        def layer(b, bp, h, a_in, nxt):
            cl = _cache_layer(cache, b.index, b.cache_key)
            if b.cache_key == "cross":
                return _cross_seams(bp, h, a_in, cl, cfg, nxt)
            return attn_mlp(bp, h, a_in, nxt, cl)

        _, normed = run_blocks(params, cfg, h, layer)
    cache["len"] = pos + 1
    return (normed @ lm_head(params, cfg))[:, 0], cache
