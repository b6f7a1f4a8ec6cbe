"""Attention: GQA, cross-attention and MLA (port of
``repro/models/attention.py``).

``chunked_attention`` and ``decode_attention`` keep the reference's names
and signatures (minus the jnp chunking knobs) and call the port's kernels:
K5 ``flash_attention`` for prefill and K6 ``decode_attention`` for each
decode step, on the card; their plain versions on the CPU. Both take the
KV heads natively, so no repeated K/V is built. GQA projections carry the
optional bias, qk-norm (K1 at the head dim) and RoPE; decode appends to the
cache in place, in a ring slot under a sliding window.

Cross-attention (llama-3.2-vision's gated blocks, the seamless decoder's)
attends from the token stream to a memory of image tokens or encoder
states, without a mask and with Sq != Sk: K5 at prefill; one decoded token
against the memory is K6 over all of it (``cross_attend``). MLA
(deepseek-v2) projects q through a low-rank ``w_dq``/``w_uq`` and K/V
through the latent ``c_kv`` (K1 at the ranks, 1536 and 512): prefill
expands K/V per head (q/k head dim nope + rope, 192, against v's 128, K5's
route (a)); decode is the reference's absorbed form, plain matrix products
and a float32 softmax over the latent cache, which the reference leaves to
XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops
from .common import apply_rope, dense_init, rms_norm


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd_v), hd_v <= hd
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


# -- Cross-attention (VLM / enc-dec) -----------------------------------------------

def cross_attn_params(gen: torch.Generator, cfg, dtype: torch.dtype, layers: int,
                      gated: bool = False) -> Dict[str, Any]:
    """GQA weights plus the memory's ``k_input_norm`` gain and, gated, the
    per-layer ``gate`` (0, as in the reference: a 0-d scalar per layer)."""
    p = gqa_params(gen, cfg, dtype, layers)
    p["k_input_norm"] = torch.ones((layers, cfg.d_model), dtype=dtype, device=gen.device)
    if gated:
        p["gate"] = torch.zeros((layers,), dtype=dtype, device=gen.device)
    return p


def cross_kv(p: Dict[str, Any], memory: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V of the memory (B, Sm, D): its RMS norm (K1), projected, k
    normed where the config has qk-norm."""
    mem = rms_norm(memory, p["k_input_norm"])
    k, v = _project(mem, p["wk"]), _project(mem, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v


def cross_attend(p: Dict[str, Any], x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg) -> torch.Tensor:
    """Queries of x (B, Sq, D) over every position of k/v (B, Sm, KV, hd):
    K5 without a mask, or for one query K6 over all Sm positions; the
    output projection, scaled by tanh(gate) in a gated block."""
    q = _project(x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    if q.shape[1] == 1:
        out = decode_attention(q, k, v, k.shape[1])
    else:
        out = chunked_attention(q, k, v, causal=False)
    y = attn_out(out, p["wo"])
    if "gate" in p:
        y = torch.tanh(p["gate"]).to(y.dtype) * y
    return y


def cross_attention(
    p: Dict[str, Any],
    x: torch.Tensor,  # (B, Sq, D) queries
    memory: torch.Tensor,  # (B, Sm, D) encoder / vision states
    cfg,
) -> torch.Tensor:
    k, v = cross_kv(p, memory, cfg)
    return cross_attend(p, x, k, v, cfg)


# -- MLA (DeepSeek-V2) ---------------------------------------------------------------

def mla_params(gen: torch.Generator, cfg, dtype: torch.dtype, layers: int) -> Dict[str, Any]:
    """MLA weights of ``layers`` layers, stacked on a leading axis."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "w_dq": dense_init(gen, (layers, D, m.q_lora_rank), dtype, fan_in=D),
        "q_norm": torch.ones((layers, m.q_lora_rank), dtype=dtype, device=dev),
        "w_uq": dense_init(gen, (layers, m.q_lora_rank, H, qk_hd), dtype, fan_in=m.q_lora_rank),
        "w_dkv": dense_init(gen, (layers, D, m.kv_lora_rank), dtype, fan_in=D),
        "kv_norm": torch.ones((layers, m.kv_lora_rank), dtype=dtype, device=dev),
        "w_krope": dense_init(gen, (layers, D, m.qk_rope_head_dim), dtype, fan_in=D),
        "w_uk": dense_init(gen, (layers, m.kv_lora_rank, H, m.qk_nope_head_dim), dtype,
                           fan_in=m.kv_lora_rank),
        "w_uv": dense_init(gen, (layers, m.kv_lora_rank, H, m.v_head_dim), dtype,
                           fan_in=m.kv_lora_rank),
        "wo": dense_init(gen, (layers, H, m.v_head_dim, D), dtype, fan_in=H * m.v_head_dim),
    }


def mla_scale(cfg) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _mla_q(p, x, positions, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    cq = rms_norm(x @ p["w_dq"], p["q_norm"])
    q = _project(cq, p["w_uq"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim :], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, positions, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cached pair: c_kv (B, S, r) and the shared k_rope (B, S, 1, rope_hd)."""
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"])
    k_rope = apply_rope((x @ p["w_krope"])[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_qkv(p: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor, cfg):
    """Prefill's expanded q, k (B, S, H, nope + rope) and v (B, S, H, v_hd),
    and the latent pair the cache keeps (c_kv, k_rope)."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_latent(p, x, positions, cfg)
    k_nope, v = _project(c_kv, p["w_uk"]), _project(c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, c_kv, k_rope


def mla_attention(
    p: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor, cfg
) -> torch.Tensor:
    """Prefill/training path: K/V expanded per head from the latent."""
    q, k, v, _, _ = mla_qkv(p, x, positions, cfg)
    out = chunked_attention(q, k, v, causal=True, scale=mla_scale(cfg))
    return attn_out(out, p["wo"])


def mla_decode(
    p: Dict[str, Any],
    x: torch.Tensor,  # (B, 1, D)
    cache: Dict[str, Any],  # {c_kv: (B, S_max, r), k_rope: (B, S_max, rope_hd), len: int}
    cfg,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Absorbed decode: the cache holds only (c_kv, k_rope), written IN
    PLACE (a position past the last slot goes to the last slot, as the
    reference's clamped ``dynamic_update_slice``); W_uk is absorbed into the
    query and W_uv applied after, so a token's work is O(S·r), not
    O(S·H·hd). Scores over the valid positions only (the reference's masked
    ones weigh exactly 0); the softmax and the latent output in float32,
    rounded to the activation type before W_uv, as in the reference."""
    pos = int(cache["len"])
    s_max = cache["c_kv"].shape[1]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)  # (B, 1, H, .)
    c_new, kr_new = _mla_latent(p, x, positions, cfg)
    slot = min(pos, s_max - 1)
    cache["c_kv"][:, slot] = c_new[:, 0]
    cache["k_rope"][:, slot] = kr_new[:, 0, 0]
    new_len = pos + 1
    n = min(new_len, s_max)
    c_kv, k_rope = cache["c_kv"][:, :n], cache["k_rope"][:, :n]

    # scores: q_nope absorbed through W_uk into the latent space
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"])  # (B, H, r)
    s_lat = torch.einsum("bhr,bmr->bhm", q_lat, c_kv)
    s_rope = torch.einsum("bhk,bmk->bhm", q_rope[:, 0], k_rope)
    s = ((s_lat + s_rope) * mla_scale(cfg)).float()
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhm,bmr->bhr", prob, c_kv.float())  # (B, H, r)
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(x.dtype), p["w_uv"])  # (B, H, v_hd)
    y = attn_out(o[:, None], p["wo"])
    return y, {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"], "len": new_len}
