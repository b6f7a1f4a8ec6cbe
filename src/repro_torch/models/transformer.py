"""Model assembly for the dense, moe and hybrid families: parameter init and
the teacher-forcing forward (port of the dense, moe and hybrid parts of
``repro/models/transformer.py``).

Parameters are a plain dictionary of tensors in the reference's layout:
the per-layer weights stacked on a leading ``L`` axis (``wq (L, D, H, hd)``,
``wo (L, H, hd, D)``, ``mamba_blocks.mixer.w_in (L, D, E)``, …), and the
hybrid family's one shared attention block unstacked, so
:func:`repro_torch.convert.params_from_jax` moves arrays without re-laying
them out. Layers run in a Python loop over views of the stack (PyTorch runs
eagerly; there is no ``scan`` to lower).

Each residual seam is one K4 pass: in a dense block ``h + attn`` feeds the
MLP norm, and ``h + mlp`` feeds the next layer's attention norm (the final
norm after the last layer); only layer 0's attention norm is a K1 pass of
its own. The moe family (mixtral; deepseek-v2's layout without MLA) runs
the same blocks with ``moe_layer`` in place of the MLP from layer
``first_k_dense`` on (``dense_blocks`` then ``blocks``). The hybrid family
(zamba2) runs Mamba2 layers, ``h + mixer(norm(h))``, with the shared
attention + MLP block after every
``shared_attn_every``-th: each ``h + mixer`` seam feeds the next Mamba
norm, the shared block's attention norm or the final norm, and the shared
block's own two seams are a dense block's; K1 runs the first Mamba norm
(and, inside the mixer, the gated ``out_norm``). Other families raise
``NotImplementedError`` naming the slice of the port that brings them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .attention import gqa_attention, gqa_params
from .common import add_norm, apply_norm, dense_init, embed_init, norm_params
from .config import ModelConfig
from .mlp import mlp, mlp_params, moe_layer, moe_params
from .ssm import mamba_block, mamba_params

PyTree = Any

# the slice of the port (ROADMAP queue 1) that brings each family or
# feature the port lacks
FAMILY_SLICE = {
    "mla": "the MLA slice (deepseek-v2, ROADMAP item 14)",
    "vlm": "the vlm slice (llama-3.2-vision cross-attention, ROADMAP item 15)",
    "audio": "the audio slice (seamless encoder-decoder, ROADMAP item 16)",
    "ssm": "the ssm slice (xlstm, ROADMAP item 17)",
}


def require_supported(cfg: ModelConfig) -> None:
    if cfg.family == "moe" and cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the moe family with grouped-query attention; "
            f"multi-head latent attention comes with {FAMILY_SLICE['mla']}"
        )
    if cfg.family not in ("dense", "moe", "hybrid"):
        slice_ = FAMILY_SLICE.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense, moe and hybrid families only; family "
            f"{cfg.family!r} comes with {slice_}"
        )


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ======================================================================== init

def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: Optional[torch.device | str] = None
) -> PyTree:
    """Random weights drawn from ``generator`` on its device, then moved to
    ``device`` (default: where they were drawn). Norm gains are ones and
    biases zeros, as in the reference; the numbers differ from
    ``jax.random``'s (tests load the reference's with ``params_from_jax``)."""
    require_supported(cfg)
    dtype = _dt(cfg)
    V, D, L = cfg.padded_vocab, cfg.d_model, cfg.n_layers
    dev = generator.device
    params: Dict[str, PyTree] = {
        "embed": embed_init(generator, (V, D), dtype),
        "final_norm": norm_params(cfg.norm, D, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (D, V), dtype)
    if cfg.family == "dense":
        params["blocks"] = _dense_layers(generator, cfg, dtype, L)
    elif cfg.family == "moe":
        k = cfg.moe.first_k_dense
        if k:
            params["dense_blocks"] = _dense_layers(generator, cfg, dtype, k, cfg.moe.dense_ff)
        params["blocks"] = _moe_layers(generator, cfg, dtype, L - k)
    else:
        params["mamba_blocks"] = {
            "norm": norm_params(cfg.norm, (L, D), dtype, dev),
            "mixer": mamba_params(generator, cfg, dtype, L),
        }
        # ONE shared transformer block (weights reused at every application)
        params["shared_attn"] = tree_map(
            lambda t: t[0], _dense_layers(generator, cfg, dtype, 1))
    if device is not None and torch.device(device) != dev:
        params = tree_map(lambda t: t.to(device), params)
    return params


def _dense_layers(
    gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, n: int,
    d_ff: Optional[int] = None,
) -> PyTree:
    """``n`` attn + MLP layers' weights, stacked on a leading axis."""
    D = cfg.d_model
    return {
        "attn_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "attn": gqa_params(gen, cfg, dtype, n),
        "mlp_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "mlp": mlp_params(gen, D, d_ff or cfg.d_ff, cfg.activation, dtype, n),
    }


def _moe_layers(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, n: int) -> PyTree:
    """``n`` attn + MoE layers' weights, stacked on a leading axis."""
    D = cfg.d_model
    return {
        "attn_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "attn": gqa_params(gen, cfg, dtype, n),
        "mlp_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "moe": moe_params(gen, cfg, dtype, n),
    }


def tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layers(blocks: PyTree, n: int) -> List[PyTree]:
    """The stacked block parameters as ``n`` per-layer trees of views."""
    return [tree_map(lambda t, i=i: t[i], blocks) for i in range(n)]


def lm_head(params: PyTree, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# ======================================================================== blocks

def _dense_block(
    bp: PyTree,
    h: torch.Tensor,
    a_in: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    next_norm: Dict[str, torch.Tensor],
    *,
    causal: bool = True,
):
    """One attn + MLP layer on the stream ``h`` whose attention input
    ``a_in = attn_norm(h)`` is given; returns ``(h, next_norm(h))``."""
    y = gqa_attention(bp["attn"], a_in, positions, cfg, causal=causal)
    m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
    return _mlp_seam(bp, h, m_in, cfg, next_norm)


def _mlp_seam(bp, h, m_in, cfg: ModelConfig, next_norm):
    """h + mlp(m_in) (``moe_layer`` in an MoE block), normed for what comes
    next: returns (h, normed)."""
    if "moe" in bp:
        y = moe_layer(bp["moe"], m_in, cfg)
    else:
        y = mlp(bp["mlp"], m_in, cfg.activation)
    normed, h = add_norm(y, h, next_norm, cfg.norm)
    return h, normed


def block_stacks(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    """The stacks of attention blocks in order, as (params key, cache key,
    layers): an moe model's ``first_k_dense`` dense blocks come first."""
    k = cfg.moe.first_k_dense if cfg.family == "moe" else 0
    stacks = [("dense_blocks", "dense_layers", k)] if k else []
    return stacks + [("blocks", "layers", cfg.n_layers - k)]


def run_blocks(params: PyTree, cfg: ModelConfig, h: torch.Tensor, layer_fn):
    """Drive ``layer_fn(i, bp, h, a_in, next_norm) -> (h, a_in)`` over the
    layers (``i`` counts every stack of :func:`block_stacks`); returns the
    stream and its final-normed version."""
    blocks = [bp for key, _, n in block_stacks(cfg) for bp in layers(params[key], n)]
    a_in = apply_norm(h, blocks[0]["attn_norm"], cfg.norm)
    for i, bp in enumerate(blocks):
        nxt = blocks[i + 1]["attn_norm"] if i + 1 < len(blocks) else params["final_norm"]
        h, a_in = layer_fn(i, bp, h, a_in, nxt)
    return h, a_in


def run_hybrid(params: PyTree, cfg: ModelConfig, h: torch.Tensor, mamba_fn, shared_fn):
    """Drive the hybrid stack: Mamba layer ``i`` adds ``mamba_fn(i, mixer,
    norm_i(h))`` to the stream; after every ``shared_attn_every``-th the
    shared block runs as ``shared_fn(g, shared, h, a_in, next_norm) -> (h,
    normed)``, ``g`` its application and ``a_in`` its attention norm of h.
    Returns the stream and its final-normed version."""
    every = cfg.shared_attn_every
    shared = params["shared_attn"] if every else None
    blocks = layers(params["mamba_blocks"], cfg.n_layers)
    norms = [bp["norm"] for bp in blocks[1:]] + [params["final_norm"]]
    normed = apply_norm(h, blocks[0]["norm"], cfg.norm)
    for i, bp in enumerate(blocks):
        y = mamba_fn(i, bp["mixer"], normed)
        if every and i % every == every - 1:
            a_in, h = add_norm(y, h, shared["attn_norm"], cfg.norm)
            h, normed = shared_fn(i // every, shared, h, a_in, norms[i])
        else:
            normed, h = add_norm(y, h, norms[i], cfg.norm)
    return h, normed


# ======================================================================== forward

def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing forward → logits (B, S, V)."""
    require_supported(cfg)
    S = tokens.shape[1]
    h = params["embed"][tokens].to(_dt(cfg))
    positions = torch.arange(S, device=h.device)[None, :]
    if cfg.family == "hybrid":
        _, normed = run_hybrid(
            params, cfg, h,
            lambda i, mp, x: mamba_block(mp, x, cfg),
            lambda g, sp, h, a_in, nxt: _dense_block(sp, h, a_in, positions, cfg, nxt),
        )
    else:
        _, normed = run_blocks(
            params, cfg, h,
            lambda i, bp, h, a_in, nxt: _dense_block(bp, h, a_in, positions, cfg, nxt),
        )
    return normed @ lm_head(params, cfg)
