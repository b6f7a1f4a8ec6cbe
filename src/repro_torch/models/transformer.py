"""Model assembly for the dense family: parameter init and the
teacher-forcing forward (port of the dense part of
``repro/models/transformer.py``).

Parameters are a plain dictionary of tensors in the reference's layout:
the per-layer weights stacked on a leading ``L`` axis (``wq (L, D, H, hd)``,
``wo (L, H, hd, D)``, …), so :func:`repro_torch.convert.params_from_jax`
moves arrays without re-laying them out. Layers run in a Python loop over
views of the stack (PyTorch runs eagerly; there is no ``scan`` to lower).

Each block's two residual seams are one K4 pass each: ``h + attn`` feeds
the MLP norm, and ``h + mlp`` feeds the next layer's attention norm (the
final norm after the last layer); only layer 0's attention norm is a K1
pass of its own. Other families raise ``NotImplementedError`` naming the
slice of the port that brings them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .attention import gqa_attention, gqa_params
from .common import add_norm, apply_norm, dense_init, embed_init, norm_params
from .config import ModelConfig
from .mlp import mlp, mlp_params

PyTree = Any

# the slice of the port (ROADMAP) that brings each family the dense one lacks
FAMILY_SLICE = {
    "hybrid": "the hybrid slice (zamba2: models/ssm.py with K7 ssd_scan)",
    "moe": "the moe/MLA slice (mixtral, deepseek-v2)",
    "vlm": "the vlm slice (llama-3.2-vision cross-attention)",
    "audio": "the audio slice (seamless encoder-decoder)",
    "ssm": "the ssm slice (xlstm)",
}


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        slice_ = FAMILY_SLICE.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense family only; family {cfg.family!r} "
            f"comes with {slice_}"
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
    require_dense(cfg)
    dtype = _dt(cfg)
    V, D, L = cfg.padded_vocab, cfg.d_model, cfg.n_layers
    dev = generator.device
    params: Dict[str, PyTree] = {
        "embed": embed_init(generator, (V, D), dtype),
        "final_norm": norm_params(cfg.norm, D, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (D, V), dtype)
    params["blocks"] = {
        "attn_norm": norm_params(cfg.norm, (L, D), dtype, dev),
        "attn": gqa_params(generator, cfg, dtype, L),
        "mlp_norm": norm_params(cfg.norm, (L, D), dtype, dev),
        "mlp": mlp_params(generator, D, cfg.d_ff, cfg.activation, dtype, L),
    }
    if device is not None and torch.device(device) != dev:
        params = tree_map(lambda t: t.to(device), params)
    return params


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
    """h + mlp(m_in), normed for what comes next: returns (h, normed)."""
    y = mlp(bp["mlp"], m_in, cfg.activation)
    normed, h = add_norm(y, h, next_norm, cfg.norm)
    return h, normed


def run_blocks(params: PyTree, cfg: ModelConfig, h: torch.Tensor, layer_fn):
    """Drive ``layer_fn(i, bp, h, a_in, next_norm) -> (h, a_in)`` over the
    layers; returns the stream and its final-normed version."""
    blocks = layers(params["blocks"], cfg.n_layers)
    a_in = apply_norm(h, blocks[0]["attn_norm"], cfg.norm)
    for i, bp in enumerate(blocks):
        nxt = blocks[i + 1]["attn_norm"] if i + 1 < len(blocks) else params["final_norm"]
        h, a_in = layer_fn(i, bp, h, a_in, nxt)
    return h, a_in


# ======================================================================== forward

def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing forward → logits (B, S, V)."""
    require_dense(cfg)
    S = tokens.shape[1]
    h = params["embed"][tokens].to(_dt(cfg))
    positions = torch.arange(S, device=h.device)[None, :]
    _, normed = run_blocks(
        params, cfg, h,
        lambda i, bp, h, a_in, nxt: _dense_block(bp, h, a_in, positions, cfg, nxt),
    )
    return normed @ lm_head(params, cfg)
