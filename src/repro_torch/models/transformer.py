"""Model assembly for the dense, moe, vlm, ssm, hybrid and audio families:
parameter init, the encoder and the teacher-forcing forward (port of
``repro/models/transformer.py``).

Parameters are a plain dictionary of tensors in the reference's layout:
the per-layer weights stacked on a leading ``L`` axis (``wq (L, D, H, hd)``,
``wo (L, H, hd, D)``, ``mamba_blocks.mixer.w_in (L, D, E)``,
``mlstm_blocks.cell.wq (L, inner, inner)``, a gated cross
block's ``gate (L,)``, …), and the hybrid family's one shared attention
block unstacked, so :func:`repro_torch.convert.params_from_jax` moves
arrays without re-laying them out. Layers run in a Python loop over views
of the stack (PyTorch runs eagerly; there is no ``scan`` to lower).

Each residual seam is one K4 pass: in a block ``h + attn`` feeds the MLP
norm, and ``h + mlp`` feeds the next block's attention norm (the final
norm after the last block); only the first block's attention norm is a K1
pass of its own. :func:`block_plan` gives the decoder's blocks in order:
  * dense: attn + MLP blocks (GQA);
  * moe: the same with ``moe_layer`` in place of the MLP from layer
    ``first_k_dense`` on (``dense_blocks`` then ``blocks``): mixtral with
    GQA, deepseek-v2 with MLA in every block (``"w_dq" in bp["attn"]``);
  * vlm (llama-3.2-vision): ``cross_attn_every - 1`` self blocks, then a
    gated cross-attention block over the image tokens, repeated;
  * audio (seamless): each decoder layer a self block and a cross block
    over the encoder's states; the encoder (:func:`encode`) is a stack of
    non-causal attn + MLP blocks over the frames, between two norms.
The hybrid family (zamba2) runs Mamba2 layers, ``h + mixer(norm(h))``,
with the shared attention + MLP block after every
``shared_attn_every``-th: each ``h + mixer`` seam feeds the next Mamba
norm, the shared block's attention norm or the final norm, and the shared
block's own two seams are a dense block's; K1 runs the first Mamba norm
(and, inside the mixer, the gated ``out_norm``). The ssm family (xlstm)
runs groups of ``slstm_every - 1`` mLSTM blocks then one sLSTM block
(:func:`ssm_plan`, :func:`run_ssm`), each ``h + block(norm(h))``: the first
norm a K1 pass, every seam after a block one K4 pass into the next block's
norm or the final norm. LayerNorm seams (nemotron, seamless) are plain
torch, as in the reference.

Under autograd (grad enabled and a parameter that requires it, as in
``train/step.py``) the drivers change in two ways, and the serving path,
which needs no gradient, keeps its views and its single pass:
  * each block runs under ``torch.utils.checkpoint`` (:data:`REMAT`), so
    its activations are recomputed in the backward, as the reference's
    ``jax.checkpoint(..., nothing_saveable)`` around every block;
  * each stacked parameter is split once with ``unbind``
    (:func:`stack_views`), whose backward stacks the per-layer gradients
    once; ``t[i]``'s backward would write a zero-filled gradient of the
    whole stack for every layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from .attention import (
    cross_attention,
    cross_attn_params,
    gqa_attention,
    gqa_params,
    mla_attention,
    mla_params,
)
from .common import add_norm, apply_norm, dense_init, embed_init, norm_params
from .config import ModelConfig
from .mlp import mlp, mlp_params, moe_layer, moe_params
from .ssm import mamba_block, mamba_params
from .xlstm import mlstm_block, mlstm_params, slstm_block, slstm_params

PyTree = Any
REMAT = True  # recompute each block in the backward (the reference's remat)


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
    dtype = _dt(cfg)
    V, D, L = cfg.padded_vocab, cfg.d_model, cfg.n_layers
    dev = generator.device
    params: Dict[str, PyTree] = {
        "embed": embed_init(generator, (V, D), dtype),
        "final_norm": norm_params(cfg.norm, D, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (D, V), dtype)
    fam = cfg.family
    if fam == "dense":
        params["blocks"] = _dense_layers(generator, cfg, dtype, L)
    elif fam == "moe":
        k = cfg.moe.first_k_dense
        if k:
            params["dense_blocks"] = _dense_layers(generator, cfg, dtype, k, cfg.moe.dense_ff,
                                                   use_mla=cfg.mla is not None)
        params["blocks"] = _moe_layers(generator, cfg, dtype, L - k)
    elif fam == "vlm":
        n_cross = L // cfg.cross_attn_every
        if (L - n_cross) % n_cross:
            raise ValueError(f"{cfg.name}: {L} layers do not split into groups of "
                             f"{cfg.cross_attn_every} ending in a cross-attention layer")
        params["blocks"] = _dense_layers(generator, cfg, dtype, L - n_cross)
        params["cross_blocks"] = _cross_layers(generator, cfg, dtype, n_cross, gated=True)
    elif fam == "audio":
        params["enc_embed_norm"] = norm_params(cfg.norm, D, dtype, dev)
        params["encoder"] = _dense_layers(generator, cfg, dtype, cfg.n_encoder_layers)
        params["enc_final_norm"] = norm_params(cfg.norm, D, dtype, dev)
        params["blocks"] = _dense_layers(generator, cfg, dtype, L)
        params["cross_blocks"] = _cross_layers(generator, cfg, dtype, L, gated=False)
    elif fam == "ssm":
        n_m, n_s = ssm_counts(cfg)
        params["mlstm_blocks"] = {
            "norm": norm_params(cfg.norm, (n_m, D), dtype, dev),
            "cell": mlstm_params(generator, cfg, dtype, n_m),
        }
        if n_s:
            params["slstm_blocks"] = {
                "norm": norm_params(cfg.norm, (n_s, D), dtype, dev),
                "cell": slstm_params(generator, cfg, dtype, n_s),
            }
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


def _attn_params(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, n: int,
                 use_mla: bool) -> PyTree:
    return mla_params(gen, cfg, dtype, n) if use_mla else gqa_params(gen, cfg, dtype, n)


def _dense_layers(
    gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, n: int,
    d_ff: Optional[int] = None, use_mla: bool = False,
) -> PyTree:
    """``n`` attn + MLP layers' weights, stacked on a leading axis."""
    D = cfg.d_model
    return {
        "attn_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "attn": _attn_params(gen, cfg, dtype, n, use_mla),
        "mlp_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "mlp": mlp_params(gen, D, d_ff or cfg.d_ff, cfg.activation, dtype, n),
    }


def _moe_layers(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, n: int) -> PyTree:
    """``n`` attn + MoE layers' weights, stacked on a leading axis."""
    D = cfg.d_model
    return {
        "attn_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "attn": _attn_params(gen, cfg, dtype, n, cfg.mla is not None),
        "mlp_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "moe": moe_params(gen, cfg, dtype, n),
    }


def _cross_layers(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, n: int,
                  gated: bool) -> PyTree:
    """``n`` cross-attention + MLP layers' weights, stacked on a leading axis."""
    D = cfg.d_model
    return {
        "attn_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "attn": cross_attn_params(gen, cfg, dtype, n, gated=gated),
        "mlp_norm": norm_params(cfg.norm, (n, D), dtype, gen.device),
        "mlp": mlp_params(gen, D, cfg.d_ff, cfg.activation, dtype, n),
    }


def tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: PyTree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def training(params: PyTree) -> bool:
    """Whether autograd will need the parameters' gradients."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in _leaves(params))


def stack_views(blocks: PyTree, train: bool):
    """Layer ``i`` of a stack as a tree, through the returned function: a
    view ``t[i]`` of each leaf, or under autograd (``train``) the ``i``-th
    part of one ``unbind`` of each leaf."""
    if not train:
        return lambda i: tree_map(lambda t: t[i], blocks)
    parts = tree_map(lambda t: t.unbind(0), blocks)
    return lambda i: tree_map(lambda p: p[i], parts)


def remat(train: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where ``train`` and
    :data:`REMAT` (nothing of ``fn`` kept for the backward)."""
    if train and REMAT:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


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
    ``a_in = attn_norm(h)`` is given; returns ``(h, next_norm(h))``. The
    attention is MLA where the block has its weights (deepseek-v2)."""
    if "w_dq" in bp["attn"]:
        y = mla_attention(bp["attn"], a_in, positions, cfg)
    else:
        y = gqa_attention(bp["attn"], a_in, positions, cfg, causal=causal)
    m_in, h = add_norm(y, h, bp["mlp_norm"], cfg.norm)
    return _mlp_seam(bp, h, m_in, cfg, next_norm)


def _cross_block(bp, h, a_in, memory, cfg: ModelConfig, next_norm):
    """One cross-attention + MLP layer over ``memory`` (B, Sm, D); returns
    ``(h, next_norm(h))``."""
    y = cross_attention(bp["attn"], a_in, memory, cfg)
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


class Block(NamedTuple):
    """A block of the decoder: its stack of parameters, its stack of the
    cache (``"cross"`` for a cross-attention block), its index in both, and
    whether it is the last block."""
    params_key: str
    cache_key: str
    index: int
    last: bool


def block_plan(cfg: ModelConfig) -> List[Block]:
    """The decoder's blocks in order: the stacks of :func:`block_stacks`
    one after the other; for vlm a gated cross block after every
    ``cross_attn_every - 1`` self blocks; for audio a self block then a
    cross block per layer."""
    if cfg.family == "vlm":
        per = cfg.cross_attn_every - 1
        entries = [e for g in range(cfg.n_layers // cfg.cross_attn_every)
                   for e in [("blocks", "layers", g * per + j) for j in range(per)]
                   + [("cross_blocks", "cross", g)]]
    elif cfg.family == "audio":
        entries = [e for i in range(cfg.n_layers)
                   for e in (("blocks", "layers", i), ("cross_blocks", "cross", i))]
    else:
        entries = [(key, ckey, i) for key, ckey, n in block_stacks(cfg) for i in range(n)]
    return [Block(*e, last=n + 1 == len(entries)) for n, e in enumerate(entries)]


def run_blocks(params: PyTree, cfg: ModelConfig, h: torch.Tensor, layer_fn):
    """Drive ``layer_fn(block, bp, h, a_in, next_norm) -> (h, a_in)`` over
    the blocks of :func:`block_plan`; returns the stream and its
    final-normed version."""
    plan = block_plan(cfg)
    train = training(params)
    views = {key: stack_views(params[key], train) for key in dict.fromkeys(b.params_key for b in plan)}
    blocks = [views[b.params_key](b.index) for b in plan]
    a_in = apply_norm(h, blocks[0]["attn_norm"], cfg.norm)
    for i, (b, bp) in enumerate(zip(plan, blocks)):
        nxt = blocks[i + 1]["attn_norm"] if i + 1 < len(blocks) else params["final_norm"]
        h, a_in = remat(train, layer_fn, b, bp, h, a_in, nxt)
    return h, a_in


def run_hybrid(params: PyTree, cfg: ModelConfig, h: torch.Tensor, mamba_fn, shared_fn):
    """Drive the hybrid stack: Mamba layer ``i`` adds ``mamba_fn(i, mixer,
    norm_i(h))`` to the stream; after every ``shared_attn_every``-th the
    shared block runs as ``shared_fn(g, shared, h, a_in, next_norm) -> (h,
    normed)``, ``g`` its application and ``a_in`` its attention norm of h.
    Returns the stream and its final-normed version."""
    every = cfg.shared_attn_every
    shared = params["shared_attn"] if every else None
    train = training(params)
    view = stack_views(params["mamba_blocks"], train)
    blocks = [view(i) for i in range(cfg.n_layers)]
    norms = [bp["norm"] for bp in blocks[1:]] + [params["final_norm"]]
    normed = apply_norm(h, blocks[0]["norm"], cfg.norm)

    def layer(i, bp, h, normed, nxt):
        y = mamba_fn(i, bp["mixer"], normed)
        if every and i % every == every - 1:
            a_in, h = add_norm(y, h, shared["attn_norm"], cfg.norm)
            return shared_fn(i // every, shared, h, a_in, nxt)
        normed, h = add_norm(y, h, nxt, cfg.norm)
        return h, normed

    for i, bp in enumerate(blocks):
        h, normed = remat(train, layer, i, bp, h, normed, norms[i])
    return h, normed


def ssm_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(mLSTM blocks, sLSTM blocks) of an ssm model: every
    ``slstm_every``-th block is an sLSTM block (none for 0)."""
    every = cfg.xlstm.slstm_every
    n_s = cfg.n_layers // every if every else 0
    if every and cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups of "
                         f"{every} ending in an sLSTM block")
    return cfg.n_layers - n_s, n_s


def ssm_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """The ssm stack's blocks in order, as (kind, index in its stack), the
    kind ``"mlstm"`` or ``"slstm"`` naming the parameter stack
    ``{kind}_blocks`` and the cache stack ``{kind}``: ``slstm_every - 1``
    mLSTM blocks then one sLSTM block, repeated (all mLSTM for
    ``slstm_every`` 0)."""
    n_m, n_s = ssm_counts(cfg)
    if not n_s:
        return [("mlstm", i) for i in range(n_m)]
    per = cfg.xlstm.slstm_every - 1
    return [e for g in range(n_s)
            for e in [("mlstm", g * per + j) for j in range(per)] + [("slstm", g)]]


def run_ssm(params: PyTree, cfg: ModelConfig, h: torch.Tensor, block_fn):
    """Drive the ssm stack: block ``(kind, i)`` of :func:`ssm_plan` adds
    ``block_fn(kind, i, cell, norm(h))`` to the stream. Returns the stream
    and its final-normed version."""
    plan = ssm_plan(cfg)
    train = training(params)
    views = {kind: stack_views(params[f"{kind}_blocks"], train) for kind in dict.fromkeys(k for k, _ in plan)}
    blocks = [views[kind](i) for kind, i in plan]
    norms = [bp["norm"] for bp in blocks[1:]] + [params["final_norm"]]
    normed = apply_norm(h, blocks[0]["norm"], cfg.norm)

    def layer(kind, i, cell, h, normed, nxt):
        y = block_fn(kind, i, cell, normed)
        normed, h = add_norm(y, h, nxt, cfg.norm)
        return h, normed

    for (kind, i), bp, nxt in zip(plan, blocks, norms):
        h, normed = remat(train, layer, kind, i, bp["cell"], h, normed, nxt)
    return h, normed


# ======================================================================== forward

def encode(params: PyTree, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Audio/enc-dec encoder over stub frame embeddings (B, Sm, D) → memory
    states: its input norm, non-causal attn + MLP blocks (K5 without a
    mask), its final norm."""
    mem = apply_norm(frames.to(_dt(cfg)), params["enc_embed_norm"], cfg.norm)
    positions = torch.arange(mem.shape[1], device=mem.device)[None, :]
    train = training(params)
    view = stack_views(params["encoder"], train)
    blocks = [view(i) for i in range(cfg.n_encoder_layers)]
    a_in = apply_norm(mem, blocks[0]["attn_norm"], cfg.norm)

    def layer(bp, mem, a_in, nxt):
        return _dense_block(bp, mem, a_in, positions, cfg, nxt, causal=False)

    for i, bp in enumerate(blocks):
        nxt = blocks[i + 1]["attn_norm"] if i + 1 < len(blocks) else params["enc_final_norm"]
        mem, a_in = remat(train, layer, bp, mem, a_in, nxt)
    return a_in


def memory_states(params: PyTree, cfg: ModelConfig, memory: Optional[torch.Tensor]):
    """What the cross blocks attend to: the image tokens (vlm) in the
    activation type, the encoder's states over the frames (audio); None for
    the families without cross-attention."""
    if cfg.family not in ("vlm", "audio"):
        return None
    if memory is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs memory (B, Sm, D)")
    return memory.to(_dt(cfg)) if cfg.family == "vlm" else encode(params, cfg, memory)


def forward(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
    memory: Optional[torch.Tensor] = None,  # vlm vision / audio frames (B, Sm, D)
) -> torch.Tensor:
    """Teacher-forcing forward → logits (B, S, V)."""
    S = tokens.shape[1]
    h = params["embed"][tokens].to(_dt(cfg))
    positions = torch.arange(S, device=h.device)[None, :]
    if cfg.family == "hybrid":
        _, normed = run_hybrid(
            params, cfg, h,
            lambda i, mp, x: mamba_block(mp, x, cfg),
            lambda g, sp, h, a_in, nxt: _dense_block(sp, h, a_in, positions, cfg, nxt),
        )
    elif cfg.family == "ssm":
        block = {"mlstm": mlstm_block, "slstm": slstm_block}
        _, normed = run_ssm(params, cfg, h, lambda kind, i, cell, x: block[kind](cell, x, cfg))
    else:
        mem = memory_states(params, cfg, memory)

        def layer(b, bp, h, a_in, nxt):
            if b.cache_key == "cross":
                return _cross_block(bp, h, a_in, mem, cfg, nxt)
            return _dense_block(bp, h, a_in, positions, cfg, nxt)

        _, normed = run_blocks(params, cfg, h, layer)
    return normed @ lm_head(params, cfg)
