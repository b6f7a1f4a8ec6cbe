"""Feed-forward blocks: SwiGLU / squared-ReLU / GeLU MLPs and Mixture of
Experts with scatter-based dispatch (port of ``repro/models/mlp.py``).

MoE dispatch scatters tokens into a static (E·C, D) buffer by their
(expert, position-in-expert) slot and gathers them back — O(T·k·D) data
movement, no (T·k, E) one-hot, static shapes — as the reference does. The
projections, the experts' batched products included, are plain matrix
products (cuBLAS on the card), which the reference leaves to XLA outside
any Pallas kernel; the router's softmax/top-k and the scatter and gather
are torch ops. The reference's expert-parallel ``moe_layer_ep`` (a
``shard_map`` over a mesh, ``MOE_IMPL = "ep"``) waits for the port's
``models/sharding.py``: the port has no mesh, and ``moe_layer`` always
takes the single-device path.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .common import dense_init


def act_fn(name: str):
    if name == "swiglu":
        return None  # handled structurally (gate * up)
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    raise ValueError(name)


def mlp_params(
    gen: torch.Generator, d_model: int, d_ff: int, activation: str, dtype: torch.dtype, layers: int
) -> Dict[str, Any]:
    """MLP weights of ``layers`` layers, stacked on a leading axis."""
    p = {
        "w_up": dense_init(gen, (layers, d_model, d_ff), dtype, fan_in=d_model),
        "w_down": dense_init(gen, (layers, d_ff, d_model), dtype, fan_in=d_ff),
    }
    if activation == "swiglu":
        p["w_gate"] = dense_init(gen, (layers, d_model, d_ff), dtype, fan_in=d_model)
    return p


def mlp(p: Dict[str, Any], x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act_fn(activation)(x @ p["w_up"])
    return h @ p["w_down"]


# -- Mixture of Experts -----------------------------------------------------------

def _stacked(gen: torch.Generator, shape, dtype: torch.dtype, fan_in: int, layers: int):
    """``layers`` draws of ``shape`` stacked on a leading axis, drawn one
    layer at a time (a full-width expert stack in float32 is gigabytes)."""
    out = torch.empty((layers, *shape), dtype=dtype, device=gen.device)
    for i in range(layers):
        out[i] = dense_init(gen, shape, dtype, fan_in=fan_in)
    return out


def moe_params(gen: torch.Generator, cfg, dtype: torch.dtype, layers: int) -> Dict[str, Any]:
    """Router, routed experts and shared experts of ``layers`` MoE layers,
    stacked on a leading axis, in the reference's layout: ``router (L, D,
    E)``, ``w_up``/``w_gate (L, E, D, F)``, ``w_down (L, E, F, D)``."""
    m = cfg.moe
    D, F, E = cfg.d_model, m.expert_ff, m.num_experts
    p: Dict[str, Any] = {
        "router": dense_init(gen, (layers, D, E), dtype, fan_in=D),
        "w_up": _stacked(gen, (E, D, F), dtype, D, layers),
        "w_down": _stacked(gen, (E, F, D), dtype, F, layers),
    }
    if cfg.activation == "swiglu":
        p["w_gate"] = _stacked(gen, (E, D, F), dtype, D, layers)
    if m.num_shared:
        p["shared"] = mlp_params(gen, D, F * m.num_shared, cfg.activation, dtype, layers)
    return p


def _positions_within_group(flat_e: torch.Tensor, n_groups: int) -> torch.Tensor:
    """pos[i] = #{j < i : flat_e[j] == flat_e[i]} — the capacity slot rank.

    Sort-based, as the reference's: a stable sort keeps earlier tokens
    first within an expert, so they win its capacity.
    """
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_groups)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=flat_e.device) - starts[flat_e[order]]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def _route(p: Dict[str, Any], xt: torch.Tensor, k: int):
    """The router in float32: (probs (T, E), gates (T, k) renormalized over
    the top k, expert ids (T, k))."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, idx


def _expert_ffn(p: Dict[str, Any], xe: torch.Tensor, activation: str) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D), batched over experts."""
    if activation == "swiglu":
        h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    else:
        h = act_fn(activation)(torch.bmm(xe, p["w_up"]))
    return torch.bmm(h, p["w_down"])


# the reference's switch for decode batches of T·K ≤ E tokens: "dense" runs
# the capacity path; "sparse" gathers only the chosen experts' weights
MOE_DECODE = "dense"


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens, as the reference sizes them."""
    m = cfg.moe
    return max(int(tokens * m.top_k / m.num_experts * m.capacity_factor), 4)


def dispatch(cfg, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The buffer row of each (token, choice) — ``expert·C + position``, or
    the trash row ``E·C`` where the expert is full — and which were kept."""
    m = cfg.moe
    E, C = m.num_experts, capacity(cfg, idx.shape[0])
    flat_e = idx.reshape(-1)
    pos = _positions_within_group(flat_e, E)
    keep = pos < C
    return torch.where(keep, flat_e * C + pos, E * C), keep


def moe_layer(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Scatter-based top-k dispatch with capacity
    ``C = max(int(T·K/E·capacity_factor), 4)``; a (token, choice) past its
    expert's capacity goes to the trash row and adds nothing."""
    m = cfg.moe
    B, S, D = x.shape
    if MOE_DECODE == "sparse" and B * S * m.top_k <= m.num_experts:
        return _moe_decode_sparse(p, x.reshape(B * S, D), cfg).reshape(B, S, D)
    E, K = m.num_experts, m.top_k
    T = B * S
    C = capacity(cfg, T)

    xt = x.reshape(T, D)
    _, gate_vals, idx = _route(p, xt, K)
    slot, _ = dispatch(cfg, idx)
    token_id = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=x.device)
    buf[slot] = xt[token_id]
    expert_out = _expert_ffn(p, buf[: E * C].reshape(E, C, D), cfg.activation)
    flat_out = torch.cat(
        [expert_out.reshape(E * C, D), torch.zeros((1, D), dtype=expert_out.dtype,
                                                    device=x.device)], dim=0)
    y_tk = flat_out[slot] * gate_vals.reshape(-1)[:, None].to(expert_out.dtype)
    y = y_tk.reshape(T, K, D).sum(dim=1)
    if m.num_shared:
        y = y + mlp(p["shared"], xt, cfg.activation)
    return y.reshape(B, S, D)


def moe_aux_loss(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E·Σ f_e·p_e."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    f = F.one_hot(top1, m.num_experts).float().mean(dim=0)
    return m.num_experts * torch.sum(f * probs.mean(dim=0))


def _moe_decode_sparse(p: Dict[str, Any], xt: torch.Tensor, cfg) -> torch.Tensor:
    """Only the top-k experts' weights, gathered per token (the reference's
    sparse decode, for T·K ≤ E)."""
    m = cfg.moe
    _, gate_vals, idx = _route(p, xt, m.top_k)
    x = xt[:, None, :]  # (T, 1, D)
    y = 0
    for i in range(m.top_k):
        e = idx[:, i]
        if "w_gate" in p:
            h = F.silu(torch.bmm(x, p["w_gate"][e])) * torch.bmm(x, p["w_up"][e])
        else:
            h = act_fn(cfg.activation)(torch.bmm(x, p["w_up"][e]))
        y = y + gate_vals[:, i, None].to(xt.dtype) * torch.bmm(h, p["w_down"][e])[:, 0]
    if m.num_shared:
        y = y + mlp(p["shared"], xt, cfg.activation)
    return y
