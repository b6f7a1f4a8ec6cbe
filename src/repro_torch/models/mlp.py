"""Dense feed-forward blocks: SwiGLU / squared-ReLU / GeLU MLPs (port of the
dense part of ``repro/models/mlp.py``; mixture-of-experts comes with the
moe family, ROADMAP). The projections are plain matrix products, which the
reference leaves to XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict

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
