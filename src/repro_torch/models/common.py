"""Shared model primitives: norms, RoPE, initializers (port of
``repro/models/common.py``).

``rms_norm`` and ``add_norm`` go through :mod:`repro_torch.kernels.ops`,
so on the card they launch K1 ``rmsnorm`` and K4 ``rmsnorm_residual`` and
on the CPU they run the plain versions. LayerNorm (nemotron) is plain
torch, as in the reference. Initializers draw from an explicit
``torch.Generator`` on the device the parameters live on.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def add_norm(
    x: torch.Tensor, res: torch.Tensor, p: Dict[str, torch.Tensor], kind: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual seam ``h = res + x; apply_norm(h)``: returns (normed, h).

    For RMSNorm this is one K4 pass, which norms the float32 sum (the
    reference norms the sum rounded to the activation type; in bfloat16 the
    two differ by about one rounding of h, in float32 not at all).
    """
    if kind == "rmsnorm":
        return ops.rmsnorm_residual(x, res, p["scale"])
    h = res + x
    return layer_norm(h, p["scale"], p["bias"]), h


def norm_params(kind: str, shape, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Unit gains (and zero biases for LayerNorm) of ``shape``: ``D``, or
    ``(L, D)`` for a stack of layers."""
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


# -- RoPE ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers. Split-half convention, f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# -- initializers ----------------------------------------------------------------

def dense_init(
    gen: torch.Generator, shape, dtype: torch.dtype, fan_in: Optional[int] = None
) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan_in) (first dim by
    default, or the second for a stack of layers drawn in one call)."""
    fi = fan_in if fan_in is not None else shape[0]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * fi ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (t * 0.02).to(dtype)
