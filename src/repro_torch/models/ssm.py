"""Mamba2, the chunked SSD (state-space dual) form (port of
``repro/models/ssm.py``).

Selective-state dynamics per head h with state N, head dim P:
  α_t = exp(a_h · Δ_t)          (decay; a_h = −exp(A_log_h) < 0)
  H_t = α_t · H_{t−1} + Δ_t · B_t ⊗ x_t     (H: N×P)
  y_t = C_t · H_t + D_h · x_t

:func:`ssd_chunked` runs the scan through :func:`repro_torch.kernels.ops.
ssd_scan` at the reference's ``kernel_ssd_scan`` region: K7 on the card,
the plain version on the CPU. Unlike the reference, which shrinks the chunk
to a divisor of S for a serving prompt, the port keeps the configured chunk
and masks the ragged last one (the same y and state up to rounding).
Single-token decode is an O(1) state update in plain torch, as the
reference computes it outside any kernel; it writes the layer's cache in
place. The projections and the conv are plain torch, as the reference
leaves them to XLA. ``F.softplus`` returns x itself above its threshold of
20, where ``jax.nn.softplus`` adds log1p(exp(−x)) < 2.1e-9: under one
float32 ulp of x.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import dense_init, rms_norm


def mamba_params(gen: torch.Generator, cfg, dtype: torch.dtype, layers: int) -> Dict[str, Any]:
    """Mamba2 mixer weights of ``layers`` layers, stacked on a leading axis."""
    s = cfg.ssm
    D = cfg.d_model
    di, nh, N = s.d_inner(D), s.n_heads(D), s.d_state
    dev = gen.device
    L = layers
    return {
        # in_proj → [z (di), x (di), B (N), C (N), dt (nh)]
        "w_in": dense_init(gen, (L, D, 2 * di + 2 * N + nh), dtype, fan_in=D),
        "conv_w": dense_init(gen, (L, s.d_conv, di + 2 * N), dtype, fan_in=s.d_conv),
        "conv_b": torch.zeros((L, di + 2 * N), dtype=dtype, device=dev),
        "a_log": torch.zeros((L, nh), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((L, nh), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((L, nh), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((L, di), dtype=dtype, device=dev),
        "w_out": dense_init(gen, (L, di, D), dtype, fan_in=di),
    }


def _split_in(proj: torch.Tensor, di: int, N: int, nh: int):
    z = proj[..., :di]
    xbc = proj[..., di : di + di + 2 * N]
    dt = proj[..., di + di + 2 * N :]
    return z, xbc, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-channel causal conv along S. x: (B, S, C), w: (K, C); the
    reference's K shifted multiply-adds, in its order."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i : i + x.shape[1], :] * w[i]
    return out + b


def conv_tail(tail: torch.Tensor, x: torch.Tensor) -> None:
    """The last ``K - 1`` rows of a causal conv's input ``x`` (B, S, C) into
    its decode cache ``tail`` (B, K - 1, C), in place, left-padded with
    zeros for a shorter prompt as the conv pads them (the reference keeps
    only the prompt's rows, from which its decode cannot go on)."""
    k = tail.shape[1]
    rows = x[:, -k:]
    tail[:, : k - rows.shape[1]] = 0
    tail[:, k - rows.shape[1] :] = rows


def ssd_chunked(
    xh: torch.Tensor,  # (B, S, nh, P) inputs per head
    dt: torch.Tensor,  # (B, S, nh) softplus'd step sizes, float32
    a: torch.Tensor,  # (nh,) negative decay rates
    B_ssm: torch.Tensor,  # (B, S, N)
    C_ssm: torch.Tensor,  # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, nh, N, P) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan; returns (y (B, S, nh, P), final state (B, nh, N, P)),
    both float32 (K7 on the card)."""
    return ops.ssd_scan(xh, dt, a, B_ssm, C_ssm, chunk=chunk, h0=h0)


def _mamba_seq(p: Dict[str, Any], x: torch.Tensor, cfg):
    """The mixer over a whole sequence: (out (B, S, D), the conv's input
    xbc (B, S, di + 2N), the final state (B, nh, N, P))."""
    s = cfg.ssm
    D = cfg.d_model
    di, nh, N = s.d_inner(D), s.n_heads(D), s.d_state
    z, xbc_in, dt = _split_in(x @ p["w_in"], di, N, nh)
    xbc = F.silu(_causal_conv(xbc_in, p["conv_w"], p["conv_b"]))
    xin, B_ssm, C_ssm = xbc[..., :di], xbc[..., di : di + N], xbc[..., di + N :]
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xin.reshape(*xin.shape[:2], nh, s.head_dim)
    y, h_final = ssd_chunked(xh, dt, a, B_ssm, C_ssm, chunk=s.chunk)
    y = y + xh.float() * p["d_skip"][:, None]
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"])
    return y @ p["w_out"], xbc_in, h_final


def mamba_block(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """Full Mamba2 mixer: (B, S, D) -> (B, S, D)."""
    return _mamba_seq(p, x, cfg)[0]


# -- decode (single token) ----------------------------------------------------------

def mamba_init_cache(cfg, batch: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    D = cfg.d_model
    di, nh, N = s.d_inner(D), s.n_heads(D), s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, di + 2 * N), dtype=dtype, device=device),
        "h": torch.zeros((batch, nh, N, s.head_dim), dtype=torch.float32, device=device),
    }


def mamba_decode(
    p: Dict[str, Any], x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D) one token; O(1) state update, written to ``cache`` IN
    PLACE (the returned dict holds the same tensors)."""
    s = cfg.ssm
    D = cfg.d_model
    di, nh, N = s.d_inner(D), s.n_heads(D), s.d_state
    z, xbc, dt = _split_in(x @ p["w_in"], di, N, nh)
    # conv over [cached K−1 inputs, current]
    win = torch.cat([cache["conv"], xbc], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :]
    xin, B_ssm, C_ssm = xbc1[..., :di], xbc1[..., di : di + N], xbc1[..., di + N :]
    dt1 = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # (B, nh)
    a = -torch.exp(p["a_log"])
    alpha = torch.exp(dt1 * a)  # (B, nh)
    xh = xin[:, 0].reshape(-1, nh, s.head_dim).float()  # (B, nh, P)
    h = cache["h"] * alpha[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt1, B_ssm[:, 0].float(), xh
    )
    y = torch.einsum("bn,bhnp->bhp", C_ssm[:, 0].float(), h)
    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(-1, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"])
    out = y @ p["w_out"]
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    return out, cache
