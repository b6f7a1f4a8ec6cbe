"""LM-pipeline task operators for multi-tenant reuse-serving (the port of
``repro/serve/model_ops.py``).

A tenant's serving pipeline is a dataflow of typed stages:

  prompts:<stream> → lm_embed → lm_stage("0-7") → … → lm_head(<adapter>) → SINK

Stage weights are a *pure function of the config* (seeded by
``(model, layer range, d)``), so two tenants configured with the same
checkpoint id and layer range have **identical** operators — the paper's
⟨type, config⟩ equality — and the merge algorithm's reuse of a stage is
output-preserving. The seeds are the reference's (sha256 of the config
parts) and the draws go through :mod:`repro_torch.random`, which emulates
``jax.random.normal``, so the port's weights are the reference's.

Event contract: upstream sources emit (B, EVENT_WIDTH) request feature
batches; ``lm_embed`` lifts them to (B, d); stages are (B, d) → (B, d);
``lm_head`` folds back to (B, EVENT_WIDTH) response digests so the stock
digest sinks apply.

The norm ``x·rsqrt(mean(x²)+1e-6)`` goes through
:func:`repro_torch.kernels.ops.rmsnorm` with a unit gain: K1 on the card,
its plain version on the CPU. Where a residual add feeds the next norm
(``h + silu(rms(h)@w1)@w2`` into the next block's norm, and the head's
``x + silu(rms(x)@wa)`` into its output norm) the two are one K4
``rmsnorm_residual`` pass, which sums in float32 as the unfused add does.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.kernels import ops as kernel_ops
from repro_torch.ops.base import EVENT_WIDTH, Operator, register
from repro_torch.ops.costs import LM_EMBED_COST, LM_HEAD_COST, LM_STAGE_COST_PER_BLOCK

EPS = 1e-6


def _seed(*parts: Any) -> int:
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:4], "little")


def _proj(seed: int, shape, device: torch.device | str = "cpu") -> torch.Tensor:
    return trandom.normal(trandom.prng_key(seed, device), shape) * (shape[0] ** -0.5)


def _unit(d: int, device: torch.device) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


@register("lm_embed")
def lm_embed(cfg: Dict[str, Any], device: torch.device) -> Operator:
    d = int(cfg.get("d", 64))
    w = _proj(_seed("embed", cfg.get("model", ""), d), (EVENT_WIDTH, d), device)
    unit = _unit(d, device)

    def init_state(batch: int):
        return ()

    def apply(state, x):
        return state, kernel_ops.rmsnorm(torch.tanh(x @ w), unit, EPS)

    return Operator("lm_embed", init_state, apply, cost_weight=LM_EMBED_COST)


@register("lm_stage")
def lm_stage(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """A contiguous group of transformer-ish blocks of the backbone."""
    d = int(cfg.get("d", 64))
    model = cfg.get("model", "")
    lo, hi = (int(v) for v in str(cfg.get("layers", "0-0")).split("-"))
    blocks = []
    for i in range(lo, hi + 1):
        s = _seed("stage", model, i, d)
        blocks.append((_proj(s, (d, 2 * d), device), _proj(s + 1, (2 * d, d), device)))
    unit = _unit(d, device)

    def init_state(batch: int):
        return ()

    def apply(state, x):
        h = x
        normed = kernel_ops.rmsnorm(h, unit, EPS)
        for i, (w1, w2) in enumerate(blocks):
            y = F.silu(normed @ w1) @ w2
            if i + 1 < len(blocks):
                normed, h = kernel_ops.rmsnorm_residual(y, h, unit, EPS)
            else:
                h = h + y
        return state, h

    return Operator(
        "lm_stage", init_state, apply, cost_weight=LM_STAGE_COST_PER_BLOCK * len(blocks)
    )


@register("lm_head")
def lm_head(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Tenant adapter + response digest (B, d) → (B, EVENT_WIDTH)."""
    d = int(cfg.get("d", 64))
    s = _seed("head", cfg.get("model", ""), cfg.get("adapter", ""), d)
    wa = _proj(s, (d, d), device)
    wo = _proj(s + 1, (d, EVENT_WIDTH), device)
    unit = _unit(d, device)

    def init_state(batch: int):
        return ()

    def apply(state, x):
        y = F.silu(kernel_ops.rmsnorm(x, unit, EPS) @ wa)
        normed, _ = kernel_ops.rmsnorm_residual(y, x, unit, EPS)
        return state, normed @ wo

    return Operator("lm_head", init_state, apply, cost_weight=LM_HEAD_COST)
