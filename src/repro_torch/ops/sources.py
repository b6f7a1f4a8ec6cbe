"""Source operators — deterministic synthetic sensor streams.

A source's state is a step counter and its output is a pure function of
(source type, counter), so a source task shared between merged dataflows
emits exactly the stream each tenant would have seen standalone. The noise
comes from :mod:`repro_torch.random`, which draws the threefry bits
``jax.random`` draws, so the port's streams equal the reference's.
"""
from __future__ import annotations

import hashlib
import math

import torch

from .. import random as rng
from .base import EVENT_WIDTH, Operator
from .costs import SOURCE_COST

# Distinct signal profiles per source family: (bias, amplitude, period, noise)
_PROFILES = {
    "urban": (20.0, 5.0, 60.0, 0.8),    # temperature-ish urban sensing
    "meter": (1.2, 0.6, 1440.0, 0.1),   # smart-meter kW draw
    "grid": (50.0, 0.05, 3600.0, 0.02), # grid frequency
    "taxi": (8.0, 6.0, 720.0, 2.0),     # taxi trip metric
}
_DEFAULT_PROFILE = (0.0, 1.0, 100.0, 0.5)


def _seed_for(type_name: str) -> int:
    return int.from_bytes(hashlib.sha256(type_name.encode()).digest()[:4], "little")


def make_source(type_name: str, batch: int = 32, device: torch.device | str = "cpu") -> Operator:
    """Deterministic stream: sinusoid + seeded per-step noise + event ids."""
    bias, amp, period, noise = _PROFILES.get(type_name.split(":")[0], _DEFAULT_PROFILE)
    device = torch.device(device)
    root = rng.prng_key(_seed_for(type_name), device=device)
    # float32 constants rounded once, as jax rounds its weakly typed scalars
    frac = torch.arange(batch, dtype=torch.float32, device=device) / batch
    ramp = torch.arange(batch, dtype=torch.int32, device=device)
    two_pi = 2.0 * math.pi

    def init_state(batch_: int):
        return torch.zeros((), dtype=torch.int32, device=device)

    def apply(state, x=None):
        step = state
        key = rng.fold_in(root, step)
        t = step.to(torch.float32) + frac
        base = bias + amp * torch.sin(two_pi * t / period)
        vals = base[:, None] + noise * rng.normal(key, (batch, 5))
        out = torch.zeros((batch, EVENT_WIDTH), dtype=torch.float32, device=device)
        out[:, 0] = t
        out[:, 1:6] = vals
        out[:, 6] = 1.0  # valid
        out[:, 7] = (step * batch + ramp).to(torch.float32)
        return state + 1, out

    return Operator(
        type=type_name,
        init_state=init_state,
        apply=apply,
        cost_weight=SOURCE_COST,
        is_source=True,
    )
