"""Sink operators — accumulate an output digest.

A sink's state carries ``(count, checksum, last)``: the number of batches
consumed, a running float checksum of every payload, and the last batch.
The checksum is the observable output stream identity. Its sum is
``torch.sum``, whose reduction order differs from ``jnp.sum``: a checksum
agrees with the reference's within a tolerance, a count exactly.
"""
from __future__ import annotations

import torch

from .base import EVENT_WIDTH, Operator
from .costs import SINK_COST


def make_sink(type_name: str, device: torch.device | str = "cpu") -> Operator:
    device = torch.device(device)

    def init_state(batch: int):
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "checksum": torch.zeros((), dtype=torch.float32, device=device),
            "last": torch.zeros((batch, EVENT_WIDTH), dtype=torch.float32, device=device),
        }

    def apply(state, x):
        return (
            {
                "count": state["count"] + 1,
                # weighted fold so the checksum is order-sensitive
                "checksum": state["checksum"] * 0.5 + torch.sum(x, dtype=torch.float32),
                "last": x,
            },
            None,
        )

    return Operator(
        type=type_name, init_state=init_state, apply=apply, cost_weight=SINK_COST, is_sink=True
    )
