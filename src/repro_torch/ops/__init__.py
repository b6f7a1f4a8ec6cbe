"""Task-type registry: ⟨type, config⟩ → executable torch operator.

RIoT-style IoT task logic (:mod:`repro_torch.ops.riot`), deterministic
synthetic sources (:mod:`repro_torch.ops.sources`), digest sinks
(:mod:`repro_torch.ops.sinks`), and the OPMW π fallback.
"""
from __future__ import annotations

import torch

from . import riot  # noqa: F401 — populates the registry
from .base import (
    EVENT_WIDTH,
    Operator,
    make_operator,
    register,
    register_fallback,
    registered_types,
    stateless,
)
from .sinks import make_sink
from .sources import make_source

__all__ = [
    "EVENT_WIDTH",
    "Operator",
    "make_operator",
    "make_sink",
    "make_source",
    "operator_for_task",
    "register",
    "register_fallback",
    "registered_types",
    "stateless",
]


def operator_for_task(task, batch: int = 32, device: torch.device | str = "cpu") -> Operator:
    """Instantiate the operator for a concrete task (source/sink aware) on ``device``."""
    if task.is_source:
        return make_source(task.type, batch=batch, device=device)
    if task.is_sink:
        return make_sink(task.type, device=device)
    return make_operator(task.type, task.config, device)
