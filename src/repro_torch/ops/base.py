"""Operator protocol + task-type registry over torch tensors.

The port's counterpart of ``repro.ops.base``. Every stream carries an
event-batch tensor of shape ``(B, EVENT_WIDTH)`` per step, and a task is a
plain function over one batch with explicit state (a pytree of tensors:
dicts, tuples and tensors) — the analogue of a Storm Bolt's instance
fields.

Semantics (paper §3.1):
  * *interleave* — a task with multiple input streams is applied once per
    incoming batch, in deterministic (sorted-parent) order;
  * *duplicate* — each consumer of a task's output receives the same
    tensor, so operators never write into their input: they return new
    tensors.

Operators are built for one ``device``: their constant tensors (weights,
initial states) live there, and their ``apply`` runs there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .costs import parse_config

# Payload width of an event batch: every event is a fixed-width float vector
# (sensor observations: timestamp, value channels, quality flags ...).
EVENT_WIDTH = 8

PyTree = Any
ApplyFn = Callable[[PyTree, torch.Tensor], Tuple[PyTree, Optional[torch.Tensor]]]


@dataclass
class Operator:
    """A task implementation over torch tensors.

    ``init_state(batch)`` returns the task's state pytree (fixed shapes);
    ``apply(state, x)`` consumes one event batch and returns
    ``(new_state, output batch | None)``. Sources take ``x=None``; sinks
    return ``None`` output. ``apply`` never mutates ``state`` or ``x``.
    """

    type: str
    init_state: Callable[[int], PyTree]
    apply: ApplyFn
    cost_weight: float = 1.0
    is_source: bool = False
    is_sink: bool = False


OperatorFactory = Callable[[Dict[str, Any], torch.device], Operator]

_REGISTRY: Dict[str, OperatorFactory] = {}
_FALLBACK: Optional[OperatorFactory] = None


def register(type_name: str) -> Callable[[OperatorFactory], OperatorFactory]:
    def deco(factory: OperatorFactory) -> OperatorFactory:
        if type_name in _REGISTRY:
            raise ValueError(f"operator type {type_name!r} already registered")
        _REGISTRY[type_name] = factory
        return factory

    return deco


def register_fallback(factory: OperatorFactory) -> OperatorFactory:
    """Factory used for unknown task types (the OPMW workload replaces all
    task logic with an iterative π computation — paper §5.1)."""
    global _FALLBACK
    _FALLBACK = factory
    return factory


def make_operator(type_name: str, config: Any, device: torch.device | str) -> Operator:
    """Instantiate the operator for a concrete task ⟨type, config⟩ on ``device``."""
    cfg = parse_config(config)
    device = torch.device(device)
    factory = _REGISTRY.get(type_name)
    if factory is None:
        if _FALLBACK is None:
            raise KeyError(f"no operator registered for task type {type_name!r}")
        return _FALLBACK(dict(cfg, _type=type_name), device)
    return factory(cfg, device)


def registered_types() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def stateless(type_name: str, fn: Callable[[torch.Tensor], torch.Tensor], cost: float) -> Operator:
    """Operator with no state: y = fn(x)."""

    def init_state(batch: int) -> PyTree:
        return ()

    def apply(state: PyTree, x: torch.Tensor):
        return state, fn(x)

    return Operator(type=type_name, init_state=init_state, apply=apply, cost_weight=cost)
