"""Carry state across from the JAX reference package.

This system has no model weights: its state is the per-task state pytree
of each segment (counters, bitsets, ring buffers, filter estimates). The
reference keeps those as JAX arrays; handed over as numpy arrays (for
example ``jax.tree.map(np.asarray, seg.states)``), :func:`states_from_jax`
turns them into the port's form, so both packages can continue from the
same mid-run state. :func:`states_to_numpy` goes the other way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def states_from_jax(states: Any, device: torch.device | str = "cpu") -> Any:
    """Numpy leaves → torch tensors on ``device``, same dtypes, same nesting.

    Dicts, tuples and lists keep their structure (a stateless task's ``()``
    stays ``()``); every other leaf becomes a tensor.
    """
    if isinstance(states, dict):
        return {k: states_from_jax(v, device) for k, v in states.items()}
    if isinstance(states, (tuple, list)):
        return type(states)(states_from_jax(v, device) for v in states)
    arr = np.array(states)  # a private, writable copy
    return torch.from_numpy(arr).to(device)


def states_to_numpy(states: Any) -> Any:
    """Torch tensors (on any device) → numpy arrays, same nesting."""
    if isinstance(states, dict):
        return {k: states_to_numpy(v) for k, v in states.items()}
    if isinstance(states, (tuple, list)):
        return type(states)(states_to_numpy(v) for v in states)
    return states.detach().cpu().numpy()
