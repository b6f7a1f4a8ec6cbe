"""Carry state across from the JAX reference package.

The stream path's state is the per-task state pytree of each segment
(counters, bitsets, ring buffers, filter estimates). The reference keeps
those as JAX arrays; handed over as numpy arrays (for example
``jax.tree.map(np.asarray, seg.states)``), :func:`states_from_jax` turns
them into the port's form, so both packages can continue from the same
mid-run state. :func:`states_to_numpy` goes the other way.

The serving path's state is the model's parameters and the KV cache. The
port keeps the reference's layouts (per-layer leading axis, ``wq (D, H,
hd)``, ``wo (H, hd, D)``, the cache as ``(L, B, S, KV, hd)``), so
:func:`params_from_jax` and :func:`cache_from_jax` move arrays and
re-lay nothing out (and :func:`train_state_from_jax` /
:func:`train_state_to_numpy` move a whole train state, moments and step
included). That holds for every family's tree: MLA's weights
(``w_dq``, ``w_uq``, ``w_dkv``, ``w_krope``, ``w_uk``, ``w_uv``) and its
latent cache (``c_kv (L, B, S, r)``, ``k_rope (L, B, S, rope_hd)``), the
cross blocks' ``k_input_norm`` and the gated blocks' ``gate`` (stacked as
``(L,)``, a 0-d scalar per layer), the ``cross`` cache stack ``(L, B,
memory_len, KV, hd)`` and the audio encoder's stacks.
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
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(params_np: Any, device: torch.device | str = "cpu") -> Any:
    """The reference's ``init_params`` tree (leaves as numpy) → the port's
    parameters: the same nested dicts, each array a tensor on ``device``."""
    return states_from_jax(params_np, device)


def cache_from_jax(cache_np: Any, device: torch.device | str = "cpu") -> Any:
    """A reference cache (leaves as numpy) → the port's: ``len`` becomes a
    Python int, every other array a tensor on ``device``."""
    out = {k: v for k, v in cache_np.items() if k != "len"}
    out = states_from_jax(out, device)
    out["len"] = int(np.asarray(cache_np["len"]))
    return out


def train_state_from_jax(state_np: Any, device: torch.device | str = "cpu") -> Any:
    """The reference's train state ``{step, params, mu, nu}`` (leaves as
    numpy) → the port's: the same tree of tensors on ``device``, the step
    a 0-d int32 tensor there too."""
    return states_from_jax(state_np, device)


def train_state_to_numpy(state: Any) -> Any:
    """The port's train state → numpy copies the reference takes (the port
    updates its state in place), bfloat16 as ``ml_dtypes.bfloat16``
    (imported only when a bfloat16 leaf is there: the package JAX ships
    with)."""
    if isinstance(state, dict):
        return {k: train_state_to_numpy(v) for k, v in state.items()}
    t = state.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def states_to_numpy(states: Any) -> Any:
    """Torch tensors (on any device) → numpy arrays, same nesting."""
    if isinstance(states, dict):
        return {k: states_to_numpy(v) for k, v in states.items()}
    if isinstance(states, (tuple, list)):
        return type(states)(states_to_numpy(v) for v in states)
    return states.detach().cpu().numpy()
