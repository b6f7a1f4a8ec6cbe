"""Train state + step factory (port of ``repro/train/step.py``).

The step is a function ``(state, batch) → (state, metrics)``. The
reference's is pure and jitted with the state donated; the port's runs
eagerly and updates the state's tensors in place (``optim.adamw_update``),
which is what donation buys there. On the card the forward and backward go
through the kernels' autograd (K1, K4, K5, K7 and the ssm family's scans,
each with its backward kernel), with every block recomputed in the backward
(``models/transformer.py``: REMAT).

Gradient accumulation: ``accum > 1`` loops over microbatches in Python,
accumulating grads in ``accum_dtype`` (f32 by default), as the reference's
``lax.scan`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import forward
from repro_torch.models.config import ModelConfig

from .loss import cross_entropy_loss
from .optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule, tree_leaves

PyTree = Any
TrainState = Dict[str, Any]  # {"step", "params", "mu", "nu"}


def train_state_init(cfg: ModelConfig, opt: AdamWConfig, generator: torch.Generator) -> TrainState:
    """Parameters drawn from ``generator`` on its device, zero moments, step 0."""
    from repro_torch.models import init_params

    params = init_params(cfg, generator)
    mu, nu = adamw_init(params, opt)
    step = torch.zeros((), dtype=torch.int32, device=generator.device)
    return {"step": step, "params": params, "mu": mu, "nu": nu}


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device, so ``init_params``
    draws nothing: the initializers allocate on ``generator.device``."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_train_state(cfg: ModelConfig, opt: AdamWConfig) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device: no allocation
    (the counterpart of the reference's ``jax.eval_shape``)."""
    from repro_torch.models import init_params

    params = init_params(cfg, _MetaGenerator())
    mu, nu = adamw_init(params, opt)
    return {"step": torch.zeros((), dtype=torch.int32, device="meta"), "params": params,
            "mu": mu, "nu": nu}


def loss_and_grads(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor,
                   memory: Optional[torch.Tensor] = None, *, z_loss_coeff: float = 1e-4):
    """(loss, grads): the reference's ``jax.value_and_grad`` of its
    ``loss_fn``, the grads in the parameters' dtypes and in the order of
    ``tree_leaves(params)``. The parameters take ``requires_grad`` for the
    call only."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            logits = forward(params, cfg, tokens, memory=memory)
            loss, _ = cross_entropy_loss(logits, labels, z_loss_coeff=z_loss_coeff)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def unflatten(params: PyTree, flat) -> PyTree:
    """``flat`` (in the order of ``tree_leaves(params)``) in params' structure."""
    it = iter(flat)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)

    return rebuild(params)


def make_train_step(
    cfg: ModelConfig,
    opt: AdamWConfig,
    *,
    accum: int = 1,
    z_loss_coeff: float = 1e-4,
    accum_dtype: str = "float32",
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    def grad_fn(params, tokens, labels, memory):
        return loss_and_grads(params, cfg, tokens, labels, memory, z_loss_coeff=z_loss_coeff)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        tokens, labels = batch["tokens"], batch["labels"]
        memory = batch.get("memory")
        params = state["params"]

        if accum <= 1:
            loss, grads = grad_fn(params, tokens, labels, memory)
        else:
            B = tokens.shape[0]
            assert B % accum == 0, (B, accum)
            mb = B // accum
            gacc = [torch.zeros(p.shape, dtype=getattr(torch, accum_dtype), device=p.device)
                    for p in tree_leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(accum):
                part = slice(i * mb, (i + 1) * mb)
                m = memory[part] if memory is not None else None
                loss_i, g = grad_fn(params, tokens[part], labels[part], m)
                for a, gi in zip(gacc, g):
                    a.add_(gi.to(a.dtype))
                lsum = lsum + loss_i
            grads = [(g / accum).to(torch.float32) for g in gacc]
            loss = lsum / accum

        step = state["step"]
        lr = cosine_schedule(opt)(step)
        new_p, new_mu, new_nu, gnorm = adamw_update(
            unflatten(params, grads), params, state["mu"], state["nu"], step, opt
        )
        new_state = {"step": step + 1, "params": new_p, "mu": new_mu, "nu": new_nu}
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics

    return train_step
