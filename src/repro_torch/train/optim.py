"""AdamW with configurable state dtypes and global-norm clip (port of
``repro/train/optim.py``).

The per-element arithmetic and its casts are the reference's. Two things
differ in how it is applied, neither in what it computes:
  * the update runs in place: the new parameters and moments are written
    into the old tensors, the counterpart of the reference's
    ``donate_argnums=0``;
  * it runs a slice at a time (:func:`slices`): along a stacked leaf's
    leading layer axis and in row blocks of ``embed``/``head``, at most
    :data:`SLICE_ELEMS` elements at once. Elementwise, so the result is
    bitwise the whole-leaf update's; the reference's whole-leaf form makes
    about seven f32 temporaries of a leaf, 25 GB for qwen3-4b's stacked
    MLP, which the card does not hold beside the state. A layer of more
    than :data:`SLICE_LAYER_ELEMS` elements (an MoE layer's experts:
    deepseek-v2's 160 of 5120 x 1536, 1.26 B) is cut the same way along
    its next axis. ``global_norm`` sums the squares the same way. On the
    CPU each slice is updated in pieces of :data:`CPU_PIECE` elements, so
    the update's temporaries stay in the caches (1.39 B parameters took 19
    s a step in slices of :data:`SLICE_ELEMS`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Tuple

import torch

PyTree = Any
SLICE_ELEMS = 1 << 26  # elements a slice of the update takes at most
SLICE_LAYER_ELEMS = 1 << 28  # a layer above this many elements is sliced inside too
CPU_PIECE = 1 << 20  # elements the CPU updates at once


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mu_dtype: str = "bfloat16"
    nu_dtype: str = "float32"

    def replace(self, **kw) -> "AdamWConfig":
        return dataclasses.replace(self, **kw)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(opt: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an integer tensor) → the learning rate, a float32 tensor on the
    step's device, with the reference's f32 arithmetic."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        # warm from step 1 so the very first update is non-zero
        warm = opt.peak_lr * (step + 1) / max(opt.warmup_steps, 1)
        frac = torch.clamp(
            (step - opt.warmup_steps) / max(opt.total_steps - opt.warmup_steps, 1), 0, 1
        )
        floor = opt.peak_lr * opt.min_lr_ratio
        cos = floor + 0.5 * (opt.peak_lr - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < opt.warmup_steps, warm, cos)

    return lr


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The leaves in the reference's order (``jax.tree.leaves``: dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def adamw_init(params: PyTree, opt: AdamWConfig) -> Tuple[PyTree, PyTree]:
    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=getattr(torch, opt.mu_dtype), device=p.device), params)
    nu = tree_map(lambda p: torch.zeros(p.shape, dtype=getattr(torch, opt.nu_dtype), device=p.device), params)
    return mu, nu


def slices(t: torch.Tensor) -> Iterator[Any]:
    """Indices of row blocks of ``t``'s leading axis of at most
    :data:`SLICE_ELEMS` elements (a layer of a stack, or several; ``...``,
    the whole, for a 0-d or small leaf); a layer of more than
    :data:`SLICE_LAYER_ELEMS` elements, with an axis below its own, in row
    blocks of that axis, index tuples (layer, rows)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        yield ...
        return
    row = t.numel() // t.shape[0]
    if row > SLICE_LAYER_ELEMS and t.dim() > 2:
        for r in range(t.shape[0]):
            for inner in slices(t[r]):
                yield (r,) + (inner if isinstance(inner, tuple) else (inner,))
        return
    per = max(1, SLICE_ELEMS // max(1, row))
    for r in range(0, t.shape[0], per):
        yield slice(r, r + per)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in float32, slice by slice."""
    sq = 0
    for g in tree_leaves(tree):
        for sl in slices(g):
            sq = sq + torch.sum(torch.square(g[sl].float()))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def adamw_update(
    grads: PyTree,
    params: PyTree,
    mu: PyTree,
    nu: PyTree,
    step: torch.Tensor,  # 0-based
    opt: AdamWConfig,
) -> Tuple[PyTree, PyTree, PyTree, torch.Tensor]:
    """Returns (params, mu, nu, grad_norm), the first three the given trees
    with every leaf updated in place."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = None
        if opt.clip_norm:
            scale = torch.minimum(_f32(1.0, gnorm), opt.clip_norm / torch.clamp(gnorm, min=1e-9))
        lr = cosine_schedule(opt)(step)
        t = (torch.as_tensor(step) + 1).to(torch.float32)
        bc1 = 1 - torch.pow(_f32(opt.b1, t), t)
        bc2 = 1 - torch.pow(_f32(opt.b2, t), t)

        def upd(p, g, m, v):
            if scale is not None:
                g = g * scale.to(device=g.device, dtype=g.dtype)
            g32 = g.float()
            m32 = opt.b1 * m.float() + (1 - opt.b1) * g32
            v32 = opt.b2 * v.float() + (1 - opt.b2) * torch.square(g32)
            mh = m32 / bc1
            vh = v32 / bc2
            delta = mh / (torch.sqrt(vh) + opt.eps)
            if opt.weight_decay:
                delta = delta + opt.weight_decay * p.float()
            new_p = p.float() - lr * delta
            p.copy_(new_p.to(p.dtype))
            m.copy_(m32.to(m.dtype))
            v.copy_(v32.to(v.dtype))

        for p, g, m, v in zip(*(tree_leaves(t_) for t_ in (params, grads, mu, nu))):
            for sl in slices(p):
                views = (p[sl], g[sl], m[sl], v[sl])
                if p.is_cuda or not all(t.is_contiguous() for t in views):
                    upd(*views)
                    continue
                # elementwise: flat pieces of the slice (views, written through) give its result
                for piece in zip(*(t.view(-1).split(CPU_PIECE) for t in views)):
                    upd(*piece)
    return params, mu, nu, gnorm
