"""Autograd for the kernels on the training path (K1, K4, K5).

Each class is a ``torch.autograd.Function`` whose forward launches the
kernel and saves what its backward kernel reads, and whose backward
launches that kernel: ``rmsnorm_bwd`` (``csrc/rmsnorm_bwd.cu``) for K1 and
K4, ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``) for K5. They
run on CUDA tensors only; :mod:`repro_torch.kernels.ops` sends a CUDA call
here when autograd needs it, the inference path straight to the kernels
and the CPU to the plain versions. A failed build or launch raises, in
either direction.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_bwd
from .rmsnorm import rmsnorm, rmsnorm_bwd, rmsnorm_residual


class RmsNorm(torch.autograd.Function):
    """K1 forward, ``rmsnorm_bwd`` backward: saves x and the gain."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, g, scale, ctx.eps)
        return dx, dscale.to(scale.dtype), None


class RmsNormResidual(torch.autograd.Function):
    """K4 forward, ``rmsnorm_bwd`` backward on the float32 sum of the saved x
    and res: the gradient of h and y's through the norm, as both dx and
    dres."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, eps: float):
        ctx.save_for_backward(x, res, scale)
        ctx.eps = eps
        ctx.set_materialize_grads(False)  # h's gradient is None where h is unused: no zeros read
        return rmsnorm_residual(x, res, scale, eps=eps)

    @staticmethod
    def backward(ctx, g: Optional[torch.Tensor], gh: Optional[torch.Tensor]):
        x, res, scale = ctx.saved_tensors
        if g is None:  # only h reaches the loss
            g = torch.zeros_like(x)
        dx, dscale = rmsnorm_bwd(x, g, scale, ctx.eps, res=res, gh=gh)
        # dres is dx's value in a tensor of its own: autograd may add into a
        # gradient in place, which must not reach the other
        return dx, dx.clone(), dscale.to(scale.dtype), None


class FlashAttention(torch.autograd.Function):
    """K5 forward with its per-row log-sum-exp, ``flash_attention_bwd``
    backward: saves q, k, v, the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
                scale: Optional[float]) -> torch.Tensor:
        o, lse = flash_attention(q, k, v, causal=causal, window=window, scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None
