"""Autograd for the kernels on the training path (K1, K4, K5, K7 and the
ssm family's two scans).

Each class is a ``torch.autograd.Function`` whose forward launches the
kernel and saves what its backward kernel reads, and whose backward
launches that kernel: ``rmsnorm_bwd`` (``csrc/rmsnorm_bwd.cu``) for K1 and
K4, ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``) for K5,
``ssd_scan_bwd`` (``csrc/ssd_bwd.cu``) for K7, ``mlstm_scan_bwd``
(``csrc/mlstm_bwd.cu``) and ``slstm_scan_bwd`` (``csrc/slstm_bwd.cu``) for
the scans. A scan's returned state is often unused (a training forward
drops it): its gradient then arrives as None and the backward kernel reads
no zeros for it. They
run on CUDA tensors only; :mod:`repro_torch.kernels.ops` sends a CUDA call
here when autograd needs it, the inference path straight to the kernels
and the CPU to the plain versions. A failed build or launch raises, in
either direction.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_bwd
from .mlstm import mlstm_scan, mlstm_scan_bwd
from .rmsnorm import rmsnorm, rmsnorm_bwd, rmsnorm_residual
from .slstm import slstm_scan, slstm_scan_bwd
from .ssd import ssd_scan, ssd_scan_bwd


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


def _state(tensors):
    return None if tensors[0] is None else tuple(tensors)


class SsdScan(torch.autograd.Function):
    """K7 forward, ``ssd_scan_bwd`` backward: saves the inputs (the backward
    recomputes the chunk states)."""

    @staticmethod
    def forward(ctx, xh, dt, a, B_ssm, C_ssm, h0, chunk: int):
        ctx.save_for_backward(xh, dt, a, B_ssm, C_ssm, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_scan(xh, dt, a, B_ssm, C_ssm, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], dh: Optional[torch.Tensor]):
        xh, dt, a, B_ssm, C_ssm, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xh.shape, dtype=torch.float32, device=xh.device)
        grads = ssd_scan_bwd(xh, dt, a, B_ssm, C_ssm, dy.float(), dh, chunk=ctx.chunk, h0=h0)
        return grads + (None,)


class MlstmScan(torch.autograd.Function):
    """mlstm_scan forward, ``mlstm_scan_bwd`` backward: saves the inputs and
    y (the backward recomputes the states before each chunk)."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, C0, n0, m0, chunk: int):
        state = _state((C0, n0, m0))
        y, final = mlstm_scan(q, k, v, i_gate, f_gate, chunk=chunk, state=state)
        ctx.save_for_backward(q, k, v, i_gate, f_gate, C0, n0, m0, y)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return (y,) + tuple(final)

    @staticmethod
    def backward(ctx, dy, dC, dn, dm):
        q, k, v, i_gate, f_gate, C0, n0, m0, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        grads = mlstm_scan_bwd(q, k, v, i_gate, f_gate, y, dy.float(), (dC, dn, dm),
                               chunk=ctx.chunk, state=_state((C0, n0, m0)))
        return grads + (None,)


class SlstmScan(torch.autograd.Function):
    """slstm_scan forward, ``slstm_scan_bwd`` backward: saves the inputs and
    hs (the backward forms every step's pre-activations from them)."""

    @staticmethod
    def forward(ctx, xg, r_gates, h0, c0, n0, m0):
        state = _state((h0, c0, n0, m0))
        hs, final = slstm_scan(xg, r_gates, state=state)
        ctx.save_for_backward(xg, r_gates, h0, c0, n0, m0, hs)
        ctx.set_materialize_grads(False)
        return (hs,) + tuple(final)

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        xg, r_gates, h0, c0, n0, m0, hs = ctx.saved_tensors
        if dhs is None:
            dhs = torch.zeros_like(hs)
        return slstm_scan_bwd(xg, r_gates, hs, dhs.float(), (dh, dc, dn, dm),
                              state=_state((h0, c0, n0, m0)))
