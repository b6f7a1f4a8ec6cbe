"""Device-dispatching kernel entry points, the port's ``repro.kernels.ops``.

Each entry point looks at the tensor it is given: on a CUDA tensor it
launches the hand-written kernel (and raises if the build or the launch
fails; there is no fallback), anywhere else it runs the plain PyTorch
version from :mod:`repro_torch.kernels.ref`. The operators call these, so
the CPU tests and the card run the same operator code.

:func:`launch_counts` reports the CUDA launches per kernel since the last
:func:`reset_launch_counts`, which is how a run proves that its main path
went through the kernels.

Under autograd (grad enabled and an input that requires it), a CUDA call
of K1, K4, K5, K7 or the ssm scans goes through
:mod:`repro_torch.kernels.autograd`, whose forward launches the same kernel
(K5 also writing its log-sum-exp) and whose backward launches the
hand-written backward kernel; on the CPU autograd runs through the plain
versions, as always. A CUDA call that needs a gradient from a kernel
without a backward kernel (K6) raises, naming the ROADMAP item that adds
it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import ref
from .build import launch_counts, reset_launch_counts  # noqa: F401 — public surface

Stages = Sequence[Tuple[float, float]]
NO_BACKWARD = "ROADMAP queue 1: K6 has no training use"


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd needs a gradient from CUDA kernel ``name``, which
    has no backward kernel yet."""
    if _needs_grad(*tensors):
        raise NotImplementedError(f"{name} on the card under autograd: no backward kernel "
                                  f"({NO_BACKWARD})")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if x.is_cuda:
        if _needs_grad(x, scale):
            from .autograd import RmsNorm

            return RmsNorm.apply(x, scale, eps)
        from .rmsnorm import rmsnorm as _cuda

        return _cuda(x, scale, eps=eps)
    return ref.rmsnorm_ref(x, scale, eps)


def rmsnorm_residual(
    x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rmsnorm(x + res)·scale, x + res), the sum taken in float32."""
    if x.is_cuda:
        if _needs_grad(x, res, scale):
            from .autograd import RmsNormResidual

            return RmsNormResidual.apply(x, res, scale, eps)
        from .rmsnorm import rmsnorm_residual as _cuda

        return _cuda(x, res, scale, eps=eps)
    return ref.rmsnorm_residual_ref(x, res, scale, eps)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hd_v) with hd_v <=
    hd: KV heads are taken natively."""
    if q.is_cuda:
        if _needs_grad(q, k, v):
            from .autograd import FlashAttention

            return FlashAttention.apply(q, k, v, causal, window, scale)
        from .flash_attention import flash_attention as _cuda

        return _cuda(q, k, v, causal=causal, window=window, scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: int,
    *,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token (B, 1, H, hd) against a (B, S, KV, hd) cache."""
    if q.is_cuda:
        _no_backward("decode_attention", q, k_cache, v_cache)
        from .decode_attention import decode_attention as _cuda

        return _cuda(q, k_cache, v_cache, cache_len, window=window, scale=scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len, window=window, scale=scale)


def ssd_scan(
    xh: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    B_ssm: torch.Tensor,
    C_ssm: torch.Tensor,
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 chunked SSD scan → (y (B, S, nh, P), final state (B, nh, N, P)),
    both float32; any S (the ragged last chunk is masked)."""
    if xh.is_cuda:
        if _needs_grad(xh, dt, a, B_ssm, C_ssm, h0):
            from .autograd import SsdScan

            return SsdScan.apply(xh, dt, a, B_ssm, C_ssm, h0, chunk)
        from .ssd import ssd_scan as _cuda

        return _cuda(xh, dt, a, B_ssm, C_ssm, chunk=chunk, h0=h0)
    return ref.ssd_scan_ref(xh, dt, a, B_ssm, C_ssm, chunk, h0)


def mlstm_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,
    f_gate: torch.Tensor,
    *,
    chunk: int = 64,
    state: Optional[ref.MlstmState] = None,
) -> Tuple[torch.Tensor, ref.MlstmState]:
    """The chunked mLSTM scan → (y (B, S, nh, P) float32, final (C, n, m));
    any S (the ragged last chunk is masked)."""
    if q.is_cuda:
        if _needs_grad(q, k, v, i_gate, f_gate, *(state or ())):
            from .autograd import MlstmScan

            y, *final = MlstmScan.apply(q, k, v, i_gate, f_gate, *(state or (None,) * 3), chunk)
            return y, tuple(final)
        from .mlstm import mlstm_scan as _cuda

        return _cuda(q, k, v, i_gate, f_gate, chunk=chunk, state=state)
    return ref.mlstm_scan_ref(q, k, v, i_gate, f_gate, chunk, state)


def slstm_scan(
    xg: torch.Tensor, r_gates: torch.Tensor, *, state: Optional[ref.SlstmState] = None
) -> Tuple[torch.Tensor, ref.SlstmState]:
    """The sLSTM recurrence over S → (hs (B, S, nh, hd) float32, final
    (h, c, n, m))."""
    if xg.is_cuda:
        if _needs_grad(xg, r_gates, *(state or ())):
            from .autograd import SlstmScan

            hs, *final = SlstmScan.apply(xg, r_gates, *(state or (None,) * 4))
            return hs, tuple(final)
        from .slstm import slstm_scan as _cuda

        return _cuda(xg, r_gates, state=state)
    return ref.slstm_scan_ref(xg, r_gates, state)


def map_chain(x: torch.Tensor, *, stages: Stages) -> torch.Tensor:
    """Sequential per-channel affine stages — the fused senml_parse chain."""
    if x.is_cuda:
        from .fused import map_chain as _cuda

        return _cuda(x, stages)
    return ref.map_chain_ref(x, stages)


def affine_rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, stages: Stages, eps: float = 1e-6
) -> torch.Tensor:
    """Affine decode chain feeding an RMS-norm tail, one fused pass."""
    if x.is_cuda:
        from .fused import affine_rmsnorm as _cuda

        return _cuda(x, scale, stages, eps=eps)
    return ref.affine_rmsnorm_ref(x, scale, stages, eps)


def kalman_scan(
    z: torch.Tensor, xe: torch.Tensor, p: torch.Tensor, q: float, r: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel scalar Kalman filter over the rows of ``z`` (B, C)."""
    if z.is_cuda:
        from .kalman import kalman_scan as _cuda

        return _cuda(z, xe, p, q, r)
    if z.device.type == "meta":  # shape probe (runtime/segment.py): no row loop
        return torch.empty(z.shape, dtype=torch.float32, device="meta"), xe, p
    return ref.kalman_scan_ref(z, xe, p, q, r)
