"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in the same float32
operation order, with torch ops that run on any device. The CPU path of
:mod:`repro_torch.kernels.ops` uses them, the tests hold them to
``repro.kernels.ref`` and to the Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel to them on the card. Nothing on the GPU path calls
them.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Stages = Sequence[Tuple[float, float]]


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x·rsqrt(mean(x²) + eps)·scale in float32, returned in x's dtype.

    ``contiguous()`` pins the layout the row sums are taken over, so a
    strided view and a packed copy of the same rows give the same bits.
    """
    xf = x.float().contiguous()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def map_chain_ref(x: torch.Tensor, stages: Stages) -> torch.Tensor:
    """x ← x·s + o per stage, each product and sum rounded separately.

    Sequential, never algebraically collapsed: bitwise identity with the
    unfused op-by-op ``senml_parse`` chain is the contract.
    """
    for scale, offset in stages:
        x = x * scale + offset
    return x


def affine_rmsnorm_ref(
    x: torch.Tensor, scale: torch.Tensor, stages: Stages, eps: float = 1e-6
) -> torch.Tensor:
    return rmsnorm_ref(map_chain_ref(x, stages), scale, eps)


def kalman_scan_ref(
    z: torch.Tensor, xe: torch.Tensor, p: torch.Tensor, q: float, r: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scalar Kalman filter per channel over the rows of ``z`` (B, C).

    Per row: p⁻ = p + q; k = p⁻/(p⁻ + r); xe ← xe + k·(z − xe);
    p ← (1 − k)·p⁻. Returns (filtered rows (B, C), final xe, final p).
    """
    rows = []
    for i in range(z.shape[0]):
        p_pred = p + q
        k = p_pred / (p_pred + r)
        xe = xe + k * (z[i] - xe)
        p = (1.0 - k) * p_pred
        rows.append(xe)
    y = torch.stack(rows) if rows else z.new_empty((0,) + tuple(z.shape[1:]))
    return y, xe, p
