"""K1 · row-wise RMSNorm and K4 · RMSNorm after a residual add, on Hopper
(CUDA C++, ``csrc/rmsnorm.cu``).

K1: y = x·rsqrt(mean(x²)+eps)·scale with float32 math, output in x's dtype
(float32 or bfloat16). Port of the Pallas kernel
``repro/kernels/rmsnorm.py:rmsnorm``. Narrow rows (D ≤ 8, the stream
path's (B, 5) event batches) run one thread per row; model widths run one
block per row. The plain version is :func:`repro_torch.kernels.ref.rmsnorm_ref`.

K4: h = x + res in float32, y = rmsnorm(h)·scale; returns (y, h), both in
x's dtype. Port of ``repro/kernels/rmsnorm.py:rmsnorm_residual``; the same
template as K1 with a second input and output. The plain version is
:func:`repro_torch.kernels.ref.rmsnorm_residual_ref`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ._launch import rows_of, scale_of, stream_ptr


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x2, rows, d, stride = rows_of(x, "x", (torch.float32, torch.bfloat16))
    g = scale_of(scale, x, d)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    lib = build.library()
    err = lib.rt_rmsnorm(
        x2.data_ptr(), stride, g.data_ptr(), y.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), stream_ptr(x),
    )
    build.check(err, "rmsnorm")
    build.count_launch("rmsnorm")
    return y.reshape(x.shape)


def rmsnorm_residual(
    x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    x2, rows, d, stride = rows_of(x, "x", (torch.float32, torch.bfloat16))
    r2, r_rows, r_d, r_stride = rows_of(res, "res", (x.dtype,))
    if (r_rows, r_d) != (rows, d):
        raise ValueError(f"res has shape {tuple(res.shape)}, x {tuple(x.shape)}")
    g = scale_of(scale, x, d)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    added = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    lib = build.library()
    err = lib.rt_rmsnorm_residual(
        x2.data_ptr(), stride, r2.data_ptr(), r_stride, g.data_ptr(), y.data_ptr(),
        added.data_ptr(), rows, d, float(eps), int(x.dtype == torch.bfloat16), stream_ptr(x),
    )
    build.check(err, "rmsnorm_residual")
    build.count_launch("rmsnorm_residual")
    return y.reshape(x.shape), added.reshape(x.shape)
