"""K1 · row-wise RMSNorm on Hopper (CUDA C++, ``csrc/rmsnorm.cu``).

y = x·rsqrt(mean(x²)+eps)·scale with float32 math, output in x's dtype
(float32 or bfloat16). Port of the Pallas kernel
``repro/kernels/rmsnorm.py:rmsnorm``. Narrow rows (D ≤ 8, the stream
path's (B, 5) event batches) run one thread per row; model widths run one
block per row. The plain version is :func:`repro_torch.kernels.ref.rmsnorm_ref`.
"""
from __future__ import annotations

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
