"""Kalman scan on Hopper (``csrc/kalman.cu``): a helper, not a TPU-kernel port.

The riot ``kalman`` operator filters each observation channel over the
rows of a batch; the reference runs it as a row-sequential ``lax.scan``.
One CUDA thread per channel walks the rows in order, so a step costs one
launch instead of several per row. The plain version is
:func:`repro_torch.kernels.ref.kalman_scan_ref`, which it equals bitwise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ._launch import rows_of, stream_ptr


def kalman_scan(
    z: torch.Tensor, xe: torch.Tensor, p: torch.Tensor, q: float, r: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    z2, rows, c, stride = rows_of(z, "z", (torch.float32,))
    if z.dim() != 2:
        raise ValueError(f"z must be (rows, channels), got shape {tuple(z.shape)}")
    for name, t in (("xe", xe), ("p", p)):
        if t.device != z.device or t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be float32 ({c},) on {z.device}")
    xe0, p0 = xe.contiguous(), p.contiguous()
    y = torch.empty((rows, c), dtype=torch.float32, device=z.device)
    xe1 = torch.empty_like(xe0)
    p1 = torch.empty_like(p0)
    lib = build.library()
    err = lib.rt_kalman_scan(
        z2.data_ptr(), stride, xe0.data_ptr(), p0.data_ptr(), y.data_ptr(),
        xe1.data_ptr(), p1.data_ptr(), rows, c, float(q), float(r), stream_ptr(z),
    )
    build.check(err, "kalman_scan")
    build.count_launch("kalman_scan")
    return y, xe1, p1
