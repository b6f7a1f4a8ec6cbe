"""K7 · the Mamba2 chunked SSD scan on Hopper (CUDA C++, ``csrc/ssd.cu``).

xh (B, S, nh, P), dt (B, S, nh) float32 (softplus'd), a (nh,) float32
(negative), B/C (B, S, N); xh, B and C float32 or bfloat16, all read
through their strides (the model passes slices of the conv output without a
copy), inner stride 1. Returns y (B, S, nh, P) and the final state
(B, nh, N, P), both float32; ``h0`` (B, nh, N, P) seeds the state. One
block per (batch, head) walks the chunks with the state in shared memory.
S need not be a multiple of ``chunk``: the ragged last chunk is masked
(dt = 0, x = B = C = 0 past S), which leaves y and the state exactly as a
shorter chunk would. Where the whole L x L weight matrix W would not fit in
shared memory, W is computed in row tiles (:func:`row_tile`); chunk, N
and P above 128 are refused. Port of the Pallas kernel
``repro/kernels/ssd.py:ssd_scan``. The plain version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build
from ._launch import stream_ptr

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_DIM = 128  # chunk, N and P: the kernel's register tiles


@functools.lru_cache(maxsize=None)
def row_tile(chunk: int, n: int, p: int) -> int:
    """Rows of W per tile: the whole chunk, halved until the block fits."""
    smem = build.library().rt_ssd_scan_smem
    wi = chunk
    while smem(chunk, n, p, wi) > MAX_SMEM:
        if wi == 1:
            raise ValueError(f"ssd_scan: chunk {chunk}, N {n}, P {p} do not fit in shared memory")
        wi = -(-wi // 2)
    return wi


def _check(t: torch.Tensor, name: str, shape, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"ssd_scan: {name} must be a CUDA tensor, got one on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"ssd_scan: {name} must be one of {list(dtypes)}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.numel() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"ssd_scan: {name} must have inner stride 1, got {tuple(t.stride())}")


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
    if xh.dim() != 4:
        raise ValueError(f"ssd_scan: xh must be (B, S, nh, P), got {tuple(xh.shape)}")
    b, s, nh, p = xh.shape
    n = B_ssm.shape[-1]
    io = (torch.float32, torch.bfloat16)
    _check(xh, "xh", (b, s, nh, p), io)
    _check(dt, "dt", (b, s, nh), (torch.float32,))
    _check(a, "a", (nh,), (torch.float32,))
    _check(B_ssm, "B", (b, s, n), (xh.dtype,))
    _check(C_ssm, "C", (b, s, n), (xh.dtype,))
    if h0 is not None:
        _check(h0, "h0", (b, nh, n, p), (torch.float32,))
        h0 = h0.contiguous()
    for t in (dt, a, B_ssm, C_ssm):
        if t.device != xh.device:
            raise ValueError(f"ssd_scan: inputs on {xh.device} and {t.device}")
    for name, v in (("chunk", chunk), ("N", n), ("P", p)):
        if not 1 <= v <= MAX_DIM:
            raise ValueError(f"ssd_scan: {name} = {v} outside [1, {MAX_DIM}]")
    wi = row_tile(chunk, n, p)
    y = torch.empty((b, s, nh, p), dtype=torch.float32, device=xh.device)
    h = torch.empty((b, nh, n, p), dtype=torch.float32, device=xh.device)
    a = a.contiguous()
    strides = build.strides_arg([
        xh.stride(0), xh.stride(1), xh.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B_ssm.stride(0), B_ssm.stride(1),
        C_ssm.stride(0), C_ssm.stride(1),
    ])
    err = build.library().rt_ssd_scan(
        xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(), h.data_ptr(), strides,
        b, s, nh, p, n, int(chunk), wi, int(xh.dtype == torch.bfloat16), stream_ptr(xh),
    )
    build.check(err, "ssd_scan")
    build.count_launch("ssd_scan")
    return y, h
