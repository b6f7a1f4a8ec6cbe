"""Argument checks shared by the CUDA kernel wrappers."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def rows_of(x: torch.Tensor, name: str, dtypes: Sequence[torch.dtype]) -> Tuple[torch.Tensor, int, int, int]:
    """Check a (…, D) kernel input; return it as (rows, D) with its row stride.

    The kernels read rows through an explicit row stride, so a column slice
    of a wider batch (``x[:, 1:6]`` of the (B, 8) event batch) passes without
    a copy; the inner stride has to be 1.
    """
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)}, got {x.dtype}")
    if x.dim() == 0:
        raise ValueError(f"{name} must have at least one dimension")
    d = x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, d)
    if d > 1 and x2.stride(1) != 1:
        raise ValueError(f"{name} must have inner stride 1, got strides {tuple(x.stride())}")
    stride = x2.stride(0) if x2.shape[0] > 1 else d
    return x2, x2.shape[0], d, stride


def scale_of(scale: torch.Tensor, x: torch.Tensor, d: int) -> torch.Tensor:
    """Check a (D,) per-channel gain on x's device; return it as packed float32."""
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(scale.shape)}")
    return scale.to(torch.float32).contiguous()


def check_input(kernel: str, t: torch.Tensor, name: str, shape, dtypes: Sequence[torch.dtype],
                device: torch.device) -> None:
    """Raise unless ``t`` is a CUDA tensor on ``device`` of one of ``dtypes``
    and of ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got one on {t.device}")
    if t.device != device:
        raise ValueError(f"{kernel}: inputs on {device} and {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} must be one of {list(dtypes)}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
