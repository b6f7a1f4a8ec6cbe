"""K5 · flash attention (forward) on Hopper (CUDA C++, ``csrc/flash_attention.cu``).

q (B, Sq, H, hd), k/v (B, Sk, KV, hd) with H a multiple of KV: the kernel
reads KV head ``h // (H // KV)`` for q head ``h`` in place, so the GQA
repeat that the reference wrapper materializes (``repro/kernels/ops.py``)
never exists on the card. Online softmax with an f32 accumulator, causal
and sliding-window masks (``k_pos > q_pos - window``), whole tiles past
either frontier skipped. Port of the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention``. The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from ._launch import stream_ptr

HEAD_DIMS = (16, 32, 64, 80, 128)  # 80: zamba2's shared attention block


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> None:
    """q (B, ·, H, hd) against k/v (B, S, KV, hd): one CUDA device, one
    float32/bfloat16 dtype, H a multiple of KV, a head dim the kernels
    take, inner stride 1."""
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda:
            raise ValueError(f"{name}: {n} must be a CUDA tensor, got one on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {n} must be 4-D, got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: q, k, v must all be float32 or all bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name}: q is on {q.device}, {n} on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {n} must have inner stride 1, got {tuple(t.stride())}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{name}: {h} q heads are not a multiple of {k.shape[2]} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    check_heads(q, k, v, "flash_attention")
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else hd ** -0.5)
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = build.strides_arg(
        [s for t in (q, k, v, o) for s in t.stride()[:3]]
    )
    err = build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
        b, sq, sk, h, kv, hd, scale, int(causal), int(window),
        int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "flash_attention")
    build.count_launch("flash_attention")
    return o
