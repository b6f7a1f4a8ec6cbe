"""The chunked mLSTM scan on Hopper (CUDA C++, ``csrc/mlstm.cu``): a kernel
of the ssm family's path at the reference's ``kernel_mlstm_scan`` region,
not a port of a Pallas kernel (the reference leaves the scan to XLA).

q/k/v (B, S, nh, P) float32 or bfloat16 (one dtype, copied to packed if
they are not), the gates' pre-activations ĩ, f̃ (B, S, nh) in any float
dtype and layout (taken to packed float32 here: B·S·nh values), an
optional state (C (B, nh, P, P), n (B, nh, P), m (B, nh)) float32. Returns
y (B, S, nh, P) and the final (C, n, m), all float32. Any S: the ragged
last chunk is masked. One launch per call, a block per (tile of
:func:`rows_per_block` rows of C, head, batch); chunks up to
:data:`MAX_CHUNK`. The plain version is
:func:`repro_torch.kernels.ref.mlstm_scan_ref`.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build
from ._launch import check_input, stream_ptr
from .ref import MlstmState

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_CHUNK = 64  # csrc/mlstm.cu: kMaxChunk
MAX_ROWS = 32  # rows of C a block holds at most (csrc/mlstm.cu: kMaxTP)


@functools.lru_cache(maxsize=None)
def rows_per_block(p: int) -> int:
    """Rows of C (its value index) a block keeps in shared memory: 32, or
    fewer where P is narrower or a block of 32 rows does not fit."""
    smem = build.library().rt_mlstm_scan_smem
    tp = min(MAX_ROWS, p)
    while smem(p, tp) > MAX_SMEM:
        if tp == 1:
            raise ValueError(f"mlstm_scan: a row of C at P = {p} does not fit a block")
        tp //= 2
    return tp


def mlstm_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,
    f_gate: torch.Tensor,
    *,
    chunk: int = 64,
    state: Optional[MlstmState] = None,
) -> Tuple[torch.Tensor, MlstmState]:
    if q.dim() != 4:
        raise ValueError(f"mlstm_scan: q must be (B, S, nh, P), got {tuple(q.shape)}")
    b, s, nh, p = q.shape
    dev = q.device
    io = (torch.float32, torch.bfloat16)
    check_input("mlstm_scan", q, "q", (b, s, nh, p), io, dev)
    for name, t in (("k", k), ("v", v)):
        check_input("mlstm_scan", t, name, (b, s, nh, p), (q.dtype,), dev)
    floats = (torch.float32, torch.bfloat16, torch.float16)
    for name, t in (("i_gate", i_gate), ("f_gate", f_gate)):
        check_input("mlstm_scan", t, name, (b, s, nh), floats, dev)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mlstm_scan: chunk = {chunk} outside [1, {MAX_CHUNK}]")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ig, fg = i_gate.float().contiguous(), f_gate.float().contiguous()
    init = (None, None, None)
    if state is not None:
        for name, t, shape in zip("Cnm", state, ((b, nh, p, p), (b, nh, p), (b, nh))):
            check_input("mlstm_scan", t, name, shape, (torch.float32,), dev)
        init = tuple(t.contiguous() for t in state)
    y = torch.empty((b, s, nh, p), dtype=torch.float32, device=dev)
    C = torch.empty((b, nh, p, p), dtype=torch.float32, device=dev)
    n = torch.empty((b, nh, p), dtype=torch.float32, device=dev)
    m = torch.empty((b, nh), dtype=torch.float32, device=dev)
    if b == 0 or nh == 0:
        return y, (C, n, m)
    with torch.cuda.device(dev):
        tp = rows_per_block(p)
    err = build.library().rt_mlstm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(), fg.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in init),
        y.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
        b, s, nh, p, int(chunk), tp, int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "mlstm_scan")
    build.count_launch("mlstm_scan")
    return y, (C, n, m)
