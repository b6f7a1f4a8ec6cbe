"""The sLSTM recurrence on Hopper (CUDA C++, ``csrc/slstm.cu``): the whole
time loop of an sLSTM block in one launch, where the reference runs
``_slstm_cell`` under a ``lax.scan`` (a helper of the ssm family's path,
not a port of a Pallas kernel).

xg (B, S, 4·nh·hd), the input's gate pre-activations (z, i, f, o), float32
or bfloat16; ``r_gates`` (4, nh, hd, hd), float32 or bfloat16 (copied to
packed if they are not); an optional state (h, c, n (B, nh, hd), m (B,
nh)) float32. Returns hs (B, S, nh, hd) and the final (h, c, n, m), all
float32. A block per (head, batch), a thread per column (hd ≤ 1024). The
plain version is :func:`repro_torch.kernels.ref.slstm_scan_ref`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from ._launch import check_input, stream_ptr
from .ref import SlstmState

MAX_HEAD_DIM = 1024  # one thread per column


def slstm_scan(
    xg: torch.Tensor, r_gates: torch.Tensor, *, state: Optional[SlstmState] = None
) -> Tuple[torch.Tensor, SlstmState]:
    if xg.dim() != 3 or r_gates.dim() != 4:
        raise ValueError(f"slstm_scan: xg must be (B, S, 4·nh·hd) and r_gates (4, nh, hd, hd), "
                         f"got {tuple(xg.shape)} and {tuple(r_gates.shape)}")
    b, s, _ = xg.shape
    _, nh, hd, _ = r_gates.shape
    dev = xg.device
    io = (torch.float32, torch.bfloat16)
    check_input("slstm_scan", xg, "xg", (b, s, 4 * nh * hd), io, dev)
    check_input("slstm_scan", r_gates, "r_gates", (4, nh, hd, hd), io, dev)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_scan: head dim {hd} above {MAX_HEAD_DIM}")
    xg, r_gates = xg.contiguous(), r_gates.contiguous()
    init = (None,) * 4
    if state is not None:
        for name, t, shape in zip("hcnm", state, ((b, nh, hd),) * 3 + ((b, nh),)):
            check_input("slstm_scan", t, name, shape, (torch.float32,), dev)
        init = tuple(t.contiguous() for t in state)
    hs = torch.empty((b, s, nh, hd), dtype=torch.float32, device=dev)
    final = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                  for shape in ((b, nh, hd),) * 3 + ((b, nh),))
    if b == 0 or nh == 0:
        return hs, final
    err = build.library().rt_slstm_scan(
        xg.data_ptr(), r_gates.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in init),
        hs.data_ptr(), *(t.data_ptr() for t in final),
        b, s, nh, hd, int(xg.dtype == torch.bfloat16), int(r_gates.dtype == torch.bfloat16),
        stream_ptr(xg),
    )
    build.check(err, "slstm_scan")
    build.count_launch("slstm_scan")
    return hs, final
