"""The sLSTM recurrence on Hopper (CUDA C++, ``csrc/slstm.cu``): the whole
time loop of an sLSTM block in one launch, where the reference runs
``_slstm_cell`` under a ``lax.scan`` (a helper of the ssm family's path,
not a port of a Pallas kernel).

xg (B, S, 4·nh·hd), the input's gate pre-activations (z, i, f, o), float32
or bfloat16; ``r_gates`` (4, nh, hd, hd), float32 or bfloat16 (copied to
packed if they are not); an optional state (h, c, n (B, nh, hd), m (B,
nh)) float32. Returns hs (B, S, nh, hd) and the final (h, c, n, m), all
float32. A thread-block cluster per (head, batch), its blocks splitting the
head's columns (:func:`plan`; hd ≤ 1024). The plain version is
:func:`repro_torch.kernels.ref.slstm_scan_ref`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from ._launch import check_input, stream_ptr
from .ref import SlstmState

MAX_HEAD_DIM = 1024  # csrc/slstm.cu: kMaxHeadDim (a lane per column, 64 columns a block)
TENSOR_MAX_HEAD_DIM = 512  # csrc/slstm.cu: kTensorMaxHd
MAX_CLUSTER = 16  # blocks of a cluster: non-portable above 8
THREADS = 512  # a block: 16 warps


class SlstmPlan(NamedTuple):
    """The launch plan, a plain function of (hd, R's dtype): ``cluster``
    blocks per (head, batch) of ``cols`` columns each; ``tensor``: each block
    keeps its slice of R in registers as tensor-core fragments (bf16 R, hd ≤
    512), else it streams the slice from L2 every step into f32 FMAs;
    ``smem``: bytes of shared memory a block takes."""

    cluster: int
    cols: int
    tensor: bool
    smem: int

    @property
    def route(self) -> str:
        return "tensor" if self.tensor else "streaming"


def smem_bytes(hd: int, cols: int, tensor: bool) -> int:
    """csrc/slstm.cu: slstm_smem_bytes. tensor: h's three bf16 terms twice
    (rows padded to 32, 16 bytes a row), the row means of R_i and R_f, two
    partial sums of the 128 gate columns and the warps' dot products;
    streaming: h twice in f32, the row means, the 16 warps' partial sums."""
    warps = THREADS // 32
    if tensor:
        hr = -(-hd // 32) * 32
        return 2 * hr * 16 + 4 * (2 * hr + 2 * 128 + warps * 2)
    hp, cpad = -(-hd // 8) * 8, -(-cols // 32) * 32
    return 4 * (4 * hp + warps * 4 * cpad + warps * 2)


def plan(hd: int, r_dtype: torch.dtype) -> SlstmPlan:
    """cluster = min(16, ceil(hd / 32)), cols = ceil(hd / cluster): 16
    blocks of 32 columns at hd = 512; the tensor route for bf16 R up to hd
    512, else the streaming one."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"slstm_scan: head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    cluster = min(MAX_CLUSTER, -(-hd // 32))
    cols = -(-hd // cluster)
    tensor = r_dtype == torch.bfloat16 and hd <= TENSOR_MAX_HEAD_DIM
    return SlstmPlan(cluster, cols, tensor, smem_bytes(hd, cols, tensor))


def max_active_clusters(hd: int, xg_dtype: torch.dtype, r_dtype: torch.dtype) -> int:
    """cudaOccupancyMaxActiveClusters for the plan of (hd, R's dtype) on the
    current card: how many (head, batch) clusters run at once."""
    return _active_clusters(torch.cuda.current_device(), hd, xg_dtype == torch.bfloat16,
                            r_dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _active_clusters(device: int, hd: int, xg_bf16: bool, r_bf16: bool) -> int:
    pl = plan(hd, torch.bfloat16 if r_bf16 else torch.float32)
    with torch.cuda.device(device):
        n = build.library().rt_slstm_max_clusters(
            hd, pl.cluster, pl.cols, int(xg_bf16), int(r_bf16), int(pl.tensor))
    if n < 0:
        build.check(-n, "slstm_scan")
    return n


def launch_plan(hd: int, xg_dtype: torch.dtype, r_dtype: torch.dtype) -> str:
    """The launch plan in words (the smoke and the kernel ablation log it)."""
    pl = plan(hd, r_dtype)
    return (f"a cluster of {pl.cluster} blocks x {pl.cols} columns per (head, batch), route "
            f"{pl.route}, {max_active_clusters(hd, xg_dtype, r_dtype)} clusters at once, 1 launch "
            f"per call")


def chain_floor(batch: int, s: int, nh: int, hd: int, r_dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Launch the chain's floor at the plan's cluster shape: ``s`` steps of
    the h exchange and the cluster barrier with no arithmetic (a yardstick
    for :func:`slstm_scan`'s µs a step; not a kernel of the path, so it
    counts no launch). Returns its output buffer."""
    pl = plan(hd, r_dtype)
    out = torch.empty((batch, pl.cluster * nh, pl.cols), dtype=torch.float32, device=device)
    err = build.library().rt_slstm_chain_floor(
        out.data_ptr(), batch, s, nh, hd, pl.cluster, pl.cols, stream_ptr(out))
    build.check(err, "slstm_chain_floor")
    return out


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
    pl = plan(hd, r_gates.dtype)
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
    if _active_clusters(dev.index, hd, xg.dtype == torch.bfloat16, r_gates.dtype == torch.bfloat16) < 1:
        raise RuntimeError(f"slstm_scan: the card cannot place a cluster of {pl.cluster} blocks "
                           f"of {pl.smem} bytes of shared memory")
    xbar = torch.empty((b, nh, s, 2), dtype=torch.float32, device=dev)
    err = build.library().rt_slstm_scan(
        xg.data_ptr(), r_gates.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in init),
        hs.data_ptr(), *(t.data_ptr() for t in final), xbar.data_ptr(),
        b, s, nh, hd, pl.cluster, pl.cols, int(pl.tensor),
        int(xg.dtype == torch.bfloat16), int(r_gates.dtype == torch.bfloat16),
        stream_ptr(xg),
    )
    build.check(err, "slstm_scan")
    build.count_launch("slstm_scan")
    return hs, final
