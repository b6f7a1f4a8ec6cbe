"""The sLSTM recurrence on Hopper (CUDA C++, ``csrc/slstm.cu``): the whole
time loop of an sLSTM block in one launch, where the reference runs
``_slstm_cell`` under a ``lax.scan`` (a helper of the ssm family's path,
not a port of a Pallas kernel).

xg (B, S, 4·nh·hd), the input's gate pre-activations (z, i, f, o), float32
or bfloat16; ``r_gates`` (4, nh, hd, hd), float32 or bfloat16 (copied to
packed if they are not); an optional state (h, c, n (B, nh, hd), m (B,
nh)) float32. Returns hs (B, S, nh, hd) and the final (h, c, n, m), all
float32. A thread-block cluster per (head, batch), its blocks splitting the
head's columns (:func:`plan`; hd ≤ 4096: above 1024 the streaming route
gives each lane 4 or 8 columns). The plain version is
:func:`repro_torch.kernels.ref.slstm_scan_ref`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from ._launch import check_input, stream_ptr
from .ref import SlstmState

MAX_HEAD_DIM = 4096  # csrc/slstm.cu: kMaxHeadDim (16 blocks of up to 256 columns, 8 a lane)
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
    512, else the streaming one, whose lanes take 2, 4 or 8 columns for
    blocks of up to 64, 128 or 256 (hd up to 1024, 2048 or 4096)."""
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


BWD_KERNEL = ("slstm_bwd (a cluster per (head, batch), the forward's plan turned around: dpre through "
              "distributed shared memory; bf16 R_z, R_o in registers as mma.sync fragments, f32 R "
              "streamed from L2)")
BWD_MAX_HEAD_DIM = MAX_HEAD_DIM  # csrc/slstm_bwd.cu: kMaxHeadDim
BWD_SLOTS = MAX_CLUSTER * 256 // 32  # csrc/slstm_bwd.cu: kSlots, the head sums' partials a buffer holds
BWD_K_GROUPS = THREADS // 32 // 2  # csrc/slstm_bwd.cu: kKGroups, the tensor route's warps over r
# registers a thread of the tensor route holds R_z's and R_o's rows in: 2
# gates x 2 pairs of k-steps x 2 k-steps x 4 (csrc/slstm_bwd.cu: af)
BWD_FRAG_REGS = 2 * 2 * 2 * 4


def bwd_smem_bytes(hd: int, cols: int, tensor: bool) -> int:
    """csrc/slstm_bwd.cu: slstm_bwd_smem_bytes. tensor: dpre's bf16 terms
    twice (16 bytes a row padded to 32 rows), the head sums' partial slots
    twice, the 8 warps' row sums over r, the row sums of R_i and R_f;
    streaming: dpre_z and dpre_o twice in f32, the slots twice, the matvec's
    rows and the row sums."""
    hr = -(-hd // 32) * 32
    if tensor:
        return 2 * hr * 16 + 4 * (2 * BWD_SLOTS * 2 + BWD_K_GROUPS * 32 + 2 * 32)
    return 4 * (2 * 2 * hr + 2 * BWD_SLOTS * 2 + 3 * (-(-cols // 32) * 32))


def bwd_plan(hd: int, r_dtype: torch.dtype) -> SlstmPlan:
    """The backward's plan: the forward's (:func:`plan`: its cluster, its
    columns, a block owning the same rows of R, the tensor route for bf16 R
    up to hd 512) with the backward kernel's shared memory."""
    pl = plan(hd, r_dtype)
    return pl._replace(smem=bwd_smem_bytes(hd, pl.cols, pl.tensor))


@functools.lru_cache(maxsize=None)
def _bwd_active_clusters(device: int, hd: int, r_bf16: bool) -> int:
    pl = bwd_plan(hd, torch.bfloat16 if r_bf16 else torch.float32)
    with torch.cuda.device(device):
        n = build.library().rt_slstm_bwd_max_clusters(hd, pl.cluster, pl.cols, int(r_bf16), int(pl.tensor))
    if n < 0:
        build.check(-n, "slstm_scan_bwd")
    return n


def bwd_launch_plan(hd: int, r_dtype: torch.dtype) -> str:
    """The backward's launch plan in words (the smoke and the kernel ablation log it)."""
    pl = bwd_plan(hd, r_dtype)
    return (f"a cluster of {pl.cluster} blocks x {pl.cols} columns per (head, batch), route "
            f"{pl.route}, {_bwd_active_clusters(torch.cuda.current_device(), hd, r_dtype == torch.bfloat16)} "
            f"clusters at once, 1 launch per call")


def slstm_scan_bwd(
    xg: torch.Tensor, r_gates: torch.Tensor, hs: torch.Tensor, dhs: torch.Tensor,
    dstate: Optional[Tuple[Optional[torch.Tensor], ...]] = None, *,
    state: Optional[SlstmState] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of :func:`slstm_scan` (``csrc/slstm_bwd.cu``): (dxg, dR,
    dh0, dc0, dn0, dm0) for the forward's inputs, its output ``hs`` and the
    incoming gradients ``dhs`` of hs and ``dstate`` = (dh, dc, dn, dm) of
    the final state (None, or None entries, where unused); dxg and dR in
    their inputs' dtypes, the state's gradients None without ``state``.
    Every step's pre-activations xg_t + h_{t-1}·R are one product here (the
    forward's hs gives h_{t-1}; R taken to f32 for it), the reverse chain
    one launch on :func:`bwd_plan` (R as given: bf16 on the tensor route),
    and dR = Σ_t h_{t-1}ᵀ·dpre_t one product of what it writes. Head dims up
    to :data:`BWD_MAX_HEAD_DIM`, any S of at least one step. The plain
    version is :func:`repro_torch.kernels.ref.slstm_scan_bwd_ref`."""
    if xg.dim() != 3 or r_gates.dim() != 4:
        raise ValueError(f"slstm_scan_bwd: xg must be (B, S, 4·nh·hd) and r_gates (4, nh, hd, "
                         f"hd), got {tuple(xg.shape)} and {tuple(r_gates.shape)}")
    b, s, _ = xg.shape
    _, nh, hd, _ = r_gates.shape
    dev = xg.device
    io = (torch.float32, torch.bfloat16)
    f32 = (torch.float32,)
    check_input("slstm_scan_bwd", xg, "xg", (b, s, 4 * nh * hd), io, dev)
    check_input("slstm_scan_bwd", r_gates, "r_gates", (4, nh, hd, hd), io, dev)
    check_input("slstm_scan_bwd", hs, "hs", (b, s, nh, hd), f32, dev)
    check_input("slstm_scan_bwd", dhs, "dhs", (b, s, nh, hd), f32, dev)
    shapes = ((b, nh, hd),) * 3 + ((b, nh),)
    ds = tuple(dstate) if dstate is not None else (None,) * 4
    for name, t, shape in zip(("dh", "dc", "dn", "dm"), ds, shapes):
        if t is not None:
            check_input("slstm_scan_bwd", t, name, shape, f32, dev)
    if state is not None:
        for name, t, shape in zip("hcnm", state, shapes):
            check_input("slstm_scan_bwd", t, name, shape, f32, dev)
    if not 1 <= hd <= BWD_MAX_HEAD_DIM:
        raise ValueError(f"slstm_scan_bwd: head dim {hd} outside [1, {BWD_MAX_HEAD_DIM}] "
                         f"(ROADMAP queue 1)")
    pl = bwd_plan(hd, r_gates.dtype)
    r_bf16 = r_gates.dtype == torch.bfloat16
    if _bwd_active_clusters(dev.index, hd, r_bf16) < 1:
        raise RuntimeError(f"slstm_scan_bwd: the card cannot place a cluster of {pl.cluster} blocks "
                           f"of {pl.smem} bytes of shared memory")
    f = dict(dtype=torch.float32, device=dev)
    init = tuple(t.contiguous() for t in state) if state is not None else (None,) * 4
    ds = tuple(None if t is None else t.contiguous() for t in ds)
    d0 = tuple(torch.empty(shape, **f) for shape in shapes) if state is not None else (None,) * 4
    h0 = init[0] if init[0] is not None else torch.zeros((b, nh, hd), **f)
    hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)  # (B, S, nh, hd)
    r_gates = r_gates.contiguous()
    pre = (xg.float().reshape(b, s, 4, nh, hd)
           + torch.einsum("bshp,ghpr->bsghr", hprev, r_gates.float())).contiguous()
    dpre = torch.empty((b, s, 4, nh, hd), **f)
    cs = torch.empty((b, nh, s, hd), **f)
    ns = torch.empty((b, nh, s, hd), **f)
    gate = torch.empty((b, nh, 3, s), **f)
    dhs = dhs.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().rt_slstm_scan_bwd(
        pre.data_ptr(), r_gates.data_ptr(), *(ptr(t) for t in init[1:]), dhs.data_ptr(),
        *(ptr(t) for t in ds), dpre.data_ptr(), *(ptr(t) for t in d0),
        cs.data_ptr(), ns.data_ptr(), gate.data_ptr(), b, s, nh, hd, pl.cluster, pl.cols,
        int(pl.tensor), int(r_bf16), stream_ptr(xg),
    )
    build.check(err, "slstm_scan_bwd")
    build.count_launch("slstm_scan_bwd")
    dR = torch.einsum("bshp,bsghr->ghpr", hprev, dpre)
    return (dpre.reshape(b, s, 4 * nh * hd).to(xg.dtype), dR.to(r_gates.dtype)) + d0
