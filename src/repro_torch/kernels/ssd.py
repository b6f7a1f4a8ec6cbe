"""K7 · the Mamba2 chunked SSD scan on Hopper (CUDA C++, ``csrc/ssd.cu``).

xh (B, S, nh, P), dt (B, S, nh) float32 (softplus'd), a (nh,) float32
(negative), B/C (B, S, N); xh, B and C float32 or bfloat16, all read
through their strides (the model passes slices of the conv output without a
copy), inner stride 1. Returns y (B, S, nh, P) and the final state
(B, nh, N, P), both float32; ``h0`` (B, nh, N, P) seeds the state. S need
not be a multiple of ``chunk``: the ragged last chunk is masked (dt = 0,
x = B = C = 0 past S), which leaves y and the state exactly as a shorter
chunk would.

Three builds (:func:`route`). bfloat16, the serving path's: the
chunks in parallel on tensor cores, in three launches (each chunk's own
state, the state pass over the chunks, the outputs; each launch counts,
:func:`launches`), with blocks over
(batch, chunk, group of :func:`head_group` heads) and the per-chunk states
in a scratch buffer cached per (device, stream). float32, for the checks:
the SIMT build, one block per (batch, head) walking the chunks, with W in
row tiles where it does not fit whole (:func:`row_tile`). Any other shape
(chunk, N or P above 128 in either dtype, and float32 where even a row
tile of one does not fit, as at chunk = N = P = 128) runs the tiled build:
one block per (batch, head), every product over 32 x 32 tiles, the state
kept in the output ``h`` and a (B, nh, 4, chunk) float32 scratch made per
call. Port of the
Pallas kernel ``repro/kernels/ssd.py:ssd_scan``. The plain version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import build
from ._launch import check_input, stream_ptr

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
REG_DIM = 128  # chunk, N and P of the SIMT and tensor-core builds' register tiles

# the build each input dtype runs where its shape fits (see route)
KERNELS = {torch.float32: "ssd_chunk_scan (SIMT f32)",
           torch.bfloat16: "ssd_chunk_state + ssd_state_pass + ssd_chunk_out (mma.sync bf16)"}
TILES_KERNEL = "ssd_chunk_tiles (SIMT f32 FMAs over 32 x 32 tiles)"

# (device, stream) -> (per-chunk states, the states split into bf16 hi + lo,
# per-chunk decays), float32; grown, never shrunk. Every launch writes the
# slots it reads, so calls on one stream may share them.
_scratch: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def head_group(batch: int, chunks: int, nh: int, slots: int) -> int:
    """Heads per block of the bf16 build's output kernel: blocks are
    (batch, chunk, group), ``slots`` of them run at once. The smallest group
    whose blocks all fit in one wave; where even one block per (batch,
    chunk) does not, all the heads (C·Bᵀ once per chunk). Block ``k`` of a
    batch and chunk takes heads ``[k·g, min(nh, k·g + g))``."""
    for g in range(1, nh + 1):
        if batch * chunks * -(-nh // g) <= slots:
            return g
    return max(nh, 1)


@functools.lru_cache(maxsize=None)
def _plan(device: torch.device, batch: int, chunks: int, nh: int, chunk: int, n: int, p: int) -> int:
    with torch.cuda.device(device):
        per_sm = build.library().rt_ssd_blocks_per_sm(chunk, n, p)
    if per_sm < 1:
        raise RuntimeError(f"ssd_scan: no block of the output kernel fits an SM of {device}")
    slots = torch.cuda.get_device_properties(device).multi_processor_count * per_sm
    return head_group(batch, chunks, nh, slots)


def launches(b: int, s: int, nh: int, bf16: bool, tiles: bool = False) -> int:
    """Kernels one call launches: the SIMT and tiled builds one; the bf16
    tensor-core build the state pass, and the chunk states and the outputs
    where there are positions. None for an empty batch."""
    if b == 0 or nh == 0:
        return 0
    return 1 if tiles or not bf16 or s == 0 else 3


def route(dtype: torch.dtype, chunk: int, n: int, p: int) -> str:
    """The build a call runs: ``"mma"`` (bf16, chunk, N and P up to 128),
    ``"simt"`` (f32 where its tiles fit, :func:`row_tile`) or ``"tiles"``
    (the rest). Asks the kernel library for the SIMT build's shared memory."""
    if max(chunk, n, p) > REG_DIM:
        return "tiles"
    if dtype == torch.bfloat16:
        return "mma"
    return "simt" if row_tile(chunk, n, p) else "tiles"


def kernel_name(dtype: torch.dtype, chunk: int, n: int, p: int) -> str:
    """The kernels :func:`route` picks, by name."""
    return TILES_KERNEL if route(dtype, chunk, n, p) == "tiles" else KERNELS[dtype]


def _scratch_for(device: torch.device, stream: int, n_states: int, n_el: int):
    buf = _scratch.get((device, stream))
    if buf is None or buf[0].numel() < n_states or buf[2].numel() < n_el:
        n_states = max(n_states, 1 if buf is None else buf[0].numel())
        n_el = max(n_el, 1 if buf is None else buf[2].numel())
        buf = tuple(torch.empty(k, dtype=torch.float32, device=device)
                    for k in (n_states, n_states, n_el))
        _scratch[(device, stream)] = buf
    return buf


@functools.lru_cache(maxsize=None)
def row_tile(chunk: int, n: int, p: int) -> int:
    """Rows of W per tile of the SIMT build: the whole chunk, halved until
    the block fits; 0 where a tile of one row does not fit."""
    smem = build.library().rt_ssd_scan_smem
    wi = chunk
    while smem(chunk, n, p, wi) > MAX_SMEM:
        if wi == 1:
            return 0
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
        if v < 1:
            raise ValueError(f"ssd_scan: {name} = {v} must be at least 1")
    y = torch.empty((b, s, nh, p), dtype=torch.float32, device=xh.device)
    h = torch.empty((b, nh, n, p), dtype=torch.float32, device=xh.device)
    a = a.contiguous()
    strides = build.strides_arg([
        xh.stride(0), xh.stride(1), xh.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B_ssm.stride(0), B_ssm.stride(1),
        C_ssm.stride(0), C_ssm.stride(1),
    ])
    stream = stream_ptr(xh)
    bf16 = xh.dtype == torch.bfloat16
    if route(xh.dtype, int(chunk), n, p) == "tiles":
        work = torch.empty((b, nh, 4, chunk), dtype=torch.float32, device=xh.device)
        err = build.library().rt_ssd_scan_tiles(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(), h.data_ptr(), strides,
            b, s, nh, p, n, int(chunk), work.data_ptr(), int(bf16), stream,
        )
        build.check(err, "ssd_scan")
        for _ in range(launches(b, s, nh, bf16, tiles=True)):
            build.count_launch("ssd_scan")
        return y, h
    wi, group, states, hsplit, el = 1, 0, None, None, None
    if bf16:
        chunks = -(-s // chunk)
        group = _plan(xh.device, b, chunks, nh, int(chunk), n, p)
        states, hsplit, el = (t.data_ptr() for t in _scratch_for(
            xh.device, stream, b * chunks * nh * n * p, b * chunks * nh))
    else:
        wi = row_tile(chunk, n, p)
    err = build.library().rt_ssd_scan(
        xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(), h.data_ptr(), strides,
        b, s, nh, p, n, int(chunk), wi, group, states, hsplit, el, int(bf16), stream,
    )
    build.check(err, "ssd_scan")
    for _ in range(launches(b, s, nh, bf16)):
        build.count_launch("ssd_scan")
    return y, h


# the backward build each input dtype runs (see bwd_route); a call is one count
BWD_KERNEL = {torch.float32: "ssd_bwd_su + ssd_bwd_pass + ssd_bwd_chunk + ssd_bwd_heads + ssd_bwd_da (SIMT f32)",
              torch.bfloat16: "ssd_bwd_states + ssd_bwd_passes + ssd_bwd_chunk_mma + ssd_bwd_sums (mma.sync bf16)"}
BWD_LAUNCHES = {torch.float32: 5, torch.bfloat16: 4}  # csrc/ssd_bwd.cu: launches of one call, counted as one
BWD_MAX_CHUNK = 128  # csrc/ssd_bwd.cu: kMaxL
BWD_MAX_NP = 64  # csrc/ssd_bwd.cu: kMaxNP, the largest N and P
BWD_ROADMAP = "ROADMAP queue 1: ssd_scan_bwd above chunk 128 or N, P 64"
BWD_VECS = 11  # csrc/ssd_bwd.cu: kVecs, launch C's per-position f32 vectors
# the bf16 build's scratch, in the order rt_ssd_scan_bwd_mma takes its offsets
BWD_WORK = ("su", "el", "dyp", "ghp", "dbp", "dcp", "dap")


def bwd_route(dtype: torch.dtype) -> str:
    """The backward build a call runs: ``"mma"`` for bf16 inputs (the
    training path's), ``"simt"`` for f32 (the checks and the f32 cuts)."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def _up16(v: int) -> int:
    return -(-v // 16) * 16


def bwd_smem(chunk: int, n: int, p: int) -> Tuple[int, int]:
    """Bytes of shared memory a block of the bf16 build's launch A (the
    chunk states) and C (the chunk terms) takes: ``BwdLayout`` of
    ``csrc/ssd_bwd.cu``, the chunk, N and P padded to 16, bf16 rows 8
    elements past that, C.B^T and D^T as their causal 16 x 16 tiles."""
    lp, np_, pp = _up16(chunk), _up16(n), _up16(p)
    nb = lp // 16
    bc, x, gh = 2 * lp * (np_ + 8), 2 * lp * (pp + 8), 2 * np_ * (pp + 8)
    tiles, vec = 1024 * nb * (nb + 1) // 2, 4 * lp
    return 2 * bc + 3 * x + 4 * vec, 2 * bc + 2 * tiles + 3 * x + 4 * gh + BWD_VECS * vec + 4 * nb * lp + 64


class SsdBwdPlan(NamedTuple):
    """The bf16 build's plan for one call: the padded chunk, N and P; the
    heads a block of launch C takes (:func:`head_group`) and its groups;
    the blocks of launches A, C and D and the threads of B; the shared
    memory of a block of A and of C; and the scratch, each buffer's
    (offset, bytes) in one allocation (256-byte aligned), named by
    :data:`BWD_WORK`, and its total bytes."""

    lp: int
    np: int
    pp: int
    group: int
    groups: int
    state_blocks: int
    pass_threads: int
    chunk_blocks: int
    sum_blocks: int
    state_smem: int
    chunk_smem: int
    work: Tuple[Tuple[int, int], ...]
    work_bytes: int


def bwd_plan(batch: int, s: int, nh: int, chunk: int, n: int, p: int, slots: int) -> SsdBwdPlan:
    """The bf16 build's plan at (batch, S, heads, chunk, N, P), with
    ``slots`` blocks of launch C running at once on the card."""
    if not (1 <= chunk <= BWD_MAX_CHUNK and 1 <= n <= BWD_MAX_NP and 1 <= p <= BWD_MAX_NP):
        raise ValueError(f"ssd_scan_bwd: chunk {chunk}, N {n}, P {p} outside the kernel's build "
                         f"({BWD_ROADMAP})")
    lp, np_, pp = _up16(chunk), _up16(n), _up16(p)
    nc = -(-s // chunk)
    group = head_group(batch, nc, nh, slots)
    groups = -(-nh // group)
    slots_ = batch * nc * nh
    sizes = (4 * slots_ * 2 * np_ * pp, 4 * slots_, 2 * slots_ * 2 * lp * pp, 2 * slots_ * 4 * np_ * pp,
             4 * batch * groups * s * n, 4 * batch * groups * s * n, 4 * slots_)
    work, off = [], 0
    for size in sizes:
        work.append((off, size))
        off += -(-size // 256) * 256
    a_smem, c_smem = bwd_smem(chunk, n, p)
    return SsdBwdPlan(lp, np_, pp, group, groups, nc * nh * batch, batch * nh * np_ * pp,
                      nc * groups * batch, -(-batch * s * n // 256) + 1, a_smem, c_smem, tuple(work), off)


def bwd_launch_plan(batch: int, s: int, nh: int, chunk: int, n: int, p: int, dtype: torch.dtype,
                    slots: int) -> str:
    """A call's launch plan in words (the smoke and the kernel ablation log it)."""
    nc = -(-s // chunk)
    if bwd_route(dtype) == "simt":
        return (f"{BWD_LAUNCHES[dtype]} launches per call: {nc * nh * batch} blocks of the chunk terms "
                f"(512 threads, one head each); per-head partials of dB and dC; f32 FMAs")
    pl = bwd_plan(batch, s, nh, chunk, n, p, slots)
    return (f"{BWD_LAUNCHES[dtype]} launches per call: {pl.state_blocks} state blocks; {pl.pass_threads} "
            f"pass threads; {pl.chunk_blocks} chunk blocks of {pl.group} heads ({pl.groups} groups, "
            f"{pl.chunk_smem} bytes of shared memory each); {pl.sum_blocks} sum blocks; mma.sync bf16, "
            f"inputs as 1 and f32 operands as 2 bf16 terms")


@functools.lru_cache(maxsize=None)
def _bwd_slots(device: torch.device, chunk: int, n: int, p: int) -> int:
    """Blocks of the bf16 build's launch C the card runs at once."""
    with torch.cuda.device(device):
        per_sm = build.library().rt_ssd_bwd_blocks_per_sm(chunk, n, p)
    if per_sm < 1:
        raise RuntimeError(f"ssd_scan_bwd: no block of the chunk kernel fits an SM of {device}")
    return torch.cuda.get_device_properties(device).multi_processor_count * per_sm


def _inner_stride(t: torch.Tensor, name: str) -> None:
    if t.numel() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"ssd_scan_bwd: {name} must have inner stride 1, got {tuple(t.stride())}")


def ssd_scan_bwd(
    xh: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    B_ssm: torch.Tensor,
    C_ssm: torch.Tensor,
    dy: torch.Tensor,
    dh: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_scan` (``csrc/ssd_bwd.cu``): (dxh, ddt, da,
    dB, dC, dh0) for the incoming gradients ``dy`` (B, S, nh, P) of y and
    ``dh`` (B, nh, N, P) of the final state (None: unused), each in its
    input's dtype, dh0 None without ``h0``. Recomputes the forward's states
    from the inputs (no forward variant saves them). Takes chunks up to
    :data:`BWD_MAX_CHUNK` and N, P up to :data:`BWD_MAX_NP`, any S of at
    least one position, and raises beyond. bf16 inputs run the tensor-core
    build (:func:`bwd_plan`), reading every input through its strides and
    writing dx, dB and dC in bf16; f32 inputs the SIMT build. One call is
    :data:`BWD_LAUNCHES` launches, counted once. The plain version is
    :func:`repro_torch.kernels.ref.ssd_scan_bwd_ref`."""
    if xh.dim() != 4:
        raise ValueError(f"ssd_scan_bwd: xh must be (B, S, nh, P), got {tuple(xh.shape)}")
    b, s, nh, p = xh.shape
    n = B_ssm.shape[-1]
    dev = xh.device
    io = (torch.float32, torch.bfloat16)
    f32 = (torch.float32,)
    check_input("ssd_scan_bwd", xh, "xh", (b, s, nh, p), io, dev)
    check_input("ssd_scan_bwd", dt, "dt", (b, s, nh), f32, dev)
    check_input("ssd_scan_bwd", a, "a", (nh,), f32, dev)
    check_input("ssd_scan_bwd", B_ssm, "B", (b, s, n), (xh.dtype,), dev)
    check_input("ssd_scan_bwd", C_ssm, "C", (b, s, n), (xh.dtype,), dev)
    check_input("ssd_scan_bwd", dy, "dy", (b, s, nh, p), f32, dev)
    for name, t in (("dh", dh), ("h0", h0)):
        if t is not None:
            check_input("ssd_scan_bwd", t, name, (b, nh, n, p), f32, dev)
    if not (1 <= chunk <= BWD_MAX_CHUNK and 1 <= n <= BWD_MAX_NP and 1 <= p <= BWD_MAX_NP):
        raise ValueError(f"ssd_scan_bwd: chunk {chunk}, N {n}, P {p} outside the kernel's build "
                         f"({BWD_ROADMAP})")
    if bwd_route(xh.dtype) == "mma":
        return _ssd_scan_bwd_mma(xh, dt, a, B_ssm, C_ssm, dy, dh, int(chunk), h0)
    smem = build.library().rt_ssd_bwd_smem(int(chunk), n, p)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan_bwd: chunk {chunk}, N {n}, P {p} take {smem} bytes of shared "
                         f"memory, above {MAX_SMEM} ({BWD_ROADMAP})")
    f = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, nh, p), **f)
    ddt = torch.empty((b, s, nh), **f)
    da = torch.empty((nh,), **f)
    dB = torch.empty((b, s, n), **f)
    dC = torch.empty((b, s, n), **f)
    dh0 = torch.empty((b, nh, n, p), **f) if h0 is not None else None
    nc = -(-s // chunk)
    hs = torch.empty((b, nh, nc, n, p), **f)
    gs = torch.empty((b, nh, nc, n, p), **f)
    el = torch.empty((b, nh, nc), **f)
    dbp = torch.empty((b, nh, s, n), **f)
    dcp = torch.empty((b, nh, s, n), **f)
    dap = torch.empty((b, nc, nh), **f)
    xh, B_ssm, C_ssm, dt, a, dy = (t.contiguous() for t in (xh, B_ssm, C_ssm, dt, a, dy))
    dh, h0 = (None if t is None else t.contiguous() for t in (dh, h0))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().rt_ssd_scan_bwd(
        xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
        dy.data_ptr(), ptr(dh), ptr(h0), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), ptr(dh0), hs.data_ptr(), gs.data_ptr(), el.data_ptr(),
        dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(),
        b, s, nh, p, n, int(chunk), int(xh.dtype == torch.bfloat16), stream_ptr(xh),
    )
    build.check(err, "ssd_scan_bwd")
    build.count_launch("ssd_scan_bwd")
    return dx.to(xh.dtype), ddt, da, dB.to(B_ssm.dtype), dC.to(B_ssm.dtype), dh0


def _ssd_scan_bwd_mma(xh, dt, a, B_ssm, C_ssm, dy, dh, chunk, h0):
    """The bf16 build: four launches over one scratch allocation, every
    input read through its strides, dx, dB and dC written in bf16."""
    b, s, nh, p = xh.shape
    n = B_ssm.shape[-1]
    dev = xh.device
    for name, t in (("xh", xh), ("B", B_ssm), ("C", C_ssm), ("dy", dy), ("dh", dh), ("h0", h0)):
        if t is not None:
            _inner_stride(t, name)
    pl = bwd_plan(b, s, nh, chunk, n, p, _bwd_slots(dev, chunk, n, p))  # every such shape fits (tests)
    dx = torch.empty((b, s, nh, p), dtype=xh.dtype, device=dev)
    ddt = torch.empty((b, s, nh), dtype=torch.float32, device=dev)
    da = torch.empty((nh,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, n), dtype=B_ssm.dtype, device=dev)
    dC = torch.empty((b, s, n), dtype=B_ssm.dtype, device=dev)
    dh0 = torch.empty((b, nh, n, p), dtype=torch.float32, device=dev) if h0 is not None else None
    work = torch.empty((pl.work_bytes,), dtype=torch.uint8, device=dev)
    state = lambda t: (0, 0, 0) if t is None else t.stride()[:3]  # noqa: E731
    strides = build.strides_arg([
        *xh.stride()[:3], *dt.stride(), *B_ssm.stride()[:2], *C_ssm.stride()[:2], *dy.stride()[:3],
        *state(h0), *state(dh), a.stride(0),
    ])
    offsets = build.strides_arg([off for off, _ in pl.work])
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().rt_ssd_scan_bwd_mma(
        xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(), dy.data_ptr(),
        ptr(dh), ptr(h0), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        ptr(dh0), work.data_ptr(), offsets, strides, b, s, nh, p, n, chunk, pl.group, stream_ptr(xh),
    )
    build.check(err, "ssd_scan_bwd")
    build.count_launch("ssd_scan_bwd")
    return dx, ddt, da, dB, dC, dh0
