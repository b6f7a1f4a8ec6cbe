"""The chunked mLSTM scan on Hopper (CUDA C++, ``csrc/mlstm.cu``): a kernel
of the ssm family's path at the reference's ``kernel_mlstm_scan`` region,
not a port of a Pallas kernel (the reference leaves the scan to XLA).

q/k/v (B, S, nh, P) float32 or bfloat16 (one dtype, copied to packed if
they are not), the gates' pre-activations ĩ, f̃ (B, S, nh) in any float
dtype and layout (taken to packed float32 here: B·S·nh values), an
optional state (C (B, nh, P, P), n (B, nh, P), m (B, nh)) float32. Returns
y (B, S, nh, P) and the final (C, n, m), all float32. Any S (the ragged last chunk is masked), any chunk and any P,
on one of two routes (:func:`route`, a plain function of P, the chunk and
the dtype):

* ``"tensor cores"`` (``csrc/mlstm.cu``), for chunks up to
  :data:`MAX_CHUNK` and P up to :data:`MAX_P` where :func:`rows_per_block`
  fits a block: three launches per call (:data:`LAUNCHES`, counted as one
  call): the intra-chunk part, a block per (chunk, head, batch); n and
  n·q, a block per (:data:`N_COLS` columns, :data:`GROUP` chunks, head,
  batch); then the part that carries C, a block per (tile of
  :func:`rows_per_block` rows of C, head, batch).
* ``"general"`` (``csrc/mlstm_general.cu``), for every other shape: six
  launches of f32 FMAs (:data:`GENERAL_LAUNCHES`), C tiled in rows and
  columns with C·q's per-column-tile partials summed in a fixed order, a
  chunk of any length under its one stabilizer.

The plain version is :func:`repro_torch.kernels.ref.mlstm_scan_ref`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from ._launch import check_input, stream_ptr
from .ref import MlstmState

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_CHUNK = 64  # csrc/mlstm.cu: kMaxChunk
ROWS = (32, 16)  # rows of C a block of the third launch may hold, most first
N_COLS = 128  # csrc/mlstm.cu: kNCols, columns of n a block of the second launch owns
GROUP = 4  # csrc/mlstm.cu: kGroup, chunks a block of the second launch forms n·q for
MAX_P = 24 * N_COLS  # csrc/mlstm.cu: kMaxNBlocks column blocks
INFO = 3 * MAX_CHUNK + 2  # csrc/mlstm.cu: kInfo
LAUNCHES = 3
GENERAL_LAUNCHES = 6
GENERAL_COLS = 128  # csrc/mlstm_general.cu: kNCols = kCCols, columns of n and of C a block


def terms(dtype: torch.dtype) -> Tuple[int, int, int]:
    """csrc/mlstm.cu: Cfg. bf16 terms of an input (q, k, v) and of an
    operand the kernel forms in float32 (W, C, v·to_end), and the columns of
    a staged tile of q and k in the third launch: (1, 2, 128) for bf16
    inputs, (3, 3, 64) for float32."""
    return (1, 2, 128) if dtype == torch.bfloat16 else (3, 3, 64)


def carry_smem(p: int, tp: int, dtype: torch.dtype) -> int:
    """csrc/mlstm.cu: carry_smem, bytes of shared memory of a block of the
    third launch: the float32 C tile (columns padded to whole tiles, plus
    8), the C columns a tile reads as bf16 terms, the q and k tiles,
    v·to_end's terms and a chunk's 130 floats."""
    t_in, t_op, tile = terms(dtype)
    cp = -(-p // tile) * tile + 8
    tile_bytes = lambda rows: rows * (tile + 8) * 2  # noqa: E731
    return (4 * tp * cp + t_op * tile_bytes(tp) + 2 * t_in * tile_bytes(MAX_CHUNK)
            + t_op * MAX_CHUNK * (tp + 8) * 2 + 4 * (2 * MAX_CHUNK + 2))


def rows_per_block(p: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Rows of C (its value index) a block of the third launch keeps in
    shared memory: 32 where they fit, else 16."""
    if p > MAX_P:
        raise ValueError(f"mlstm_scan: P = {p} above {MAX_P}")
    for tp in ROWS:
        if carry_smem(p, tp, dtype) <= MAX_SMEM:
            return tp
    raise ValueError(f"mlstm_scan: {ROWS[-1]} rows of C at P = {p} do not fit a block")


def route(p: int, chunk: int, dtype: torch.dtype) -> str:
    """``"tensor cores"`` where the chunk is at most :data:`MAX_CHUNK` and
    :func:`rows_per_block` fits P, else ``"general"``."""
    if chunk <= MAX_CHUNK and p <= MAX_P and any(
            carry_smem(p, tp, dtype) <= MAX_SMEM for tp in ROWS):
        return "tensor cores"
    return "general"


def n_blocks(p: int) -> int:
    """Column blocks of n per (head, batch) in the second launch: one per
    128 columns."""
    return -(-p // N_COLS)


def launch_plan(b: int, s: int, nh: int, p: int, chunk: int, dtype: torch.dtype) -> str:
    """A call's launch plan in words (the smoke and the kernel ablation log it)."""
    if route(p, chunk, dtype) == "general":
        nc, tiles, cols = -(-s // chunk), -(-chunk // 64), -(-p // GENERAL_COLS)
        return (f"general route, {GENERAL_LAUNCHES} launches per call: {nh * b} gate warps; "
                f"{nc * tiles * (tiles + 1) // 2 * nh * b} W tiles of 64 x 64; "
                f"{nc * tiles * -(-p // 64) * nh * b} W.v tiles; {cols * nh * b} blocks for n; "
                f"{-(-p // 32) * cols * nh * b} blocks of 32 x {GENERAL_COLS} of C; "
                f"{s * nh * b} output rows; f32 FMAs")
    t_in, t_op, tile = terms(dtype)
    tp, nc = rows_per_block(p, dtype), -(-s // chunk)
    return (f"{LAUNCHES} launches per call: {nc * nh * b} chunk blocks; "
            f"{n_blocks(p) * max(1, -(-nc // GROUP)) * nh * b} blocks for n ({N_COLS} columns x "
            f"{GROUP} chunks each); {-(-p // tp) * nh * b} blocks of {tp} rows of C over tiles of "
            f"{tile} columns; mma.sync bf16, inputs as {t_in} and f32 operands as {t_op} bf16 "
            f"term(s)")


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
    if chunk < 1:
        raise ValueError(f"mlstm_scan: chunk = {chunk} below 1")
    general = route(p, chunk, q.dtype) == "general"
    tp = 0 if general else rows_per_block(p, q.dtype)
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
    nc = -(-s // chunk)
    if general:
        return _general(q, k, v, ig, fg, init, y, (C, n, m), chunk)
    info = torch.empty((b, nh, nc, INFO), dtype=torch.float32, device=dev)
    dn = torch.empty((b, nh, nc, p), dtype=torch.float32, device=dev)
    nq = torch.empty((n_blocks(p), b, nh, nc, MAX_CHUNK), dtype=torch.float32, device=dev)
    # 16-byte loads of q, k and v where every row starts on 16 bytes
    per16 = 16 // q.element_size()
    vec = p % per16 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    err = build.library().rt_mlstm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(), fg.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in init),
        y.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(), info.data_ptr(), dn.data_ptr(),
        nq.data_ptr(),
        b, s, nh, p, int(chunk), tp, int(q.dtype == torch.bfloat16), int(vec), stream_ptr(q),
    )
    build.check(err, "mlstm_scan")
    build.count_launch("mlstm_scan")
    return y, (C, n, m)


def _general(q, k, v, ig, fg, init, y, final, chunk: int) -> Tuple[torch.Tensor, MlstmState]:
    """The general route (csrc/mlstm_general.cu) into ``y`` and ``final``."""
    b, s, nh, p = q.shape
    dev = q.device
    nc, cols = -(-s // chunk), -(-p // GENERAL_COLS)
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.empty((b * nh, s, 4), **f32)
    cinfo = torch.empty((b * nh, nc, 3), **f32)
    w = torch.empty((b * nh, nc, chunk, chunk), **f32)
    nq = torch.empty((cols, b * nh, s), **f32)
    cq = torch.empty((cols, b * nh, s, p), **f32)
    err = build.library().rt_mlstm_scan_general(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(), fg.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in init),
        y.data_ptr(), *(t.data_ptr() for t in final), pos.data_ptr(), cinfo.data_ptr(),
        w.data_ptr(), nq.data_ptr(), cq.data_ptr(),
        b, s, nh, p, int(chunk), int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "mlstm_scan")
    build.count_launch("mlstm_scan")
    return y, final


BWD_KERNEL = ("mlstm_bwd_gates + nsum + intra + walk + state (mma.sync bf16, f32 operands as bf16 "
              "terms) + final")
BWD_LAUNCHES = 6  # csrc/mlstm_bwd.cu: launches of one call, counted as one
BWD_TILE = 64  # csrc/mlstm_bwd.cu: kT = kW, the longest chunk, the tile of P and of the states
BWD_STAGES = 3  # csrc/mlstm_bwd.cu: kStages, the state launch's ring of copies


class MlstmBwdPlan(NamedTuple):
    """The backward's tile plan, a plain function of (P, chunk, dtype):
    ``pp`` P padded to whole 64-column tiles (the term planes' width);
    ``terms`` the bf16 terms of an input and of an f32 operand; ``kt``
    columns of P a step of the state launch takes; ``walk_blocks`` and
    ``state_blocks`` per (head, batch) at S of ``nc`` chunks;
    ``intra_smem``, ``walk_smem`` and ``state_smem`` bytes of shared memory
    a block of launches 3, 4 and 5 takes."""

    pp: int
    terms: Tuple[int, int]
    kt: int
    walk_blocks: int
    state_blocks: int
    intra_smem: int
    walk_smem: int
    state_smem: int


def bwd_plan(p: int, chunk: int, dtype: torch.dtype, nc: int = 1) -> MlstmBwdPlan:
    """csrc/mlstm_bwd.cu's sizes: the in-chunk launch's f32 tiles and bf16
    term tiles; 64 x 64 tiles of C and of G (two walks) and a block a
    thread's worth of n's columns; the state launch a block
    per 64 columns and chunk, stepping over P by 32 columns (bf16 inputs)
    or 16 (f32) through a ring of :data:`BWD_STAGES` stages."""
    if not 1 <= chunk <= BWD_TILE:
        raise ValueError(f"mlstm_scan_bwd: chunk {chunk} outside [1, {BWD_TILE}] (ROADMAP queue 1)")
    t_in, t_op, _ = terms(dtype)
    kt = 32 if dtype == torch.bfloat16 else 16
    tw = BWD_TILE + 8  # a staged row of a 64-wide tile, bf16
    tiles = -(-p // BWD_TILE)
    stage = (3 * t_in + t_op) * BWD_TILE * (kt + 8) + 2 * t_op * BWD_TILE * (kt + 8) + 2 * t_op * kt * tw
    tile_f32 = BWD_TILE * (BWD_TILE + 1)  # an f32 tile of launch 3, rows padded by one
    return MlstmBwdPlan(
        pp=tiles * BWD_TILE, terms=(t_in, t_op), kt=kt,
        walk_blocks=2 * tiles * tiles + -(-p // 256), state_blocks=tiles * nc,
        intra_smem=4 * (3 * tile_f32 + 10 * BWD_TILE)
        + 2 * BWD_TILE * tw * max(3 * t_in + t_op, 3 * t_op + 2 * t_in),
        walk_smem=2 * BWD_TILE * tw * (4 * t_op + 2 * t_in) + 4 * 2 * BWD_TILE,
        state_smem=BWD_STAGES * 2 * stage + 4 * (2 * BWD_TILE + 2 * 4 * BWD_TILE + 256))


def bwd_launch_plan(b: int, s: int, nh: int, p: int, chunk: int, dtype: torch.dtype) -> str:
    """The backward's launch plan in words (the smoke and the kernel ablation log it)."""
    nc = -(-s // chunk)
    pl = bwd_plan(p, chunk, dtype, nc)
    tiles = pl.pp // BWD_TILE
    return (f"{BWD_LAUNCHES} launches per call: {nc * nh * b} chunk blocks; {pl.walk_blocks * nh * b} walk "
            f"blocks ({tiles * tiles} tiles of 64 x 64 each for C and G, {pl.walk_blocks - 2 * tiles * tiles} "
            f"for n); {pl.state_blocks * nh * b} state blocks of 64 columns stepping by {pl.kt}; mma.sync bf16, "
            f"inputs as {pl.terms[0]} and f32 operands as {pl.terms[1]} bf16 term(s)")


def mlstm_scan_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,
    f_gate: torch.Tensor,
    y: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[Tuple[Optional[torch.Tensor], ...]] = None,
    *,
    chunk: int = 64,
    state: Optional[MlstmState] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of :func:`mlstm_scan` (``csrc/mlstm_bwd.cu``): (dq, dk,
    dv, dĩ, df̃, dC0, dn0, dm0) for the forward's inputs, its output ``y``
    and the incoming gradients ``dy`` of y and ``dstate`` = (dC, dn, dm) of
    the final state (None, or None entries, where unused); each in its
    input's dtype, the state's None without ``state``. Recomputes the
    states before each chunk (P x P values a chunk, head and batch, twice:
    C and its gradient, as bf16 term planes: :func:`bwd_plan`). Takes
    chunks up to :data:`BWD_TILE` (every chunk the forward's tensor route
    takes), any P and any S of at least one position; raises beyond. One
    call is :data:`BWD_LAUNCHES` launches, counted once. The plain version is
    :func:`repro_torch.kernels.ref.mlstm_scan_bwd_ref`."""
    if q.dim() != 4:
        raise ValueError(f"mlstm_scan_bwd: q must be (B, S, nh, P), got {tuple(q.shape)}")
    b, s, nh, p = q.shape
    dev = q.device
    io = (torch.float32, torch.bfloat16)
    f32 = (torch.float32,)
    floats = (torch.float32, torch.bfloat16, torch.float16)
    check_input("mlstm_scan_bwd", q, "q", (b, s, nh, p), io, dev)
    for name, t in (("k", k), ("v", v)):
        check_input("mlstm_scan_bwd", t, name, (b, s, nh, p), (q.dtype,), dev)
    for name, t in (("i_gate", i_gate), ("f_gate", f_gate)):
        check_input("mlstm_scan_bwd", t, name, (b, s, nh), floats, dev)
    for name, t in (("y", y), ("dy", dy)):
        check_input("mlstm_scan_bwd", t, name, (b, s, nh, p), f32, dev)
    shapes = ((b, nh, p, p), (b, nh, p), (b, nh))
    ds = tuple(dstate) if dstate is not None else (None,) * 3
    for name, t, shape in zip(("dC", "dn", "dm"), ds, shapes):
        if t is not None:
            check_input("mlstm_scan_bwd", t, name, shape, f32, dev)
    if state is not None:
        for name, t, shape in zip("Cnm", state, shapes):
            check_input("mlstm_scan_bwd", t, name, shape, f32, dev)
    nc, nt = -(-s // chunk), -(-p // BWD_TILE)
    pl = bwd_plan(p, chunk, q.dtype, nc)  # raises for a chunk outside [1, BWD_TILE]
    f = dict(dtype=torch.float32, device=dev)
    d0 = tuple(torch.empty(shape, **f) for shape in shapes) if state is not None else (None,) * 3
    grads = tuple(torch.empty((b, s, nh, p), **f) for _ in range(3)) + tuple(
        torch.empty((b, s, nh), **f) for _ in range(2))
    sl = nc * chunk
    pos = torch.empty((b, nh, 4, sl), **f)
    cinf = torch.empty((b, nh, nc, 4), **f)
    dnb = torch.empty((b, nh, nc, p), **f)
    nb = torch.empty((b, nh, nc, p), **f)
    pos2 = torch.empty((b, nh, 5, sl), **f)
    dmi = torch.empty((b, nh, nc), **f)
    t_in, t_op = pl.terms
    bf = dict(dtype=torch.bfloat16, device=dev)
    cpl = torch.empty((b, nh, nc, t_op, pl.pp, pl.pp), **bf)  # C before each chunk, as bf16 terms
    gpl = torch.empty((b, nh, nc, t_op, pl.pp, pl.pp), **bf)  # G after each chunk
    inpl = torch.empty((b, nh, 3 * t_in + t_op, sl, pl.pp), **bf)  # q, k, v, dy as bf16 terms
    un = torch.empty((b, nh, nc, p), **f)
    part = torch.empty((b, nh, nc, nt, 2, BWD_TILE), **f)
    pdec = torch.empty((b, nh, nc, nt), **f)
    cg = torch.empty((b, nh, nc + 1, 4), **f)
    q, k, v, y, dy = (t.contiguous() for t in (q, k, v, y, dy))
    ig, fg = i_gate.float().contiguous(), f_gate.float().contiguous()
    init = tuple(t.contiguous() for t in state) if state is not None else (None,) * 3
    ds = tuple(None if t is None else t.contiguous() for t in ds)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().rt_mlstm_scan_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(), fg.data_ptr(), y.data_ptr(),
        dy.data_ptr(), *(ptr(t) for t in init), *(ptr(t) for t in ds),
        *(t.data_ptr() for t in grads), *(ptr(t) for t in d0),
        *(t.data_ptr() for t in (pos, cinf, dnb, nb, pos2, dmi, cpl, gpl, inpl, un, part, pdec, cg)),
        b, s, nh, p, int(chunk), int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "mlstm_scan_bwd")
    build.count_launch("mlstm_scan_bwd")
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, i_gate, f_gate))) + d0


