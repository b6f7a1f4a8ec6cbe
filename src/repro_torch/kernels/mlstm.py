"""The chunked mLSTM scan on Hopper (CUDA C++, ``csrc/mlstm.cu``): a kernel
of the ssm family's path at the reference's ``kernel_mlstm_scan`` region,
not a port of a Pallas kernel (the reference leaves the scan to XLA).

q/k/v (B, S, nh, P) float32 or bfloat16 (one dtype, copied to packed if
they are not), the gates' pre-activations ĩ, f̃ (B, S, nh) in any float
dtype and layout (taken to packed float32 here: B·S·nh values), an
optional state (C (B, nh, P, P), n (B, nh, P), m (B, nh)) float32. Returns
y (B, S, nh, P) and the final (C, n, m), all float32. Any S: the ragged
last chunk is masked; chunks up to :data:`MAX_CHUNK`, P up to
:data:`MAX_P`. Three launches per call (:data:`LAUNCHES`, counted as one
call): the intra-chunk part, a block per (chunk, head, batch); n and n·q,
a block per (:data:`N_COLS` columns, :data:`GROUP` chunks, head, batch); then the part
that carries C, a block per (tile of :func:`rows_per_block` rows of C,
head, batch). The plain version is
:func:`repro_torch.kernels.ref.mlstm_scan_ref`.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def n_blocks(p: int) -> int:
    """Column blocks of n per (head, batch) in the second launch: one per
    128 columns."""
    return -(-p // N_COLS)


def launch_plan(b: int, s: int, nh: int, p: int, chunk: int, dtype: torch.dtype) -> str:
    """A call's launch plan in words (the smoke and the kernel ablation log it)."""
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
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mlstm_scan: chunk = {chunk} outside [1, {MAX_CHUNK}]")
    tp = rows_per_block(p, q.dtype)
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
