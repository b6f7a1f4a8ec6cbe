"""K5 · flash attention (forward) on Hopper (CUDA C++, ``csrc/flash_attention.cu``).

q (B, Sq, H, hd), k/v (B, Sk, KV, hd) with H a multiple of KV: the kernel
reads KV head ``h // (H // KV)`` for q head ``h`` in place, so the GQA
repeat that the reference wrapper materializes (``repro/kernels/ops.py``)
never exists on the card. Online softmax with an f32 accumulator, causal
and sliding-window masks (``k_pos > q_pos - window``), whole tiles past
either frontier skipped. Port of the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention``. The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

bfloat16 runs on the tensor cores: up to head dim 128 ``flash_fwd_wg``
(wgmma bf16 products, K/V tiles through a three-stage cp.async ring,
heaviest q tiles first), at 192 ``flash_fwd_wide`` (a producer warpgroup
keeps K/V tiles in flight by TMA, two consumer warpgroups take turns at the
tensor cores), built at v's own head dim for the pairs in
:data:`WIDE_PAIRS`. float32, which only the checks use, runs the SIMT kernel
(``flash_fwd_simt``). The host plans the tensor-core kernels' work in plain
functions that the CPU tests check: :func:`tile_plan` (the q-tile order and
each tile's K/V range, which the kernels read from the card),
:func:`load_route` and :func:`fwd_smem`.

The kernels are built for the head dims in ``HEAD_DIMS``. Any other head
dim up to the largest runs at the next built one (:func:`padded_head_dim`):
q, k and v are zero-padded along the head dim, the softmax scale stays
that of the true head dim, and the output's padded columns, which are 0,
are sliced off. Zero columns add nothing to q·kᵀ. A built head dim takes
no copy. A head dim above the largest, in f32 or bf16, runs the pieces
kernel (``csrc/attention_pieces.cuh``, :data:`PIECES_KERNEL`), which walks
the head dim in pieces of 64 columns and takes any head dim: :func:`route`
names the kernel a call takes.

A v head dim below q's and k's runs at its own width where the pair is
built, in bfloat16: MLA's (192, 128) by ``flash_fwd_wide``. Any other such
pair, and float32, takes route (a), :func:`attend_padded_value`: v is
zero-padded to q's head dim, the built kernel of that head dim runs with the
scale of q's head dim (or the one given), and the output keeps its first
``hd_v`` columns. The zero columns of v add nothing to P·V; they cost (hd -
hd_v) / hd_v more V bytes read and O bytes written.

Training: ``flash_attention(..., with_lse=True)`` also returns each row's
log-sum-exp of its scaled scores, (B, H, Sq) float32, on route (a) too
(the zero columns of v change neither P nor the log-sum-exp), which
:func:`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``) reads to
form the gradients of q, k and v. The backward is built for the (q/k, v)
head dim pairs in :data:`BWD_HEAD_DIM_PAIRS`: one head dim up to 192, and
MLA's (192, 128), which takes v, o and dO at their own width; any other
pair up to 192 is zero-padded to the next built one (:func:`bwd_widths`).
Above 192 (the pieces route) it raises (:data:`BWD_ROADMAP`). bfloat16 runs
on the tensor cores in the order of :func:`bwd_plan`: up to 128 on
mma.sync, at 192 the wide build on wgmma (``csrc/flash_attention_bwd_wide.cu``,
:func:`bwd_route`); float32 runs SIMT FMAs.
:func:`bwd_smem` gives each build's shared memory a block. Its plain
version is :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build
from ._launch import stream_ptr

HEAD_DIMS = (16, 32, 64, 80, 128, 192)  # 80: zamba2's shared attention block; 192: nemotron-4-340b
BLOCK_Q = 128  # query rows per block of the tensor-core kernel (kTcBQ)
BLOCK_K = 64  # keys per K/V tile (kTcBK)
COPY_BYTES = 16  # one cp.async copy
KERNELS = {
    torch.bfloat16: "flash_fwd_wg (wgmma m64n64k16 / m64nHDk16 bf16, cp.async K/V ring, heavy-first)",
    torch.float32: "flash_fwd_simt (f32 FMAs from shared memory)",
}
# the bf16 build at q/k head dim 192 and the (q/k, v) head dim pairs it is built for
WIDE_PAIRS = ((192, 192), (192, 128))
WIDE_KERNEL = ("flash_fwd_wide (wgmma m64n64k16 / m64nHDVk16 bf16 at v's own head dim; a producer warpgroup's "
               "TMA K/V ring with full/empty mbarriers, two consumer warpgroups in turns; heavy-first)")
BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 192)  # csrc/flash_attention_bwd.cu, q/k and v alike
# the (q/k, v) head dim pairs the C entry takes: one head dim, or MLA's (192, 128)
BWD_HEAD_DIM_PAIRS = tuple((d, d) for d in BWD_HEAD_DIMS) + ((192, 128),)
BWD_BLOCK = 64  # q rows and keys a tile of the backward (kB)
BWD_WIDE = 128  # above this q/k head dim the bf16 build takes the wide dk/dv kernel
BWD_KERNELS = {
    torch.bfloat16: "fa_bwd_dkdv_mma + fa_bwd_dq_mma (mma.sync m16n8k16 bf16, two warp sets a dk/dv block, "
                    "cp.async double buffers, heavy-first)",
    torch.float32: "fa_bwd_dkdv + fa_bwd_dq (f32 FMAs from shared memory)",
}
# bf16 above BWD_WIDE
BWD_WIDE_KERNEL = ("fa_bwd_dkdv_wide + fa_bwd_dq_wide (wgmma bf16: keys as M for S^T and dP^T, P^T and dS^T "
                   "as register A operands of dv and dk; a producer warpgroup's TMA ring; heavy-first)")
BWD_STEP = 32  # q rows a dk/dv step of the wide build (kStep)
BWD_DQ_STEP = 64  # keys a dq step of the wide build (kStepDq)
SMEM_TWO_AN_SM = 115712  # the shared memory a block may take so that two fit an SM (kBudget)
BWD_ROADMAP = ("ROADMAP queue 1: K5's backward above head dim 192 (the pieces route's forward has no "
               "backward kernel)")
SMEM_PER_BLOCK = 232448  # the most shared memory a block may opt in to on the H100
SMEM_PER_SM = 233472  # an SM's shared memory (228 KB), 1 KB of it reserved for each resident block
PIECES_KERNEL = "attention_pieces (SIMT f32 FMAs, head dim in pieces of 64, O in shared memory)"


def wide(dtype: torch.dtype, hd: int, hd_v: int) -> bool:
    """Whether K5 at (``hd``, ``hd_v``) runs ``flash_fwd_wide`` at v's own
    head dim: bfloat16 at a pair of :data:`WIDE_PAIRS`."""
    return dtype == torch.bfloat16 and (hd, hd_v) in WIDE_PAIRS


def route(dtype: torch.dtype, hd: int, hd_v: Optional[int] = None) -> str:
    """The kernel K5 runs for ``dtype`` at head dim ``hd``: the pieces kernel
    above the largest built head dim, the wide build for bfloat16 at 192,
    else the build of the dtype; with a smaller v head dim ``hd_v`` at its
    own width where the pair is built, else through route (a)."""
    hd_v = hd if hd_v is None else hd_v
    if hd_v != hd and wide(dtype, hd, hd_v):
        return WIDE_KERNEL + f" at ({hd}, {hd_v})"
    if hd > HEAD_DIMS[-1]:
        name = PIECES_KERNEL
    else:
        width = padded_head_dim(hd)
        name = WIDE_KERNEL + f" at ({width}, {width})" if wide(dtype, width, width) else KERNELS[dtype]
    if hd_v != hd:
        name += f", route (a): v zero-padded from {hd_v} to {hd}, output sliced"
    return name


def fwd_smem(hd: int, hd_v: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory a block of the forward's build at (``hd``,
    ``hd_v``) takes, the twin of ``csrc/flash_attention.cu:
    rt_flash_attention_smem``: ``flash_fwd_wg`` Q (128 rows) and a
    three-stage K/V ring of 64 keys with 1 KB to align the base;
    ``flash_fwd_wide`` Q, as many stages of K and V as fit a block beside it
    (:func:`fwd_stages`) and 128 bytes of mbarriers; f32 the SIMT kernel's
    q, K, V and P tiles."""
    if wide(dtype, hd, hd_v):
        return 1024 + BLOCK_Q * hd * 2 + fwd_stages(hd, hd_v) * BLOCK_K * (hd + hd_v) * 2 + 128
    if hd != hd_v or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no build at q head dim {hd} and v head dim {hd_v}")
    if dtype == torch.bfloat16:
        return BLOCK_Q * hd * 2 + 2 * 3 * BLOCK_K * hd * 2 + 1024
    return 4 * (2 * 64 * (hd + 1) + 64 * hd + 64 * 65)


def fwd_stages(hd: int, hd_v: int) -> int:
    """The K/V stages of ``flash_fwd_wide``'s TMA ring: what a block's
    shared memory holds beside Q, 1 KB of alignment slack and the barriers."""
    return (SMEM_PER_BLOCK - 1024 - BLOCK_Q * hd * 2 - 128) // (BLOCK_K * (hd + hd_v) * 2)


def fwd_launch_plan(b: int, sq: int, h: int, hd: int, hd_v: int, dtype: torch.dtype, sms: int = 132) -> str:
    """The forward's launch at this shape in words (the smoke logs it), at
    the build the call runs: (``hd``, ``hd_v``) where the wide build takes
    the pair (a block an SM of the card's ``sms``, walking the work items),
    else q, k and v padded to the built head dim (route (a) for a smaller
    v)."""
    if hd > HEAD_DIMS[-1]:
        return f"1 launch of {PIECES_KERNEL}"
    if not wide(dtype, hd, hd_v):
        hd = hd_v = padded_head_dim(hd)
    smem = fwd_smem(hd, hd_v, dtype)
    if wide(dtype, hd, hd_v):
        items = -(-sq // BLOCK_Q) * h * b
        return (f"1 launch at ({hd}, {hd_v}): {min(items, sms)} blocks of 3 warpgroups (a TMA producer at 24 "
                f"registers a thread, 2 consumers of 64 q rows at 240) over {items} items of {BLOCK_Q} q rows "
                f"in snake order, a {fwd_stages(hd, hd_v)}-stage K/V ring of {BLOCK_K} keys, {smem} B of shared "
                f"memory, 1 an SM")
    rows = BLOCK_Q if dtype == torch.bfloat16 else 64
    return f"1 launch at {hd}: {-(-sq // rows) * h * b} blocks of 8 warps, {smem} B of shared memory"


def tile_plan(sq: int, sk: int, causal: bool, window: int,
              block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> List[Tuple[int, int, int]]:
    """(q tile, first key, end key) in the order the tensor-core kernel's
    blocks take the q tiles: block t takes entry ``t // (H * B)``, for head
    ``t % H`` and batch ``t % (H * B) // H``, and visits the K/V tiles from
    the first key in steps of ``block_k`` up to the end key.

    A tile sees keys up to its last row under a causal mask, from the tile
    of the first key inside its first row's window, and none past Sk. Under
    a causal mask the last tiles carry the most work and go first; without
    one a window only drops keys before a tile, so the first tiles go first.
    Along the order the work never rises, with one exception: under a
    causal mask and a window narrower than the prompt, every full q tile
    past the window's width visits the same number of K/V tiles, and a
    ragged last q tile, which goes first, may visit fewer.
    """
    n_qt = -(-sq // block_q)
    plan = []
    for qt in (range(n_qt - 1, -1, -1) if causal else range(n_qt)):
        q_start = qt * block_q
        end = min(sk, q_start + block_q) if causal else sk
        begin = max(0, q_start - window + 1) // block_k * block_k if window > 0 else 0
        plan.append((qt, begin, max(begin, end)))
    return plan


def key_tile_plan(sq: int, sk: int, causal: bool, window: int,
                  block: int = BWD_BLOCK) -> List[Tuple[int, int, int]]:
    """(key tile, first q row, end q row) in the order the backward's dk/dv
    blocks take the key tiles: block t takes entry ``t // (KV * B)``, for
    KV head ``t % KV`` and batch ``t % (KV * B) // KV``, and walks each q
    head of the head's group over the q rows from the first in steps of
    ``block`` up to the end.

    A key tile is seen by q rows from its first key on under a causal mask,
    and up to the row whose window still holds its last key. The tiles go
    heaviest first (the most q tiles walked), ties in key order: under a
    causal mask the first key tiles, which every later q row sees.
    """
    plan = []
    for kt in range(-(-sk // block)):
        j0 = kt * block
        begin = min(j0, sq) if causal else 0
        end = min(sq, min(sk, j0 + block) - 1 + window) if window > 0 else sq
        plan.append((kt, begin, max(begin, end)))
    return sorted(plan, key=lambda e: (-((e[2] - e[1] + block - 1) // block), e[0]))


def bwd_plan(sq: int, sk: int, causal: bool, window: int,
             wide_build: bool = False) -> List[Tuple[int, int, int]]:
    """The bfloat16 backward's plan, as the kernels read it: the dk/dv pass's
    :func:`key_tile_plan` entries, then the dq pass's :func:`tile_plan`
    entries at tiles of :data:`BWD_BLOCK` q rows and keys; for the wide
    build at the forward's q tiles of :data:`BLOCK_Q` rows."""
    return (key_tile_plan(sq, sk, causal, window)
            + tile_plan(sq, sk, causal, window, BLOCK_Q if wide_build else BWD_BLOCK, BWD_BLOCK))


def bwd_widths(hd: int, hd_v: int) -> Tuple[int, int]:
    """The built (q/k, v) head dim pair of :data:`BWD_HEAD_DIM_PAIRS` that a
    backward at (``hd``, ``hd_v``) runs at, ``hd_v <= hd``: q and k padded to
    the next built head dim, v, o and dO to 128 where that is 192 and v's
    fits in 128 (MLA's own build), else to q's. Raises above 192."""
    if hd_v > hd or hd > BWD_HEAD_DIMS[-1]:
        raise NotImplementedError(f"flash_attention_bwd at q head dim {hd} and v head dim {hd_v}: {BWD_ROADMAP}")
    wq = next(w for w in BWD_HEAD_DIMS if w >= hd)
    return wq, (BWD_WIDE if wq > BWD_WIDE and hd_v <= BWD_WIDE else wq)


def bwd_route(dtype: torch.dtype, hd: int, hd_v: Optional[int] = None) -> str:
    """The kernels a backward at (``hd``, ``hd_v``) in ``dtype`` runs, and
    its padding where the pair is not built."""
    hd_v = hd if hd_v is None else hd_v
    wq, wv = bwd_widths(hd, hd_v)
    wide = dtype == torch.bfloat16 and wq > BWD_WIDE
    name = (BWD_WIDE_KERNEL if wide else BWD_KERNELS[dtype]) + f" at ({wq}, {wv})"
    if (wq, wv) != (hd, hd_v):
        name += f", zero-padded from ({hd}, {hd_v})"
    return name


def bwd_smem(hd: int, hd_v: int, dtype: torch.dtype, group: int = 1) -> Tuple[int, int]:
    """Bytes of shared memory a block of the backward's build (``hd``,
    ``hd_v``) takes at a GQA group of ``group`` q heads a KV head: (dk/dv
    kernel, dq kernel). The twin of ``csrc/flash_attention_bwd.cu:
    rt_flash_attention_bwd_smem``: below 192 bf16 tiles of 64 rows of hd + 8
    values, the dk/dv block's two warp sets each double-buffering q and dO
    (with lse and D), the dq block K and V; at 192 the wide build's
    slab-major tiles: the fixed rows of both head dims (the dk/dv block's 64
    keys of K and V, the dq block's 128 q rows of q and dO), a ring of
    :func:`bwd_stages` steps (dk/dv: 32 q rows with their lse and D; dq: 64
    keys, its 128 rows' lse and D once), 1 KB to align the base and 128
    bytes of mbarriers. f32: q, k, v, dO tiles of 64 x (hd + 1) floats,
    P and dS 64 x 65, lse and D."""
    if (hd, hd_v) not in BWD_HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention_bwd: no build at q head dim {hd} and v head dim {hd_v}")
    b = BWD_BLOCK
    if dtype == torch.float32:
        n = 4 * (2 * b * (hd + 1) + 2 * b * (hd_v + 1) + 2 * b * (b + 1) + 2 * b)
        return n, n
    if hd > BWD_WIDE:
        part = BWD_STEP * (hd + hd_v) * 2
        st_dkdv, st_dq = bwd_stages(hd, hd_v, group)
        return (1024 + b * (hd + hd_v) * 2 + st_dkdv * (part + 2 * BWD_STEP * 4) + 128,
                1024 + BLOCK_Q * (hd + hd_v) * 2 + 2 * BLOCK_Q * 4 + st_dq * BWD_DQ_STEP * (hd + hd_v) * 2 + 128)
    tq = b * (hd + 8)
    return 10 * tq * 2 + 8 * b * 4, 6 * tq * 2


def bwd_consumers(group: int) -> int:
    """The consumer warpgroups of the wide build's dk/dv block: two, taking
    the steps in turn, where a KV head has a group of q heads (its key tiles
    walk group x their q steps; the block has the SM), else one (two blocks
    an SM, one's first loads and last stores under the other's products)."""
    return 2 if group > 1 else 1


def bwd_stages(hd: int, hd_v: int, group: int = 1) -> Tuple[int, int]:
    """The ring stages of the wide backward's (dk/dv, dq) blocks: what a
    block's shared memory (:data:`SMEM_PER_BLOCK`; a dk/dv block of one
    consumer, two an SM, :data:`SMEM_TWO_AN_SM`) holds beside the fixed
    tiles, the alignment slack and the barriers."""
    part = BWD_STEP * (hd + hd_v) * 2
    budget = SMEM_PER_BLOCK if bwd_consumers(group) == 2 else SMEM_TWO_AN_SM
    return ((budget - 1024 - BWD_BLOCK * (hd + hd_v) * 2 - 128) // (part + 2 * BWD_STEP * 4),
            (SMEM_PER_BLOCK - 1024 - BLOCK_Q * (hd + hd_v) * 2 - 2 * BLOCK_Q * 4 - 128)
            // (BWD_DQ_STEP * (hd + hd_v) * 2))


def bwd_launch_plan(b: int, sq: int, sk: int, h: int, kv: int, hd: int, hd_v: int,
                    dtype: torch.dtype) -> str:
    """The backward's launches at this shape in words (the smoke logs it):
    blocks, warps, shared memory and blocks an SM of each pass."""
    wq, wv = bwd_widths(hd, hd_v)
    dkdv, dq = bwd_smem(wq, wv, dtype, h // kv)
    n_kt, n_qt = -(-sk // BWD_BLOCK), -(-sq // BWD_BLOCK)
    if dtype == torch.float32:
        return (f"3 launches: D a warp a row; dk/dv {n_kt * kv * b} blocks of 8 warps; dq {n_qt * h * b} "
                f"blocks of 8 warps; {dkdv} B of shared memory a block, 1 an SM; SIMT f32")
    if wq > BWD_WIDE:
        st_dkdv, st_dq = bwd_stages(wq, wv, h // kv)
        two = bwd_consumers(h // kv) == 2
        # blocks an SM: by shared memory, at most what the launch bounds ask
        dkdv_sm = min(SMEM_PER_SM // (dkdv + 1024), 1 if two else 2)
        consumers = "two consumers of 64 keys taking alternate steps" if two else "a consumer of 64 keys"
        return (f"3 launches at ({wq}, {wv}): D and lse 16 threads a row; dk/dv {n_kt * kv * b} blocks of a "
                f"TMA producer warpgroup and {consumers} ({BWD_STEP} q rows a step, a {st_dkdv}-stage ring), "
                f"{dkdv} B, {dkdv_sm} an SM; dq {-(-sq // BLOCK_Q) * h * b} blocks of a producer and two "
                f"consumers of 64 q rows sharing the K/V ring ({BWD_DQ_STEP} keys a step, a {st_dq}-stage ring), "
                f"{dq} B, 1 an SM; wgmma bf16")
    # blocks an SM: by shared memory, at most what the launch bounds ask (1, 2)
    dkdv_sm, dq_sm = min(SMEM_PER_SM // (dkdv + 1024), 1), min(SMEM_PER_SM // (dq + 1024), 2)
    return (f"3 launches at ({wq}, {wv}): D 16 threads a row; dk/dv {n_kt * kv * b} blocks of 8 warps "
            f"(two sets of 4 taking alternate steps), {dkdv} B, {dkdv_sm} an SM; dq {n_qt * h * b} blocks of "
            f"4 warps (K/V double-buffered), {dq} B, {dq_sm} an SM; mma.sync bf16")


@functools.lru_cache(maxsize=256)
def _bwd_plan_on(device: torch.device, sq: int, sk: int, causal: bool, window: int,
                 wide_build: bool = False) -> torch.Tensor:
    """:func:`bwd_plan` as an (n, 3) int32 tensor on ``device``, made once per
    shape (the copy is blocking, so every stream sees it)."""
    plan = bwd_plan(sq, sk, causal, window, wide_build)
    return torch.tensor(plan, dtype=torch.int32).reshape(-1, 3).to(device)


@functools.lru_cache(maxsize=256)
def _plan_on(device: torch.device, sq: int, sk: int, causal: bool, window: int) -> torch.Tensor:
    """:func:`tile_plan` as an (n_qt, 3) int32 tensor on ``device``, made
    once per shape (the copy is blocking, so every stream sees it)."""
    return torch.tensor(tile_plan(sq, sk, causal, window), dtype=torch.int32).to(device)


def load_route(dtype: torch.dtype, elem_bytes: int, ptrs: Sequence[int],
               strides: Sequence[int]) -> str:
    """How the kernel reads q, k and v: ``"simt"`` for float32 (scalar
    loads, any stride), ``"cp.async"`` for bfloat16, whose rows are copied
    in 16-byte pieces, so every base pointer and every (batch, seq, head)
    stride in bytes must be a multiple of 16. Raises on what the kernel
    cannot take."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")
    bad = [p for p in ptrs if p % COPY_BYTES] + [s for s in strides if (s * elem_bytes) % COPY_BYTES]
    if bad:
        raise ValueError(
            "flash_attention: bfloat16 q, k, v need base pointers and (batch, seq, head) "
            f"strides that are multiples of {COPY_BYTES} bytes; got pointers "
            f"{[p % COPY_BYTES for p in ptrs]} mod {COPY_BYTES} and strides {list(strides)}")
    return "cp.async"


def padded_head_dim(hd: int) -> int:
    """The built head dim that a head dim of ``hd`` runs at: ``hd`` itself
    where it is built, else the next built one above it. Raises above the
    largest."""
    for built in HEAD_DIMS:
        if built >= hd:
            return built
    raise ValueError(f"head dim {hd} is above {HEAD_DIMS[-1]}, the largest the kernels are built for")


def pad_head_dim(tensors: Sequence[torch.Tensor], width: int) -> Tuple[torch.Tensor, ...]:
    """``tensors`` zero-padded along their last (head) dim to ``width``; the
    tensors themselves, uncopied, where it is already ``width``."""
    return tuple(t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1])) for t in tensors)


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
                value_below: bool = False) -> None:
    """q (B, ·, H, hd) against k/v (B, S, KV, hd): one CUDA device, one
    float32/bfloat16 dtype, H a multiple of KV, inner stride 1; with
    ``value_below`` v's head dim may be below q's."""
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
    v_fits = v.shape[3] <= hd if value_below else v.shape[3] == hd
    if k.shape[:3] != v.shape[:3] or not v_fits or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{name}: {h} q heads are not a multiple of {k.shape[2]} kv heads")


def attend_padded_value(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None, **kw) -> torch.Tensor:
    """Route (a): attention whose v head dim is below q's and k's, through
    ``attend``, which takes one head dim for q, k and v: v zero-padded to
    q's head dim, the scale that of q's head dim unless one is given, the
    first ``hd_v`` columns of the output kept; with ``with_lse`` the pair
    (output, lse), the lse the padded call's (v's zero columns change
    neither P nor the log-sum-exp)."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    if hd_v > hd:
        raise ValueError(f"flash_attention: v head dim {hd_v} above q's {hd}")
    (vp,) = pad_head_dim((v,), hd)
    o = attend(q, k, vp, scale=hd ** -0.5 if scale is None else scale, **kw)
    if kw.get("with_lse"):
        return o[0][..., :hd_v].contiguous(), o[1]
    return o[..., :hd_v].contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    with_lse: bool = False,
):
    """The output (B, Sq, H, hd_v); with ``with_lse`` (training) the pair
    (output, lse (B, H, Sq) float32), for q head dims up to 192: above, the
    pieces kernel writes no lse."""
    if with_lse and q.shape[-1] > HEAD_DIMS[-1]:
        raise NotImplementedError(f"flash_attention under autograd at q head dim {q.shape[-1]}: the "
                                  f"route is {PIECES_KERNEL}, which writes no lse; {BWD_ROADMAP}")
    hd_v = v.shape[-1]
    if hd_v != q.shape[-1] and not wide(q.dtype, q.shape[-1], hd_v):
        return attend_padded_value(flash_attention, q, k, v, causal=causal, window=window,
                                   scale=scale, with_lse=with_lse)
    check_heads(q, k, v, "flash_attention", value_below=True)
    b, sq, h, hd = q.shape
    if hd > HEAD_DIMS[-1]:
        return _flash_pieces(q, k, v, causal, window, scale)
    width = padded_head_dim(hd)
    if width != hd:
        q, k, v = pad_head_dim((q, k, v), width)
        scale = hd ** -0.5 if scale is None else scale
        out = flash_attention(q, k, v, causal=causal, window=window, scale=scale, with_lse=with_lse)
        if with_lse:
            return out[0][..., :hd].contiguous(), out[1]
        return out[..., :hd].contiguous()
    sk, kv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    load_route(q.dtype, q.element_size(), [t.data_ptr() for t in (q, k, v)], strides)
    scale = float(scale if scale is not None else hd ** -0.5)
    plan = _plan_on(q.device, sq, sk, bool(causal), int(window)).data_ptr() if q.dtype == torch.bfloat16 else 0
    o = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    err = build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), plan,
        lse.data_ptr() if with_lse else None,
        build.strides_arg(strides + list(o.stride()[:3])),
        b, sq, sk, h, kv, hd, hd_v, scale, int(causal), int(window),
        int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "flash_attention")
    build.count_launch("flash_attention")
    return (o, lse) if with_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K5 from its inputs, its output ``o``, its ``lse`` and
    the output's gradient ``do``, by ``csrc/flash_attention_bwd.cu``; each
    in q's dtype and its input's shape. v, o and dO may have a head dim
    ``hd_v`` below q's and k's ``hd``; a pair that is not built is
    zero-padded to the one :func:`bwd_widths` names. Above 192 it raises."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    wq, wv = bwd_widths(hd, hd_v)
    check_heads(q, k, v, "flash_attention_bwd", value_below=True)
    b, sq, h, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if (t.shape[:3] != q.shape[:3] or t.shape[3] != hd_v or t.dtype != q.dtype
                or t.device != q.device or t.stride(3) != 1):
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype} at v's head dim {hd_v} with inner "
                             "stride 1")
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be packed float32 {(b, h, sq)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    scale = float(scale if scale is not None else hd ** -0.5)
    if (wq, wv) != (hd, hd_v):
        dq, dk, dv = flash_attention_bwd(*pad_head_dim((q, k), wq), *pad_head_dim((v, o), wv), lse,
                                         *pad_head_dim((do,), wv), causal=causal, window=window,
                                         scale=scale)
        return dq[..., :hd].contiguous(), dk[..., :hd].contiguous(), dv[..., :hd_v].contiguous()
    sk, kv = k.shape[1], k.shape[2]
    inputs = (q, k, v, o, do)
    load_route(q.dtype, q.element_size(), [t.data_ptr() for t in inputs],
               [s for t in inputs for s in t.stride()[:3]])
    is_bf16 = q.dtype == torch.bfloat16
    wide_build = is_bf16 and hd > BWD_WIDE
    plan = _bwd_plan_on(q.device, sq, sk, bool(causal), int(window), wide_build).data_ptr() if is_bf16 else None
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    # D (the wide build: lse log2 e and D, rows padded to a whole q tile)
    rows = (2, b, h, -(-sq // BLOCK_Q) * BLOCK_Q) if wide_build else (b, h, sq)
    dsum = torch.empty(rows, dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    err = build.library().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), plan, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), build.strides_arg(strides),
        b, sq, sk, h, kv, hd, hd_v, scale, int(causal), int(window), int(is_bf16), stream_ptr(q),
    )
    build.check(err, "flash_attention_bwd")
    build.count_launch("flash_attention_bwd")
    return dq, dk, dv


def _flash_pieces(q, k, v, causal, window, scale) -> torch.Tensor:
    """K5 above the built head dims: the pieces kernel, f32 or bf16, any
    strides with inner stride 1."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    scale = float(scale if scale is not None else hd ** -0.5)
    err = build.library().rt_flash_attention_pieces(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        build.strides_arg(strides + list(o.stride()[:3])),
        b, sq, sk, h, kv, hd, scale, int(causal), int(window),
        int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    build.check(err, "flash_attention")
    build.count_launch("flash_attention")
    return o
