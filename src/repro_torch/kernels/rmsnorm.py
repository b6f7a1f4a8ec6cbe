"""K1 · row-wise RMSNorm and K4 · RMSNorm after a residual add, on Hopper
(CUDA C++, ``csrc/rmsnorm.cu``).

K1: y = x·rsqrt(mean(x²)+eps)·scale with float32 math, output in x's dtype
(float32 or bfloat16). Port of the Pallas kernel
``repro/kernels/rmsnorm.py:rmsnorm``. Narrow rows (D ≤ 8, the stream
path's (B, 5) event batches) run one thread per row; model widths run a
group of threads per row that holds the row in registers; rows too wide
for that run one block per row in two passes. :func:`row_plan` picks the
route, which the wrapper passes to the kernel. The plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`.

K4: h = x + res in float32, y = rmsnorm(h)·scale; returns (y, h), both in
x's dtype. Port of ``repro/kernels/rmsnorm.py:rmsnorm_residual``; the same
template as K1 with a second input and output. The plain version is
:func:`repro_torch.kernels.ref.rmsnorm_residual_ref`.

:func:`rmsnorm_bwd` is the gradient of both, for training
(``csrc/rmsnorm_bwd.cu``: K1's register route, each row read once, then a
parallel fixed-order dscale sum; :func:`bwd_plan`); its plain versions are
:func:`repro_torch.kernels.ref.rmsnorm_bwd_ref` and
:func:`~repro_torch.kernels.ref.rmsnorm_residual_bwd_ref`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import build
from ._launch import rows_of, scale_of, stream_ptr

NARROW_D = 8  # csrc/common.cuh: kNarrowD
CHUNK_BYTES = 16  # one vector load or store
MAX_ROW_CHUNKS = 4  # 16-byte chunks one thread of the register route holds (kMaxRowChunks)
MAX_ROW_THREADS = 512  # threads per row of the register route (kMaxRowThreads)
TWO_PASS_THREADS = 256  # the two-pass route's block (kRowThreads)
ROUTES = ("narrow", "registers", "two-pass")  # the kernel's route numbers 0, 1, 2


class RowPlan(NamedTuple):
    """How the row kernels (K1, K3, K4) take rows of ``d`` values.

    ``route`` is one of :data:`ROUTES`; on the register route a group of
    ``threads`` threads per row (a power of two) holds the row as 16-byte
    chunks, at most ``chunks`` per thread (chunk ``t + c·threads`` in thread
    ``t``), and ``vector`` says whether the rows are read and written 16
    bytes at a time or one value at a time. The sum of squares runs in an
    order fixed by ``(d, route, threads, chunks)``: ``vector`` never changes
    it.
    """

    route: str
    threads: int
    chunks: int
    vector: bool

    def args(self) -> Tuple[int, int, int, int]:
        """The plan as the kernels' C entry points take it."""
        return ROUTES.index(self.route), self.threads, self.chunks, int(self.vector)


def row_plan(d: int, elem_size: int, aligned: bool) -> RowPlan:
    """The route for rows of ``d`` values of ``elem_size`` bytes.

    Up to :data:`NARROW_D` values, one thread per row. Else the row is
    ``n = ⌈d·elem_size / 16⌉`` 16-byte chunks: up to 32 chunks (512 bytes,
    a head dim of 128 in float32 or bfloat16), one chunk per thread and a
    group of ``n`` threads rounded up to a power of two, several rows to a
    warp; beyond that the fewest threads, at least a warp and a power of
    two, that hold the row at :data:`MAX_ROW_CHUNKS` chunks each, up to
    :data:`MAX_ROW_THREADS`; wider rows take the two-pass route. At 2560
    and 5120 bf16 values that is 128 and 256 threads of 3 chunks: of the
    plans ``scripts/torch_row_bench.py --plans`` times there, the fastest
    for K4 (PERF.md has the readings).
    ``aligned`` says whether the rows' base pointers and strides (those of
    every input and of the gains) are multiples of 16 bytes; the register
    route then reads and writes whole chunks if the packed output rows
    (``d·elem_size`` bytes) are too.
    """
    if d <= NARROW_D:
        return RowPlan("narrow", 1, 1, False)
    per = CHUNK_BYTES // elem_size  # values per chunk
    n = -(-d // per)
    if n <= 32:
        threads = 1 << (n - 1).bit_length()
    else:
        threads = max(32, 1 << (-(-n // MAX_ROW_CHUNKS) - 1).bit_length())
        if threads > MAX_ROW_THREADS:
            return RowPlan("two-pass", TWO_PASS_THREADS, 1, False)
    vector = aligned and (d * elem_size) % CHUNK_BYTES == 0
    return RowPlan("registers", threads, -(-n // threads), vector)


def aligned_rows(ptrs: Sequence[int], strides: Sequence[int], elem_size: int) -> bool:
    """Whether every base pointer and every row stride (in elements of
    ``elem_size`` bytes) is a multiple of 16 bytes."""
    return (all(p % CHUNK_BYTES == 0 for p in ptrs)
            and all((s * elem_size) % CHUNK_BYTES == 0 for s in strides))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x2, rows, d, stride = rows_of(x, "x", (torch.float32, torch.bfloat16))
    g = scale_of(scale, x, d)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    el = x.element_size()
    plan = row_plan(d, el, aligned_rows((x2.data_ptr(), g.data_ptr()), (stride,), el))
    lib = build.library()
    err = lib.rt_rmsnorm(
        x2.data_ptr(), stride, g.data_ptr(), y.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), *plan.args(), stream_ptr(x),
    )
    build.check(err, "rmsnorm")
    build.count_launch("rmsnorm")
    return y.reshape(x.shape)


def rmsnorm_residual(
    x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    x2, rows, d, stride = rows_of(x, "x", (torch.float32, torch.bfloat16))
    r2, r_rows, r_d, r_stride = rows_of(res, "res", (x.dtype,))
    if (r_rows, r_d) != (rows, d):
        raise ValueError(f"res has shape {tuple(res.shape)}, x {tuple(x.shape)}")
    g = scale_of(scale, x, d)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    added = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    el = x.element_size()
    plan = row_plan(d, el, aligned_rows((x2.data_ptr(), r2.data_ptr(), g.data_ptr()),
                                        (stride, r_stride), el))
    lib = build.library()
    err = lib.rt_rmsnorm_residual(
        x2.data_ptr(), stride, r2.data_ptr(), r_stride, g.data_ptr(), y.data_ptr(),
        added.data_ptr(), rows, d, float(eps), int(x.dtype == torch.bfloat16), *plan.args(),
        stream_ptr(x),
    )
    build.check(err, "rmsnorm_residual")
    build.count_launch("rmsnorm_residual")
    return y.reshape(x.shape), added.reshape(x.shape)


BWD_SMEM = 98304  # bytes of shared memory a block of the two-pass route's row launch may take
BWD_MAX_BLOCKS = 1024  # blocks of the row launch, at most
BWD_WARPS = 8  # warps of a 256-thread block
BWD_MAX_THREADS = 256  # threads a row of the register route (csrc/rmsnorm_bwd.cu: kThreads)
BWD_ROWS_PER_GROUP = 4  # rows a group takes before the grid grows


class BwdPlan(NamedTuple):
    """How ``csrc/rmsnorm_bwd.cu`` takes ``rows`` rows of ``d`` values.

    ``row`` is the row launch's route: K1's register route (``row_plan``'s
    group of threads a row and chunks a thread), or the two-pass route, a
    warp a row. A block of 256 threads takes ``groups`` rows at once (256 /
    ``row.threads`` groups, or warps); block ``b``'s group ``w`` takes rows
    ``b·groups + w + i·blocks·groups`` for ``i < iters`` and keeps its
    columns' dscale partials over them. The blocks' partials, ``blocks``
    rows of ``d``, are summed by columns in 32 chains, each over every 32nd
    block in block order, then a fixed tree over the chains. Every sum's
    order is a function of the plan, which is a function of the shape (and
    of the alignment, which picks only the load route).
    """

    row: RowPlan
    groups: int
    blocks: int
    iters: int

    def args(self) -> Tuple[int, ...]:
        """The plan as ``rt_rmsnorm_bwd`` takes it."""
        return (*self.row.args(), self.groups, self.blocks, self.iters)


def bwd_plan(rows: int, d: int, elem_size: int, aligned: bool) -> BwdPlan:
    """The plan of ``csrc/rmsnorm_bwd.cu`` for ``rows`` rows of ``d`` values of
    ``elem_size`` bytes (``aligned`` as :func:`row_plan` takes it).

    The register route where :func:`row_plan` gives it with at most
    :data:`BWD_MAX_THREADS` threads a row (narrow rows: one thread of one or
    two chunks); else the two-pass route, a warp a row, with as many of a
    block's 8 warps as fit ``d`` floats of partials each in :data:`BWD_SMEM`
    bytes. Then as many blocks as give each group
    :data:`BWD_ROWS_PER_GROUP` rows, up to :data:`BWD_MAX_BLOCKS`. Raises
    where one warp's partials do not fit a block's 227 KB.
    """
    row = row_plan(d, elem_size, aligned)
    if row.route == "narrow":
        row = RowPlan("registers", 1, -(-d * elem_size // CHUNK_BYTES), False)
    if row.route == "registers" and row.threads <= BWD_MAX_THREADS:
        groups = TWO_PASS_THREADS // row.threads
    else:
        row = RowPlan("two-pass", TWO_PASS_THREADS, 1, False)
        groups = min(BWD_WARPS, BWD_SMEM // (4 * d))
        if groups < 1:
            if 4 * d > 232448:
                raise ValueError(f"rmsnorm_bwd: rows of {d} values do not fit a block's shared memory")
            groups = 1
    blocks = max(1, min(BWD_MAX_BLOCKS, -(-rows // (groups * BWD_ROWS_PER_GROUP))))
    return BwdPlan(row, groups, blocks, -(-rows // (blocks * groups)))


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
                res: Optional[torch.Tensor] = None,
                gh: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of K1 (``res`` None) or K4 (``res`` given, and ``gh``,
    the incoming gradient of h, where there is one) by
    ``csrc/rmsnorm_bwd.cu``: returns (dx, dscale); for K4 dx is also dres.
    dx in x's dtype and shape, dscale float32 (d,)."""
    x2, rows, d, stride = rows_of(x, "x", (torch.float32, torch.bfloat16))
    r_ptr, r_stride = None, 0
    if res is not None:
        r2, r_rows, r_d, r_stride = rows_of(res, "res", (x.dtype,))
        if (r_rows, r_d) != (rows, d):
            raise ValueError(f"res has shape {tuple(res.shape)}, x {tuple(x.shape)}")
        r_ptr = r2.data_ptr()
    packed = []
    for name, t in (("g", g), ("gh", gh)):
        if t is None:
            packed.append(None)
            continue
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"rmsnorm_bwd: {name} {tuple(t.shape)} {t.dtype} does not match x "
                             f"{tuple(x.shape)} {x.dtype}")
        packed.append(t.contiguous())
    g, gh = packed
    sc = scale_of(scale, x, d)
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx.reshape(x.shape), dscale.zero_()
    ptrs = [t.data_ptr() for t in (x2, g, gh, sc, dx) if t is not None] + ([r_ptr] if res is not None else [])
    el = x.element_size()
    plan = bwd_plan(rows, d, el, aligned_rows(ptrs, (stride, r_stride), el))
    part = torch.empty((plan.blocks, d), dtype=torch.float32, device=x.device)
    err = build.library().rt_rmsnorm_bwd(
        x2.data_ptr(), stride, r_ptr, r_stride, g.data_ptr(), gh.data_ptr() if gh is not None else None,
        sc.data_ptr(), dx.data_ptr(), part.data_ptr(), dscale.data_ptr(), rows, d, float(eps),
        *plan.args(), int(x.dtype == torch.bfloat16), stream_ptr(x),
    )
    build.check(err, "rmsnorm_bwd")
    build.count_launch("rmsnorm_bwd")
    return dx.reshape(x.shape), dscale
