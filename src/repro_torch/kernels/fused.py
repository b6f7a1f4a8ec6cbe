"""K2 · ``map_chain`` and K3 · ``affine_rmsnorm`` on Hopper (``csrc/fused.cu``).

The multi-op kernels of planner-fused segment chains, ports of the Pallas
kernels ``repro/kernels/fused.py:map_chain`` and ``:affine_rmsnorm``:

  * ``map_chain`` — x ← x·s + o for each (s, o) stage in order, one read
    and one write (a ``senml_parse`` run);
  * ``affine_rmsnorm`` — the same stages, then K1's row norm on the result
    in registers (``senml_parse* → rmsnorm``).

The stages are applied one after another and every product and sum is
rounded, never collapsed into one (scale, offset): the contract is bitwise
equality with the unfused op-by-op path, in float32 (the stream path's
type). Inputs are float32 or bfloat16; as in the Pallas kernels the
stages and the norm run in float32 and the result is rounded to x's dtype
once. ``affine_rmsnorm`` takes K1's :func:`~repro_torch.kernels.rmsnorm.row_plan`,
so its sums run in K1's order whether or not x's rows are aligned. The plain
versions are :func:`repro_torch.kernels.ref.map_chain_ref` and
:func:`~repro_torch.kernels.ref.affine_rmsnorm_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build
from ._launch import rows_of, scale_of, stream_ptr
from .rmsnorm import aligned_rows, row_plan

MAX_STAGES = 16  # csrc/common.cuh: kMaxStages

Stages = Sequence[Tuple[float, float]]


def _stage_arrays(stages: Stages):
    stages = tuple(stages)
    if len(stages) > MAX_STAGES:
        raise ValueError(f"at most {MAX_STAGES} stages per launch, got {len(stages)}")
    n = len(stages)
    scales = (ctypes.c_float * max(n, 1))(*(float(s) for s, _ in stages))
    offsets = (ctypes.c_float * max(n, 1))(*(float(o) for _, o in stages))
    return scales, offsets, n


def map_chain(x: torch.Tensor, stages: Stages) -> torch.Tensor:
    x2, rows, d, stride = rows_of(x, "x", (torch.float32, torch.bfloat16))
    scales, offsets, n = _stage_arrays(stages)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    lib = build.library()
    err = lib.rt_map_chain(
        x2.data_ptr(), stride, y.data_ptr(), rows, d,
        ctypes.addressof(scales), ctypes.addressof(offsets), n,
        int(x.dtype == torch.bfloat16), stream_ptr(x),
    )
    build.check(err, "map_chain")
    build.count_launch("map_chain")
    return y.reshape(x.shape)


def affine_rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, stages: Stages, eps: float = 1e-6
) -> torch.Tensor:
    x2, rows, d, stride = rows_of(x, "x", (torch.float32, torch.bfloat16))
    g = scale_of(scale, x, d)
    scales, offsets, n = _stage_arrays(stages)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    el = x.element_size()
    plan = row_plan(d, el, aligned_rows((x2.data_ptr(), g.data_ptr()), (stride,), el))
    lib = build.library()
    err = lib.rt_affine_rmsnorm(
        x2.data_ptr(), stride, g.data_ptr(), y.data_ptr(), rows, d, float(eps),
        ctypes.addressof(scales), ctypes.addressof(offsets), n,
        int(x.dtype == torch.bfloat16), *plan.args(), stream_ptr(x),
    )
    build.check(err, "affine_rmsnorm")
    build.count_launch("affine_rmsnorm")
    return y.reshape(x.shape)
