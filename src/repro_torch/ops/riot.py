"""Real IoT task logic over torch tensors — the RIoTBench task families.

The port of ``repro.ops.riot``: each task is real numerics over event
batches of shape ``(B, EVENT_WIDTH)``:

  channel 0    timestamp
  channels 1-5 observation values (5 sensor channels)
  channel 6    validity flag (1.0 = valid)
  channel 7    event id / hash key

Every float32 operation follows the reference's order, so outputs agree
with it within float32 rounding, and integer state (bloom and
distinct-count bitsets) agrees exactly. Where the reference scans rows
(``interpolate``, ``kalman``), the port computes the same recurrence
without a per-row launch: ``interpolate`` only selects values, so a
cumulative max over valid-row indices forward-fills it exactly, and
``kalman`` goes through the ``kalman_scan`` kernel.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import random as rng
from ..kernels import ops as kernel_ops
from .base import Operator, register, register_fallback, stateless
from .costs import RIOT_COSTS, parse_config, pi_cost

VAL = slice(1, 6)  # observation channels
FLAG = 6
KEY = 7

# Straight-line runs of these types collapse onto one multi-op kernel when a
# fused segment is built (runtime/segment.py:_peephole_fused_kernels):
# FUSABLE_ELEMENTWISE types may appear anywhere in the run, FUSED_TAILS end it.
FUSABLE_ELEMENTWISE = ("senml_parse",)
FUSED_TAILS = ("rmsnorm", "senml_parse")

_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1
_HASH_MUL = float(np.float32(2654435761.0))  # the reference multiplies in float32


def _with(x: torch.Tensor, cols, vals) -> torch.Tensor:
    """``x.at[:, cols].set(vals)``: a new batch, the input untouched."""
    y = x.clone()
    y[:, cols] = vals
    return y


def make_fused_operator(tasks, batch: int, device: torch.device | str = "cpu") -> Any:
    """One operator computing a ``senml_parse* → (rmsnorm|senml_parse)`` run.

    ``tasks`` is the run in head→tail dataflow order. The returned
    operator replaces the tail task inside a fused segment and consumes the
    head's input; it goes through the multi-op kernels
    (:func:`repro_torch.kernels.ops.affine_rmsnorm` / ``map_chain``) with
    the stages replayed one after another, so its output is bitwise the
    unfused op-by-op output on the same device. State structure and cost
    weight are the tail's (both tails are stateless). Returns ``None`` for
    runs this factory does not understand.
    """
    if len(tasks) < 2:
        return None
    *heads, tail = tasks
    if any(t.type not in FUSABLE_ELEMENTWISE for t in heads):
        return None
    if tail.type not in FUSED_TAILS:
        return None

    def _stage(cfg: Dict[str, Any]):
        return (float(cfg.get("scale", 1.0)), float(cfg.get("offset", 0.0)))

    stages = tuple(_stage(parse_config(t.config)) for t in heads)
    tail_cfg = parse_config(tail.config)
    device = torch.device(device)

    if tail.type == "rmsnorm":
        eps = float(tail_cfg.get("eps", 1e-6))
        scale = torch.full((5,), float(tail_cfg.get("gain", 1.0)), device=device)

        def fn(x: torch.Tensor) -> torch.Tensor:
            vals = kernel_ops.affine_rmsnorm(x[:, VAL], scale, stages=stages, eps=eps)
            return _with(x, VAL, vals)

    else:  # senml_parse tail — its own affine is just the last stage
        all_stages = stages + (_stage(tail_cfg),)

        def fn(x: torch.Tensor) -> torch.Tensor:
            return _with(x, VAL, kernel_ops.map_chain(x[:, VAL], stages=all_stages))

    return stateless(tail.type, fn, cost=RIOT_COSTS[tail.type])


def _hash_channel(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Cheap integer hash of the id channel (splitmix-style), int64-held int32.

    The reference casts ``id·2654435761 + salt`` (float32) to int32, and
    XLA saturates out-of-range values; a torch cast would wrap on the CPU
    and saturate on the card, so the saturation is spelled out. The
    int32 multiply wraps, which int64 math and a 32-bit fold reproduce.
    """
    v = x[:, KEY] * _HASH_MUL + float(salt)
    big = v >= 2147483648.0
    small = v < -2147483648.0
    z = torch.where(big | small | torch.isnan(v), torch.zeros_like(v), v).to(torch.int64)
    z = torch.where(big, _INT32_MAX, torch.where(small, _INT32_MIN, z))
    z = _wrap32((z ^ (z >> 16)) * 0x45D9F3B)
    return z ^ (z >> 16)


def _wrap32(z: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 value of the low 32 bits of an int64 tensor."""
    return ((z & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _bucket(z: torch.Tensor, m: int) -> torch.Tensor:
    """``jnp.abs(z) % m`` in int32: abs(INT32_MIN) stays INT32_MIN."""
    a = torch.where(z == _INT32_MIN, z, z.abs())
    return torch.remainder(a, m)


# -- ETL family ---------------------------------------------------------------

@register("senml_parse")
def senml_parse(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Decode: per-channel affine normalization (scale/offset from config)."""
    scale = float(cfg.get("scale", 1.0))
    offset = float(cfg.get("offset", 0.0))

    def fn(x: torch.Tensor) -> torch.Tensor:
        return _with(x, VAL, x[:, VAL] * scale + offset)

    return stateless("senml_parse", fn, cost=RIOT_COSTS["senml_parse"])


@register("csv_parse")
def csv_parse(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Field re-ordering + cast — a fixed channel permutation."""
    shift = int(cfg.get("shift", 1)) % 5

    def fn(x: torch.Tensor) -> torch.Tensor:
        return _with(x, VAL, torch.roll(x[:, VAL], shifts=shift, dims=1))

    return stateless("csv_parse", fn, cost=RIOT_COSTS["csv_parse"])


@register("range_filter")
def range_filter(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Quality check: flag events whose channel-1 value is out of [lo, hi]."""
    lo = float(np.float32(cfg.get("lo", -1e3)))
    hi = float(np.float32(cfg.get("hi", 1e3)))

    def fn(x: torch.Tensor) -> torch.Tensor:
        ok = (x[:, 1] >= lo) & (x[:, 1] <= hi)
        return _with(x, FLAG, x[:, FLAG] * ok.to(x.dtype))

    return stateless("range_filter", fn, cost=RIOT_COSTS["range_filter"])


@register("bloom_filter")
def bloom_filter(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Membership filter with a real bitset state (m buckets, k salts)."""
    m = int(cfg.get("m", 1024))
    salts = tuple(range(int(cfg.get("k", 3))))

    def init_state(batch: int):
        return torch.zeros((m,), dtype=torch.int32, device=device)

    def apply(state, x):
        seen = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
        new = state.clone()
        for s in salts:
            idx = _bucket(_hash_channel(x, s), m)
            seen = seen & (state[idx] > 0)
            new.index_fill_(0, idx, 1)  # a scalar fill: no host copy inside a CUDA graph
        # mark duplicate events invalid (flag *= not-seen)
        return new, _with(x, FLAG, x[:, FLAG] * (~seen).to(x.dtype))

    return Operator("bloom_filter", init_state, apply, cost_weight=RIOT_COSTS["bloom_filter"])


@register("interpolate")
def interpolate(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Replace invalid observations with the last valid value (per channel).

    The reference scans rows, carrying the last valid row's values. Each
    output row is a copy of the latest valid row at or before it (or of the
    carried state), so a running max over the indices of valid rows picks
    it without a scan.
    """

    def init_state(batch: int):
        return torch.zeros((5,), dtype=torch.float32, device=device)

    def apply(state, x):
        n = x.shape[0]
        valid = x[:, FLAG] > 0.5
        rows = torch.arange(n, device=x.device)
        last, _ = torch.cummax(torch.where(valid, rows, torch.full_like(rows, -1)), dim=0)
        vals = torch.where(
            (last >= 0)[:, None], x[last.clamp(min=0), VAL], state.to(x.dtype)[None, :]
        )
        y = x.clone()
        y[:, VAL] = vals
        y[:, FLAG] = 1.0
        new_state = vals[-1] if n else state
        return new_state, y

    return Operator("interpolate", init_state, apply, cost_weight=RIOT_COSTS["interpolate"])


@register("join")
def join(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Interleave-join: pass events through, stamping a join counter."""

    def init_state(batch: int):
        return torch.zeros((), dtype=torch.int32, device=device)

    def apply(state, x):
        return state + 1, _with(x, 0, x[:, 0] + 0.0)  # timestamp untouched; count advances

    return Operator("join", init_state, apply, cost_weight=RIOT_COSTS["join"])


@register("annotate")
def annotate(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Metadata annotation: add a constant tag into channel 5."""
    tag = float(cfg.get("tag", 1.0))

    def fn(x: torch.Tensor) -> torch.Tensor:
        return _with(x, 5, tag)

    return stateless("annotate", fn, cost=RIOT_COSTS["annotate"])


# -- STATS family --------------------------------------------------------------

@register("kalman")
def kalman(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Scalar Kalman filter per observation channel (real recurrence)."""
    q = float(cfg.get("q", 0.1))  # process noise
    r = float(cfg.get("r", 1.0))  # measurement noise

    def init_state(batch: int):
        return {
            "x": torch.zeros((5,), dtype=torch.float32, device=device),
            "p": torch.ones((5,), dtype=torch.float32, device=device),
        }

    def apply(state, x):
        vals, xe, p = kernel_ops.kalman_scan(x[:, VAL], state["x"], state["p"], q, r)
        return {"x": xe, "p": p}, _with(x, VAL, vals)

    return Operator("kalman", init_state, apply, cost_weight=RIOT_COSTS["kalman"])


@register("win")
def sliding_window(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Sliding window: ring buffer of the last w batch-means, emits window mean."""
    w = int(cfg.get("w", 10))

    def init_state(batch: int):
        return {
            "buf": torch.zeros((w, 5), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device),
        }

    def apply(state, x):
        mean = x[:, VAL].mean(dim=0)
        idx = torch.remainder(state["n"], w).reshape(1).long()
        buf = state["buf"].index_copy(0, idx, mean[None, :])
        n = state["n"] + 1
        denom = torch.clamp(n, max=w).to(torch.float32)
        agg = buf.sum(dim=0) / denom
        # values re-centered around the window aggregate
        return {"buf": buf, "n": n}, _with(x, VAL, x[:, VAL] - agg)

    return Operator("win", init_state, apply, cost_weight=RIOT_COSTS["win"])


@register("avg")
def block_average(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Running (cumulative) average — Welford mean per channel."""

    def init_state(batch: int):
        return {
            "mean": torch.zeros((5,), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.float32, device=device),
        }

    def apply(state, x):
        bmean = x[:, VAL].mean(dim=0)
        n = state["n"] + 1.0
        mean = state["mean"] + (bmean - state["mean"]) / n
        return {"mean": mean, "n": n}, _with(x, VAL, x[:, VAL] - mean)

    return Operator("avg", init_state, apply, cost_weight=RIOT_COSTS["avg"])


@register("moment2")
def second_order_moment(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Running variance (Welford) — stamps normalized values."""

    def init_state(batch: int):
        return {
            "mean": torch.zeros((5,), dtype=torch.float32, device=device),
            "m2": torch.zeros((5,), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.float32, device=device),
        }

    def apply(state, x):
        bmean = x[:, VAL].mean(dim=0)
        n = state["n"] + 1.0
        delta = bmean - state["mean"]
        mean = state["mean"] + delta / n
        m2 = state["m2"] + delta * (bmean - mean)
        var = m2 / torch.clamp(n - 1.0, min=1.0)
        y = _with(x, VAL, (x[:, VAL] - mean) * torch.rsqrt(var + 1e-6))
        return {"mean": mean, "m2": m2, "n": n}, y

    return Operator("moment2", init_state, apply, cost_weight=RIOT_COSTS["moment2"])


@register("rmsnorm")
def rmsnorm_op(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """RMS-normalize the observation channels through the K1 kernel."""
    eps = float(cfg.get("eps", 1e-6))
    scale = torch.full((5,), float(cfg.get("gain", 1.0)), device=device)

    def fn(x: torch.Tensor) -> torch.Tensor:
        return _with(x, VAL, kernel_ops.rmsnorm(x[:, VAL], scale, eps=eps))

    return stateless("rmsnorm", fn, cost=RIOT_COSTS["rmsnorm"])


@register("distinct_count")
def distinct_count(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Approximate distinct count (linear-counting bitset)."""
    m = int(cfg.get("m", 512))

    def init_state(batch: int):
        return torch.zeros((m,), dtype=torch.int32, device=device)

    def apply(state, x):
        idx = _bucket(_hash_channel(x, 7), m)
        bits = state.clone()
        bits.index_fill_(0, idx, 1)
        zeros = (m - bits.sum(dtype=torch.int32)).to(torch.float32)
        est = -float(m) * torch.log(torch.clamp(zeros, min=1.0) / float(m))
        return bits, _with(x, 5, est)

    return Operator("distinct_count", init_state, apply, cost_weight=RIOT_COSTS["distinct_count"])


# -- PREDICT family --------------------------------------------------------------

@register("linreg")
def multivar_linreg(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Multi-variate linear regression predict: ŷ = w·x + b (fixed weights)."""
    seed = int(cfg.get("seed", 0))
    w = rng.normal(rng.prng_key(seed, device=device), (5,)) * 0.3

    def fn(x: torch.Tensor) -> torch.Tensor:
        return _with(x, 5, x[:, VAL] @ w)

    return stateless("linreg", fn, cost=RIOT_COSTS["linreg"])


@register("dtree")
def decision_tree(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Fixed-depth decision-tree classifier over the observation channels."""
    t1 = float(np.float32(cfg.get("t1", 0.0)))
    t2 = float(np.float32(cfg.get("t2", 0.5)))
    t3 = float(np.float32(cfg.get("t3", -0.5)))

    def fn(x: torch.Tensor) -> torch.Tensor:
        one = torch.ones_like(x[:, 1])
        c = torch.where(
            x[:, 1] > t1,
            torch.where(x[:, 2] > t2, 2.0 * one, one),
            torch.where(x[:, 3] > t3, 0.0 * one, -one),
        )
        return _with(x, 5, c)

    return stateless("dtree", fn, cost=RIOT_COSTS["dtree"])


@register("sliding_linreg")
def sliding_linreg(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """OLS trend over a ring buffer of batch means (2x2 normal equations)."""
    w = int(cfg.get("w", 16))
    t = torch.arange(w, dtype=torch.float32, device=device)

    def init_state(batch: int):
        return {
            "buf": torch.zeros((w,), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device),
        }

    def apply(state, x):
        mean = x[:, 1].mean()
        idx = torch.remainder(state["n"], w).reshape(1).long()
        buf = state["buf"].index_copy(0, idx, mean.reshape(1))
        n = state["n"] + 1
        mask = (t < torch.clamp(n, max=w).to(torch.float32)).to(torch.float32)
        cnt = mask.sum()
        tm = (t * mask).sum() / cnt
        ym = (buf * mask).sum() / cnt
        cov = ((t - tm) * (buf - ym) * mask).sum()
        var = ((t - tm) ** 2 * mask).sum()
        slope = cov / torch.clamp(var, min=1e-6)
        return {"buf": buf, "n": n}, _with(x, 5, slope)

    return Operator("sliding_linreg", init_state, apply, cost_weight=RIOT_COSTS["sliding_linreg"])


@register("error_estimate")
def error_estimate(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """|prediction − observation| into channel 4."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        return _with(x, 4, torch.abs(x[:, 5] - x[:, 1]))

    return stateless("error_estimate", fn, cost=RIOT_COSTS["error_estimate"])


# -- OPMW synthetic π task (paper §5.1) -----------------------------------------

@register("pi")
def pi_task(cfg: Dict[str, Any], device: torch.device) -> Operator:
    return _pi_operator(cfg, "pi")


@register_fallback
def _fallback(cfg: Dict[str, Any], device: torch.device) -> Operator:
    """Unknown task types (the OPMW workload) run the iterative π logic —
    exactly the paper's substitution of OPMW task internals."""
    return _pi_operator(cfg, cfg.get("_type", "pi"))


def pi_estimate(iters: int) -> float:
    """The reference's float32 ``fori_loop`` π series, summed in the same order.

    It does not depend on the input, so it runs once, on the host.
    """
    acc = np.float32(0.0)
    for i in range(iters):
        sign = np.float32(1.0 if i % 2 == 0 else -1.0)
        acc = np.float32(acc + sign * np.float32(4.0) / (np.float32(2.0) * np.float32(i) + np.float32(1.0)))
    return float(acc)


def _pi_operator(cfg: Dict[str, Any], type_name: str) -> Operator:
    pi_est = pi_estimate(int(cfg.get("iters", 100)))

    def fn(x: torch.Tensor) -> torch.Tensor:
        return _with(x, 5, pi_est)

    # π cost scales with the iteration count (CPU-intensive per event).
    return stateless(type_name, fn, cost=pi_cost(cfg))
