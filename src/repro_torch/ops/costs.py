"""Task cost model — the single source of truth for ``cost_weight``.

``cost_weight`` is the relative per-event CPU cost used by the resource
accounting that reproduces the paper's Fig. 3 (cumulative cores). The
operator factories (:mod:`repro_torch.ops.riot`, :mod:`repro_torch.ops.sources`,
:mod:`repro_torch.ops.sinks`) read their weights from here, and the fusion
planner (:meth:`repro_torch.runtime.system.StreamSystem.fuse`) scores
segments with the same weights without building any operator.

A copy of ``repro.ops.costs`` with the same weights, so that the port's
Fig. 2/3 counters equal the reference's; it imports neither torch nor
anything of the reference package.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple

SOURCE_COST = 0.3
SINK_COST = 0.3

# RIoTBench task families (parse < filter < window stats < predict) —
# relative weights mirroring the costs reported per category.
RIOT_COSTS: Dict[str, float] = {
    # ETL
    "senml_parse": 3.0,
    "csv_parse": 2.0,
    "range_filter": 0.5,
    "bloom_filter": 1.5,
    "interpolate": 1.5,
    "join": 0.4,
    "annotate": 0.3,
    # STATS
    "kalman": 2.0,
    "win": 1.8,
    "avg": 1.0,
    "moment2": 1.4,
    "distinct_count": 1.1,
    "rmsnorm": 1.2,
    # PREDICT
    "linreg": 1.6,
    "dtree": 1.3,
    "sliding_linreg": 2.2,
    "error_estimate": 0.4,
}

# LM-pipeline stages (multi-tenant reuse serving).
LM_EMBED_COST = 0.2
LM_STAGE_COST_PER_BLOCK = 1.0
LM_HEAD_COST = 0.4

# OPMW synthetic π task: cost scales with the iteration count.
PI_COST_PER_ITER = 0.02
PI_DEFAULT_ITERS = 100


def parse_config(config: Any) -> Dict[str, Any]:
    """Inverse of :func:`repro_torch.core.graph.canonical_config` for dict configs."""
    if isinstance(config, Mapping):
        return dict(config)
    if isinstance(config, str):
        if config in ("SOURCE", "SINK"):
            return {}
        try:
            obj = json.loads(config)
            return obj if isinstance(obj, dict) else {"value": obj}
        except (json.JSONDecodeError, ValueError):
            return {"value": config}
    return {}


def pi_cost(cfg: Mapping[str, Any]) -> float:
    return PI_COST_PER_ITER * int(cfg.get("iters", PI_DEFAULT_ITERS))


def lm_stage_cost(cfg: Mapping[str, Any]) -> float:
    lo, hi = (int(v) for v in str(cfg.get("layers", "0-0")).split("-"))
    return LM_STAGE_COST_PER_BLOCK * (hi - lo + 1)


def cost_weight_for(
    type_name: str,
    config: Any = None,
    *,
    is_source: bool = False,
    is_sink: bool = False,
) -> float:
    """cost_weight of the operator ⟨type, config⟩ — without building it.

    Must stay in lockstep with :func:`repro_torch.ops.operator_for_task`: the
    conformance tests assert that dry-run and jit backends report identical
    cost trajectories.
    """
    if is_source:
        return SOURCE_COST
    if is_sink:
        return SINK_COST
    if type_name in RIOT_COSTS:
        return RIOT_COSTS[type_name]
    cfg = parse_config(config)
    if type_name == "lm_embed":
        return LM_EMBED_COST
    if type_name == "lm_stage":
        return lm_stage_cost(cfg)
    if type_name == "lm_head":
        return LM_HEAD_COST
    # unknown task types fall back to the OPMW iterative-π logic (§5.1)
    return pi_cost(cfg)


def cost_weight_for_task(task: Any) -> float:
    """cost_weight of a concrete :class:`repro_torch.core.graph.Task`."""
    return cost_weight_for(
        task.type, task.config, is_source=task.is_source, is_sink=task.is_sink
    )


# State leaves that a task's ``apply()`` overwrites wholesale every step
# without ever reading — scratch outputs like a sink's retained ``last``
# batch. Per-step recovery spills skip them (they self-heal on the first
# post-recovery step, and nothing downstream observes them before that);
# checkpoints, ``states`` RPCs and wire snapshots stay byte-exact. Lives
# here, not on :class:`~repro_torch.ops.base.Operator`, because the multiproc
# coordinator and dry workers consult it without importing JAX.
_EPHEMERAL_SINK_KEYS = ("last",)


def ephemeral_state_keys(task: Any) -> tuple:
    """Spill-excluded state keys of a :class:`repro_torch.core.graph.Task`."""
    return _EPHEMERAL_SINK_KEYS if task.is_sink else ()


# -- dry-run latency calibration ------------------------------------------------
#
# cost_weight is a *relative* per-event CPU cost; it says nothing about
# milliseconds. The LatencyModel closes that gap: fit per-task-type
# ms-per-work-unit coefficients (work unit = cost_weight × batch) from
# segment wall-times a jit backend actually measured
# (ExecutionBackend.latency_samples), and the DryRunBackend then reports
# realistic segment_ms — which is what makes its concurrent-mode makespan
# model (per-wave max) a meaningful wall-clock predictor.


@dataclass(frozen=True)
class LatencyModel:
    """Per-task-type wall-time model: ``ms ≈ Σ_type coef[type] · units``."""

    ms_per_unit: Dict[str, float]
    default_ms_per_unit: float = 0.0  # fallback for task types never observed

    def segment_ms(self, units: Mapping[str, float]) -> float:
        """Predicted step wall-time of a segment from its per-type work units."""
        return sum(
            self.ms_per_unit.get(t, self.default_ms_per_unit) * u
            for t, u in units.items()
        )


def fit_latency_model(
    samples: Sequence[Tuple[Mapping[str, float], float]],
) -> LatencyModel:
    """Least-squares fit of per-task-type latency coefficients.

    ``samples`` are ⟨per-type work units, measured segment ms⟩ pairs (the
    output of :meth:`ExecutionBackend.latency_samples`). Solves the
    minimum-norm least-squares system, clips negative coefficients to 0
    (a type can't speed a segment up), and keeps the global mean
    ms-per-unit as the fallback for types never observed.
    """
    import numpy as np

    samples = [(dict(u), float(ms)) for u, ms in samples if u]
    if not samples:
        return LatencyModel({})
    types = sorted({t for units, _ in samples for t in units})
    a = np.array([[units.get(t, 0.0) for t in types] for units, _ in samples])
    y = np.array([ms for _, ms in samples])
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    coef = np.clip(coef, 0.0, None)
    total_units = float(a.sum())
    default = float(y.sum() / total_units) if total_units > 0 else 0.0
    return LatencyModel(dict(zip(types, coef.tolist())), default_ms_per_unit=default)
