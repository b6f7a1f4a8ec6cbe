"""DryRunBackend — pure cost-model stepping: no operator, no tensor.

The port's copy of ``repro.runtime.dryrun``. The paper's Fig. 2/3
resource counters (running task count, core usage) are *control-plane*
observables: they depend only on which tasks are deployed, which are
paused, and each task's ``cost_weight × batch``. This backend deploys the
same :class:`~repro_torch.runtime.backend.SegmentSpec` segments the torch
backend would, but instantiates no operators and moves no event batches —
a step just advances per-sink event counters and re-evaluates the shared
accounting. Full 35-dataflow OPMW arrival/departure sweeps run in
milliseconds.

The contract with the torch backend: identical ``live_tasks`` /
``paused_tasks`` / ``cost`` trajectories for the same submissions (cost
weights come from the shared :mod:`repro_torch.ops.costs` model) and
identical sink event *counts*; checksums are data-plane only and read as
0.0 here.

Latency is *modelled*, not spent: with a calibrated
:class:`~repro_torch.ops.costs.LatencyModel` (fit from recorded
``StepReport``s via :meth:`ExecutionBackend.latency_samples`) every
segment reports the wall time the torch backend would have measured, and
``step_mode="concurrent"`` turns into a simulated-clock makespan study —
per-wave ``segment_ms = max`` (independent segments overlap), summed
across dependency waves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Union

from repro_torch.core.graph import Dataflow
from repro_torch.ops.costs import LatencyModel, cost_weight_for_task

from .backend import ExecutionBackend, SegmentSpec
from .checkpoint import decode_pytree


@dataclass
class DrySegment:
    """Cost-model stand-in for a compiled segment (same observable surface)."""

    spec: SegmentSpec
    states: Dict[str, Any]  # sinks: {"count", "checksum"}; others: ()
    active: Dict[str, bool]
    cost_of: Dict[str, float]
    sink_ids: List[str]
    steps_run: int = 0

    @property
    def name(self) -> str:
        return self.spec.name

    def live_task_ids(self) -> List[str]:
        return [t for t in self.spec.task_ids if self.active[t]]

    def pause(self, task_ids: Set[str]) -> None:
        for tid in task_ids:
            if tid in self.active:
                self.active[tid] = False

    def resume(self, task_ids: Set[str]) -> None:
        for tid in task_ids:
            if tid in self.active:
                self.active[tid] = True


class DryRunBackend(ExecutionBackend):
    name = "dryrun"
    # Concurrency is simulated, not spent: stepping stays on the caller's
    # thread and the dependency-DAG makespan model (wave max) does the rest.
    concurrent_dispatch = False

    def __init__(
        self,
        step_mode: str = "sync",
        max_workers: Optional[int] = None,
        latency_model: Optional[LatencyModel] = None,
    ):
        super().__init__(step_mode=step_mode, max_workers=max_workers)
        self.latency_model = latency_model

    def calibrate(self, samples_or_model: Union[LatencyModel, list]) -> LatencyModel:
        """Install a latency model (or fit one from calibration samples —
        the output of :meth:`ExecutionBackend.latency_samples`)."""
        if isinstance(samples_or_model, LatencyModel):
            self.latency_model = samples_or_model
        else:
            from repro_torch.ops.costs import fit_latency_model

            self.latency_model = fit_latency_model(samples_or_model)
        return self.latency_model

    # -- ExecutionBackend hooks -------------------------------------------------
    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, Any]],
    ) -> DrySegment:
        states: Dict[str, Any] = {}
        sink_ids: List[str] = []
        cost_of: Dict[str, float] = {}
        for tid in spec.task_ids:
            task = dataflow.tasks[tid]
            cost_of[tid] = cost_weight_for_task(task)
            if task.is_sink:
                sink_ids.append(tid)
                states[tid] = {"count": 0, "checksum": 0.0}
            else:
                states[tid] = ()
            if init_states and tid in init_states:
                states[tid] = init_states[tid]
        return DrySegment(
            spec=spec,
            states=states,
            active={tid: True for tid in spec.task_ids},
            cost_of=cost_of,
            sink_ids=sink_ids,
        )

    def _decode_init_states(
        self, spec: SegmentSpec, dataflow: Dataflow, states_enc: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Coerce checkpointed states to the cost-model's native form.

        Only sink counters matter here: a torch checkpoint's sink state
        (arrays for count/checksum/last) collapses to
        ``{"count": int, "checksum": 0.0}`` — checksums are data-plane only
        and read as 0.0 on this backend — and every non-sink state
        collapses to ``()``. This is the torch → dryrun half of the
        cross-backend restore contract: sink counts and Fig. 2 trajectories
        continue exactly; operator state is deliberately dropped.
        """
        out: Dict[str, Any] = {}
        for tid, enc in states_enc.items():
            if not dataflow.tasks[tid].is_sink:
                out[tid] = ()
                continue
            value = decode_pytree(enc)
            count = value.get("count", 0) if isinstance(value, dict) else 0
            out[tid] = {"count": int(count), "checksum": 0.0}
        return out

    def _step_one(self, seg: DrySegment) -> Optional[float]:
        for tid in seg.sink_ids:
            if seg.active[tid]:
                st = seg.states[tid]
                seg.states[tid] = {"count": st["count"] + 1, "checksum": 0.0}
        seg.steps_run += 1
        if self.latency_model is None:
            return None  # measured (~µs) — the uncalibrated behavior
        units: Dict[str, float] = {}
        for tid in seg.spec.task_ids:
            if not seg.active[tid]:
                continue  # paused tasks are skipped by the torch step too
            ttype = self.task_defs[tid].type
            units[ttype] = units.get(ttype, 0.0) + seg.cost_of[tid] * seg.spec.batch_of[tid]
        return self.latency_model.segment_ms(units)
