"""ExecutionBackend — the data-plane contract behind the port's StreamSystem.

The port's copy of ``repro.runtime.backend``, trimmed to what the stream
path uses: :class:`StreamSystem` drives a backend through the verbs

  ``deploy / kill / forward / pause / resume / step / account /
  sink_state / fuse_segments``

and backends plug in by name through :func:`register_backend` /
:func:`resolve_backend`. The port ships one, ``"torch"``
(:class:`repro_torch.runtime.executor.TorchBackend`). Segments step one
after another in launch order (the reference's ``"sync"`` mode).

This module holds the shared bookkeeping: :class:`SegmentSpec`,
:class:`StepReport`, the accounting constants, the O(1) task→segment
reverse index and the segment dependency DAG that the fusion planner
reads. Pause flags are host bools, so accounting never waits for the
card.
"""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple, Type, Union

from repro_torch.core.graph import Dataflow, Task

# Fraction of a task's cost still consumed while paused (deployed-but-idle
# Storm bolt). Calibrated so the paper's drain-phase crossover reproduces.
PAUSE_EPSILON = 0.03
# events·cost_weight per core: 1 core ≡ one weight-1.0 task at 10 ev/s ×
# 32-event batches — matches the paper's constant 10 ev/s input rate setup.
CORE_CALIBRATION = 320.0

PyTree = Any


@dataclass
class SegmentSpec:
    """Static description of a segment before it is built."""

    name: str
    dag_name: str  # running DAG this segment belongs to
    task_ids: List[str]  # topological order within the segment
    # task id -> parent ids in canonical (signature-sorted) order; parents may
    # live outside the segment (boundary inputs fetched from the broker).
    parents: Dict[str, List[str]]
    # tasks initially forwarding their output to the broker (boundary streams
    # known at deploy time). The backend can extend this set at runtime —
    # the paper's control-topic "forward" signal — because a step returns
    # every task's output.
    publish: Set[str]
    batch_of: Dict[str, int]  # per-task output batch size
    created_at: int = 0  # launch sequence number (segments step in this order)
    # Fusion-built segment: straight-line kernel runs inside it are swapped
    # onto the multi-op kernels (runtime/segment.py:_peephole_fused_kernels).
    fused: bool = False


@dataclass
class StepReport:
    step: int
    live_tasks: int
    paused_tasks: int
    cost: float  # core-equivalents this step
    wall_ms: float
    segment_ms: Dict[str, float] = field(default_factory=dict)


def compute_batches(
    order: List[str],
    parents: Dict[str, List[str]],
    known: Dict[str, int],
    base_batch: int,
) -> Dict[str, int]:
    """Static per-task batch sizes: sources B₀, else Σ parent batches."""
    out = dict(known)
    for tid in order:
        if tid in out:
            continue
        ps = parents[tid]
        out[tid] = base_batch if not ps else sum(out[p] for p in ps)
    return out


class ExecutionBackend:
    """Data-plane protocol + the runtime-agnostic bookkeeping.

    Concrete backends implement :meth:`_build` (a :class:`SegmentSpec` →
    a segment exposing ``spec``, ``states``, ``active``, ``cost_of`` and
    ``pause``/``resume``) and :meth:`_step_one`.
    """

    name: str = ""

    def __init__(self) -> None:
        self.segments: Dict[str, Any] = {}
        self.forwarding: Dict[str, Set[str]] = {}  # segment -> task ids forwarded
        self.paused: Set[str] = set()  # running task ids paused (global view)
        self.step_count = 0
        self._launch_seq = 0
        # O(1) reverse index: task id -> owning segment name
        self._owner_of: Dict[str, str] = {}
        # task id -> ⟨type, config⟩ definition (fusion rebuilds from these)
        self.task_defs: Dict[str, Task] = {}
        # Segment dependency DAG: segment -> upstream segments producing its
        # boundary inputs, maintained across deploy/kill.
        self.seg_deps: Dict[str, Set[str]] = {}
        self.reports: List[StepReport] = []

    # -- hooks for concrete backends ------------------------------------------
    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
    ) -> Any:
        raise NotImplementedError

    def _step_one(self, seg: Any) -> None:
        """Advance one segment one step; its wall time is measured around it."""
        raise NotImplementedError

    def _drop_streams(self, seg: Any) -> None:
        """Release any transport resources of a killed segment (broker topics)."""

    # -- deployment -----------------------------------------------------------
    def deploy(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]] = None,
    ) -> Any:
        spec.created_at = self._launch_seq
        self._launch_seq += 1
        seg = self._build(spec, dataflow, init_states)
        self.segments[spec.name] = seg
        self.forwarding[spec.name] = set(spec.publish)
        # Merges only add segments downstream of existing ones (launch order
        # is topological), so deploying never changes older segments' deps.
        in_segment = set(spec.task_ids)
        deps = {
            self._owner_of[p]
            for tid in spec.task_ids
            for p in spec.parents.get(tid, ())
            if p not in in_segment and p in self._owner_of
        }
        for tid in spec.task_ids:
            self._owner_of[tid] = spec.name
            self.task_defs[tid] = dataflow.tasks[tid]
        deps.discard(spec.name)
        self.seg_deps[spec.name] = deps
        return seg

    def kill(self, segment_name: str) -> None:
        seg = self.segments.pop(segment_name)
        self.forwarding.pop(segment_name, None)
        self.seg_deps.pop(segment_name, None)
        for deps in self.seg_deps.values():
            deps.discard(segment_name)
        self._drop_streams(seg)
        for tid in seg.spec.task_ids:
            self.paused.discard(tid)
            if self._owner_of.get(tid) == segment_name:
                del self._owner_of[tid]
                self.task_defs.pop(tid, None)

    # -- control signals (paper §4.3 control topic) -----------------------------
    def forward(self, task_id: str) -> None:
        """Ask the segment owning ``task_id`` to forward its output stream."""
        owner = self._owner_of.get(task_id)
        if owner is None:
            raise KeyError(f"task {task_id!r} not deployed")
        self.forwarding[owner].add(task_id)

    def pause(self, task_ids: Set[str]) -> None:
        for seg in self.segments.values():
            seg.pause(task_ids)
        self.paused |= {t for t in task_ids if t in self._owner_of}

    def resume(self, task_ids: Set[str]) -> None:
        for seg in self.segments.values():
            seg.resume(task_ids)
        self.paused -= set(task_ids)

    # -- stepping -----------------------------------------------------------------
    def _step_timed(self, name: str) -> float:
        seg = self.segments[name]
        s0 = time.perf_counter()
        self._step_one(seg)
        return (time.perf_counter() - s0) * 1e3

    def step(self) -> StepReport:
        """Every segment once, in launch order (topological)."""
        t0 = time.perf_counter()
        ordered = sorted(self.segments, key=lambda n: self.segments[n].spec.created_at)
        seg_ms = {name: self._step_timed(name) for name in ordered}
        live, paused_n, cost = self.account()
        self.step_count += 1
        report = StepReport(
            step=self.step_count,
            live_tasks=live,
            paused_tasks=paused_n,
            cost=cost,
            wall_ms=(time.perf_counter() - t0) * 1e3,
            segment_ms=seg_ms,
        )
        self.reports.append(report)
        return report

    def run(self, steps: int) -> List[StepReport]:
        return [self.step() for _ in range(steps)]

    # -- accounting ----------------------------------------------------------------
    def account(self) -> Tuple[int, int, float]:
        """(live tasks, paused tasks, core-equivalents) — the Fig. 2/3 counters."""
        live = 0
        paused_n = 0
        cost = 0.0
        for seg in self.segments.values():
            for tid in seg.spec.task_ids:
                w = seg.cost_of[tid] * seg.spec.batch_of[tid]
                if seg.active[tid]:
                    live += 1
                    cost += w
                else:
                    paused_n += 1
                    cost += PAUSE_EPSILON * w
        return live, paused_n, cost / CORE_CALIBRATION

    @property
    def deployed_task_count(self) -> int:
        return sum(len(s.spec.task_ids) for s in self.segments.values())

    def sink_state(self, task_id: str) -> Any:
        owner = self._owner_of.get(task_id)
        if owner is None:
            raise KeyError(f"sink task {task_id!r} not deployed")
        return self.segments[owner].states[task_id]

    # -- latency samples (fusion planner feed) --------------------------------------
    def latency_samples(self) -> List[Tuple[Dict[str, float], float]]:
        """⟨per-task-type work units, measured segment ms⟩ calibration pairs.

        Joins every recorded ``StepReport.segment_ms`` entry with the
        deployed segment's per-task ``cost_weight × batch`` work units,
        grouped by task type — what :func:`repro_torch.ops.costs.fit_latency_model`
        fits for the fusion planner's scoring.
        """
        samples: List[Tuple[Dict[str, float], float]] = []
        for report in self.reports:
            for name, ms in report.segment_ms.items():
                seg = self.segments.get(name)
                if seg is None:  # segment killed since — spec no longer known
                    continue
                units: Dict[str, float] = {}
                for tid in seg.spec.task_ids:
                    ttype = self.task_defs[tid].type
                    work = seg.cost_of[tid] * seg.spec.batch_of[tid]
                    units[ttype] = units.get(ttype, 0.0) + work
                samples.append((units, float(ms)))
        return samples

    # -- fusion (enactment; planning in repro_torch.core.defrag) -------------------
    def fuse_segments(
        self,
        fused_spec: SegmentSpec,
        dataflow: Dataflow,
        members: List[str],
    ) -> Any:
        """Replace ``members`` (a linear same-DAG segment chain) by ONE
        fusion-built segment, carrying task states over.

        Paused tasks inside the chain are re-paused afterwards: ``kill``
        forgets member pause flags and ``deploy`` starts all-active.
        """
        carried: Dict[str, PyTree] = {}
        repause = {t for t in fused_spec.task_ids if t in self.paused}
        for name in members:
            seg = self.segments[name]
            for tid in fused_spec.task_ids:
                if tid in seg.spec.task_ids:
                    carried[tid] = seg.states[tid]
            self.kill(name)
        seg = self.deploy(fused_spec, dataflow, init_states=carried)
        if repause:
            self.pause(repause)
        return seg


# -- backend registry ----------------------------------------------------------

_BACKENDS: Dict[str, Type[ExecutionBackend]] = {}
# Built-ins resolve lazily, so importing this module builds no operator.
_LAZY_BUILTINS: Dict[str, Tuple[str, str]] = {
    "torch": ("repro_torch.runtime.executor", "TorchBackend"),
}


def register_backend(cls: Type[ExecutionBackend]) -> Type[ExecutionBackend]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"backend class {cls.__name__} has no name")
    if cls.name in _BACKENDS or cls.name in _LAZY_BUILTINS:
        raise ValueError(f"execution backend {cls.name!r} already registered")
    _BACKENDS[cls.name] = cls
    return cls


def available_backends() -> List[str]:
    return sorted(set(_BACKENDS) | set(_LAZY_BUILTINS))


def resolve_backend(
    backend: Union[str, ExecutionBackend, Type[ExecutionBackend]],
    **kwargs: Any,
) -> ExecutionBackend:
    """Name / instance / class → backend instance (names hit the registry)."""
    if isinstance(backend, ExecutionBackend):
        return backend
    if isinstance(backend, type) and issubclass(backend, ExecutionBackend):
        return backend(**kwargs)
    if isinstance(backend, str):
        cls = _BACKENDS.get(backend)
        if cls is None and backend in _LAZY_BUILTINS:
            module, attr = _LAZY_BUILTINS[backend]
            cls = getattr(importlib.import_module(module), attr)
        if cls is None:
            raise ValueError(
                f"unknown backend {backend!r} (registered: {', '.join(available_backends())})"
            )
        return cls(**kwargs)
    raise TypeError(
        f"backend must be a name or ExecutionBackend, got {type(backend).__name__}"
    )
