"""ExecutionBackend — the data-plane contract behind the port's StreamSystem.

The port's copy of ``repro.runtime.backend``, trimmed to what the stream
path uses: :class:`StreamSystem` drives a backend through the verbs

  ``deploy / kill / forward / pause / resume / step / snapshot / account /
  sink_state / fuse_segments / defragment / dump_state / restore_state``

and backends plug in by name through :func:`register_backend` /
:func:`resolve_backend`. The port ships two: ``"torch"``
(:class:`repro_torch.runtime.executor.TorchBackend`, the data plane) and
``"dryrun"`` (:class:`repro_torch.runtime.dryrun.DryRunBackend`, the
cost model). Segments step one after another in launch order (the
reference's ``"sync"`` mode; its ``"concurrent"`` mode is not ported).

This module holds the shared bookkeeping: :class:`SegmentSpec`,
:class:`StepReport`, the accounting constants, the O(1) task→segment
reverse index, the segment dependency DAG that the fusion planner reads,
and the durable ``dump_state``/``restore_state`` payload, whose layout is
the reference's, so checkpoints cross between the packages. Pause flags
are host bools, so accounting never waits for the card.
"""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Type, Union

from repro_torch.core.graph import Dataflow, Task

from .checkpoint import decode_pytree, encode_pytree

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


def _encode_report(r: StepReport) -> Dict[str, Any]:
    """JSON-safe StepReport for the opt-in checkpoint ring buffer."""
    return {
        "step": int(r.step),
        "live_tasks": int(r.live_tasks),
        "paused_tasks": int(r.paused_tasks),
        "cost": float(r.cost),
        "wall_ms": float(r.wall_ms),
        "segment_ms": {k: float(v) for k, v in r.segment_ms.items()},
    }


def _decode_report(rec: Dict[str, Any]) -> StepReport:
    return StepReport(
        step=int(rec["step"]),
        live_tasks=int(rec["live_tasks"]),
        paused_tasks=int(rec["paused_tasks"]),
        cost=float(rec["cost"]),
        wall_ms=float(rec["wall_ms"]),
        segment_ms={k: float(v) for k, v in rec.get("segment_ms", {}).items()},
    )


@dataclass
class BackendSnapshot:
    """Point-in-time backend state — the ``snapshot`` verb of the protocol."""

    backend: str
    step_count: int
    segments: Dict[str, List[str]]  # segment name -> deployed task ids
    paused: Set[str]
    live_tasks: int
    paused_tasks: int
    cost: float


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
    a segment exposing ``spec``, ``states``, ``active``, ``cost_of``,
    ``steps_run`` and ``pause``/``resume``) and :meth:`_step_one`.
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
        # opt-in StepReport ring buffer: bounds self.reports in memory AND
        # persists the tail in checkpoints (None = unbounded, not persisted)
        self.history_limit: Optional[int] = None
        # state-leaf encoder used by dump_state/_dump_extra — swapped for a
        # deferring marker during background-checkpoint snapshots
        self._state_encoder: Callable[[Any], Any] = encode_pytree

    # -- hooks for concrete backends ------------------------------------------
    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
    ) -> Any:
        raise NotImplementedError

    def _step_one(self, seg: Any) -> Optional[float]:
        """Advance one segment one step.

        Returns a simulated duration in ms (the dry-run latency model) or
        ``None`` to report the wall time measured around the call.
        """
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
        simulated = self._step_one(seg)
        return simulated if simulated is not None else (time.perf_counter() - s0) * 1e3

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
        if self.history_limit is not None and len(self.reports) > self.history_limit:
            del self.reports[: len(self.reports) - self.history_limit]
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

    def snapshot(self) -> BackendSnapshot:
        live, paused_n, cost = self.account()
        return BackendSnapshot(
            backend=self.name or type(self).__name__,
            step_count=self.step_count,
            segments={n: list(s.spec.task_ids) for n, s in self.segments.items()},
            paused=set(self.paused),
            live_tasks=live,
            paused_tasks=paused_n,
            cost=cost,
        )

    def spawn_config(self) -> Dict[str, Any]:
        """Constructor kwargs that reproduce this backend's topology.

        Checkpoints persist this next to the backend name so a restore onto
        the same backend re-creates the same data plane. Keys must be
        JSON-safe and accepted by the backend's constructor. The device is
        not one of them: a checkpoint restores on any device."""
        return {}

    # -- durability (checkpoint/restore verbs) ------------------------------------
    def dump_state(self, state_encoder: Optional[Callable[[Any], Any]] = None) -> Dict[str, Any]:
        """Serialize everything a restore needs to resume stepping exactly.

        The payload is backend-portable: segment specs carry each task's
        ⟨type, config⟩ so a restoring backend can rebuild operators (or cost
        entries) without the original running DAGs — deployed-but-paused
        tasks may no longer exist in any running DAG. Backend-specific
        extras (broker buffers) ride in ``extra`` via :meth:`_dump_extra`
        and are ignored by backends that don't know them, which is what
        makes torch ↔ dryrun cross-restores work.

        ``state_encoder`` overrides how state leaves are serialized — the
        background checkpointer passes a deferring marker so the cheap
        snapshot happens on the stepping thread and the host copy and
        base64 encoding on the writer thread. A backend whose steps write
        states in place (the torch backend on the card) hands the marker a
        copy of each leaf.
        """
        self._state_encoder = encode_pytree if state_encoder is None else state_encoder
        try:
            return self._dump_state_inner()
        finally:
            self._state_encoder = encode_pytree

    def _dump_state_inner(self) -> Dict[str, Any]:
        enc = self._state_encoder
        segments: List[Dict[str, Any]] = []
        for name, seg in sorted(self.segments.items(), key=lambda kv: kv[1].spec.created_at):
            spec = seg.spec
            segments.append(
                {
                    "name": name,
                    "dag_name": spec.dag_name,
                    "task_ids": list(spec.task_ids),
                    "parents": {t: list(ps) for t, ps in spec.parents.items()},
                    # the *current* forwarding set, so runtime forward()
                    # signals survive the restore as the new publish set
                    "publish": sorted(self.forwarding.get(name, set())),
                    "batch_of": {t: int(b) for t, b in spec.batch_of.items()},
                    "created_at": int(spec.created_at),
                    "fused": bool(spec.fused),
                    "tasks": {
                        t: {"type": self.task_defs[t].type, "config": self.task_defs[t].config}
                        for t in spec.task_ids
                    },
                    "states": {t: enc(seg.states[t]) for t in spec.task_ids},
                    "steps_run": int(seg.steps_run),
                }
            )
        state = {
            "step_count": int(self.step_count),
            "launch_seq": int(self._launch_seq),
            "paused": sorted(self.paused),
            "segments": segments,
            "extra": self._dump_extra(),
        }
        if self.history_limit is not None:
            # opt-in monitoring history: the StepReport ring buffer survives
            # restarts (dashboards resume with the pre-crash trajectory)
            state["history_limit"] = int(self.history_limit)
            state["reports"] = [_encode_report(r) for r in self.reports]
        return state

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Redeploy every checkpointed segment and resume the counters.

        Must be called on a *fresh* backend. Segments re-deploy in their
        original launch order (so the launch-order-is-topological invariant
        survives), with task states decoded through the backend-specific
        :meth:`_decode_init_states` hook — that hook is where cross-backend
        restores coerce states (torch ⇄ dryrun, and payloads of the
        reference's backends). Keys this port does not keep (the
        reference's straggler EWMAs and redispatch log) are ignored.
        """
        if self.segments:
            raise ValueError("restore_state() needs a fresh backend (segments deployed)")
        self._restore_extra(state.get("extra", {}))
        for rec in sorted(state["segments"], key=lambda r: r["created_at"]):
            spec = SegmentSpec(
                name=rec["name"],
                dag_name=rec["dag_name"],
                task_ids=list(rec["task_ids"]),
                parents={t: list(ps) for t, ps in rec["parents"].items()},
                publish=set(rec["publish"]),
                batch_of={t: int(b) for t, b in rec["batch_of"].items()},
                fused=bool(rec.get("fused", False)),
            )
            # Synthetic task-definition container: deploy only reads
            # dataflow.tasks[tid] (operator/cost construction), so the
            # checkpointed ⟨type, config⟩ records are sufficient.
            df = Dataflow(rec["dag_name"])
            for tid in spec.task_ids:
                t = rec["tasks"][tid]
                df.add_task(Task.make(tid, t["type"], t["config"]))
            init_states = self._decode_init_states(spec, df, rec["states"])
            self._launch_seq = int(rec["created_at"])
            seg = self.deploy(spec, df, init_states=init_states)
            seg.steps_run = int(rec.get("steps_run", 0))
        self._launch_seq = int(state["launch_seq"])
        paused = set(state.get("paused", ()))
        if paused:
            self.pause(paused)
        self.step_count = int(state["step_count"])
        if state.get("history_limit") is not None:
            self.history_limit = int(state["history_limit"])
            self.reports = [_decode_report(r) for r in state.get("reports", ())]

    def _decode_init_states(
        self, spec: SegmentSpec, dataflow: Dataflow, states_enc: Dict[str, Any]
    ) -> Dict[str, PyTree]:
        """Decode checkpointed states into this backend's native form."""
        return {tid: decode_pytree(enc) for tid, enc in states_enc.items()}

    def _dump_extra(self) -> Dict[str, Any]:
        """Backend-specific durable extras (broker buffers)."""
        return {}

    def _restore_extra(self, extra: Dict[str, Any]) -> None:
        """Consume :meth:`_dump_extra` output; unknown keys must be ignored."""

    def compile_cache_stats(self) -> Dict[str, int]:
        """Hit/miss/evict counters of the segment-step reuse cache, in the
        reference's four keys: the torch backend's ``compile_cache``; zeros
        for a backend without one (dryrun)."""
        cache = getattr(self, "compile_cache", None)
        if cache is None:
            return {"hits": 0, "misses": 0, "evictions": 0, "entries": 0}
        return cache.stats()

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

    # -- defragmentation and fusion (enactment; planning in repro_torch.core.defrag)
    def defragment(
        self,
        dag_name: str,
        fused_spec: SegmentSpec,
        dataflow: Dataflow,
    ) -> Any:
        """Replace all segments of ``dag_name`` by one fused segment.

        Task states carry over (state-preserving defrag — beyond the paper,
        which would relaunch cold). Paused tasks are dropped entirely,
        reclaiming their ε overhead. Segments are picked by the DAG name
        they were deployed under, which a later merge does not rename:
        :meth:`StreamSystem.defragment` therefore relaunches every running
        DAG at once instead.
        """
        carried: Dict[str, PyTree] = {}
        for name, seg in list(self.segments.items()):
            if seg.spec.dag_name != dag_name:
                continue
            for tid in fused_spec.task_ids:
                if tid in seg.spec.task_ids:
                    carried[tid] = seg.states[tid]
            self.kill(name)
        return self.deploy(fused_spec, dataflow, init_states=carried)

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
    "dryrun": ("repro_torch.runtime.dryrun", "DryRunBackend"),
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
