"""ExecutionBackend — the data-plane contract behind the port's StreamSystem.

The port's copy of ``repro.runtime.backend``, trimmed to what the stream
path uses: :class:`StreamSystem` drives a backend through the verbs

  ``deploy / kill / forward / pause / resume / step / snapshot / account /
  sink_state / fuse_segments / defragment / dump_state / restore_state``

and backends plug in by name through :func:`register_backend` /
:func:`resolve_backend`. The port ships four: ``"torch"``
(:class:`repro_torch.runtime.executor.TorchBackend`, the data plane in
this process), ``"sharded"`` (:class:`repro_torch.runtime.sharded.ShardedBackend`,
the same plane with segments placed across devices), ``"multiproc"``
(:class:`repro_torch.runtime.worker.MultiprocBackend`, the same segments
stepped inside worker processes, boundary streams on a shared-memory or
tcp transport) and ``"dryrun"``
(:class:`repro_torch.runtime.dryrun.DryRunBackend`, the cost model). Stepping runs in the reference's two modes
(:meth:`ExecutionBackend.configure_stepping`): ``"sync"``, one segment
after another in launch order, or ``"concurrent"``, a dependency-aware
ready-queue dispatch over a persistent thread pool
(:mod:`repro_torch.runtime.scheduler`); the torch backend on the card
issues the waves onto several CUDA streams from the stepping thread
instead, which puts independent segments on the card at once.

This module holds the shared bookkeeping: :class:`SegmentSpec`,
:class:`StepReport`, the accounting constants, the O(1) task→segment
reverse index, the segment dependency DAG that the wave scheduler and the
fusion planner read, the straggler EWMAs, the telemetry instruments
(:mod:`repro_torch.obs`) and the durable ``dump_state``/``restore_state``
payload, whose layout is the reference's, so checkpoints cross between
the packages. Pause flags are host bools, so accounting never waits for
the card. The cluster-plane hooks (worker events and health, in-step
recovery) are the reference's: every backend accepts them, and only the
multiproc backend emits or recovers.
"""
from __future__ import annotations

import importlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Type, Union

from repro_torch.core.graph import Dataflow, Task
from repro_torch.obs import NULL_REGISTRY, MetricsRegistry, Tracer

from .checkpoint import decode_pytree, encode_pytree
from .scheduler import WaveEvent, compute_waves, run_ready_queue

STEP_MODES = ("sync", "concurrent")

# Fraction of a task's cost still consumed while paused (deployed-but-idle
# Storm bolt). Calibrated so the paper's drain-phase crossover reproduces.
PAUSE_EPSILON = 0.03
# events·cost_weight per core: 1 core ≡ one weight-1.0 task at 10 ev/s ×
# 32-event batches — matches the paper's constant 10 ev/s input rate setup.
CORE_CALIBRATION = 320.0
# Straggler detection floor: below this median step-time the k·median test
# would flag pure perf_counter jitter (the dry-run backend steps in
# microseconds), so segments are only judged once steps cost real time.
STRAGGLER_MIN_MEDIAN_MS = 0.05
# A segment is a straggler when its step-time EWMA exceeds this many times
# the median EWMA; the EWMA weighs each new step by EWMA_ALPHA (the
# reference's defaults).
STRAGGLER_FACTOR = 3.0
EWMA_ALPHA = 0.3

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
    # host ms around each segment's step, which waits for its work; on the
    # card in concurrent mode, the device ms between events around it
    segment_ms: Dict[str, float] = field(default_factory=dict)
    stragglers: List[str] = field(default_factory=list)
    # Modelled step latency from the segment dependency DAG: Σ over waves of
    # the wave max in concurrent mode (independent segments overlap), Σ of
    # all segment_ms in sync mode (one serial sweep). For the dry-run
    # backend this *is* the predicted wall-clock of a concurrent deployment.
    makespan_ms: float = 0.0


def _encode_report(r: StepReport) -> Dict[str, Any]:
    """JSON-safe StepReport for the opt-in checkpoint ring buffer."""
    return {
        "step": int(r.step),
        "live_tasks": int(r.live_tasks),
        "paused_tasks": int(r.paused_tasks),
        "cost": float(r.cost),
        "wall_ms": float(r.wall_ms),
        "segment_ms": {k: float(v) for k, v in r.segment_ms.items()},
        "stragglers": list(r.stragglers),
        "makespan_ms": float(r.makespan_ms),
    }


def _decode_report(rec: Dict[str, Any]) -> StepReport:
    return StepReport(
        step=int(rec["step"]),
        live_tasks=int(rec["live_tasks"]),
        paused_tasks=int(rec["paused_tasks"]),
        cost=float(rec["cost"]),
        wall_ms=float(rec["wall_ms"]),
        segment_ms={k: float(v) for k, v in rec.get("segment_ms", {}).items()},
        stragglers=list(rec.get("stragglers", ())),
        makespan_ms=float(rec.get("makespan_ms", 0.0)),
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
    device_of: Dict[str, Any] = field(default_factory=dict)  # placed backends only


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

    Stepping runs in one of two modes (:meth:`configure_stepping`):
    ``"sync"`` — a single-thread sweep in launch order — or
    ``"concurrent"`` — a dependency-aware ready-queue dispatch where every
    segment whose boundary producers have finished steps at once on a
    thread pool (simulated clock on the dry-run backend). Both modes
    produce identical sink digests: concurrent dispatch respects the same
    producer-before-consumer order the launch-order sweep implies, and the
    broker's per-topic sequencing enforces it on the data path.
    """

    name: str = ""
    # Whether concurrent mode actually uses threads. The dry-run backend
    # flips this off: it keeps the dependency-DAG *makespan model* (wave
    # max, not wave sum) but steps on the caller's thread.
    concurrent_dispatch: bool = True

    def __init__(self, step_mode: str = "sync", max_workers: Optional[int] = None) -> None:
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
        self._waves_cache: Optional[List[List[str]]] = None
        self._order_cache: Optional[List[str]] = None  # launch order, for the sync sweep
        # stepping pipeline knobs (see configure_stepping)
        if step_mode not in STEP_MODES:
            raise ValueError(f"step_mode must be one of {STEP_MODES}, got {step_mode!r}")
        self.step_mode = step_mode
        self.max_workers = max_workers
        # Persistent dispatch pool for concurrent stepping, created lazily
        # on the first concurrent step and reused across steps (pool
        # spin-up costs more than a small step); dropped when max_workers
        # changes and on close().
        self._pool: Optional[ThreadPoolExecutor] = None
        self.on_wave: Optional[Callable[[WaveEvent], None]] = None
        # cluster-plane health surface: every backend accepts the hook, the
        # single-process backends just never emit (worker_health() -> None)
        self.worker_events: List[Any] = []
        self.on_worker_event: Optional[Callable[[Any], None]] = None
        # opt-in StepReport ring buffer: bounds self.reports in memory AND
        # persists the tail in checkpoints (None = unbounded, not persisted)
        self.history_limit: Optional[int] = None
        # straggler tracking: per-segment step-time EWMAs, and the log of
        # segments a placed backend moved to another slot
        self.ewma_ms: Dict[str, float] = {}
        self.redispatches: List[Tuple[int, str]] = []
        self.reports: List[StepReport] = []
        # state-leaf encoder used by dump_state/_dump_extra — swapped for a
        # deferring marker during background-checkpoint snapshots
        self._state_encoder: Callable[[Any], Any] = encode_pytree
        # telemetry plane (repro_torch.obs): a per-backend metrics registry
        # (so tests running many systems in one process don't
        # cross-pollute) and a span tracer, disabled until
        # configure_obs(trace=True)
        self.metrics: MetricsRegistry = MetricsRegistry()
        self.tracer = Tracer(enabled=False)
        self._mint_instruments()

    def _mint_instruments(self) -> None:
        """Pre-mint the hot-path instruments so step() does no name lookups."""
        m = self.metrics
        self._m_steps = m.counter("repro_steps_total", "data-plane steps completed")
        self._m_step_wall = m.histogram("repro_step_wall_ms", "whole-step wall time (ms)")
        self._m_seg_ms = m.histogram("repro_segment_step_ms", "per-segment step time (ms)")
        self._m_live = m.gauge("repro_tasks_live", "live (active) deployed tasks")
        self._m_paused = m.gauge("repro_tasks_paused", "paused deployed tasks")
        self._m_cost = m.gauge("repro_cost_cores", "core-equivalents consumed by the last step")

    def configure_obs(
        self,
        metrics: Optional[bool] = None,
        trace: Optional[bool] = None,
        sample_stride: Optional[int] = None,
        trace_capacity: Optional[int] = None,
    ) -> "ExecutionBackend":
        """Telemetry knobs (None leaves a knob unchanged).

        ``metrics=False`` swaps the registry for a no-op twin (the honest
        baseline of an overhead measurement); ``trace=True`` arms span
        recording at ``sample_stride`` (record every Nth span per name).
        """
        if metrics is not None:
            self.metrics = MetricsRegistry() if metrics else NULL_REGISTRY
            self._mint_instruments()
        if trace is not None or sample_stride is not None or trace_capacity is not None:
            self.tracer.configure(enabled=trace, sample_stride=sample_stride, capacity=trace_capacity)
        return self

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Aggregated metrics snapshot."""
        return self.metrics.snapshot()

    def drain_spans(self) -> List[Dict[str, Any]]:
        """Pop all buffered trace spans."""
        return self.tracer.drain()

    def configure_stepping(
        self,
        step_mode: Optional[str] = None,
        max_workers: Optional[int] = None,
        on_wave: Optional[Callable[[WaveEvent], None]] = None,
        report_history: Optional[int] = None,
    ) -> "ExecutionBackend":
        """Set the stepping-pipeline knobs (None leaves a knob unchanged).

        Safe between steps at any point in the lifecycle — switching
        ``step_mode`` mid-run changes only the dispatch schedule, never
        the results.
        """
        if step_mode is not None:
            if step_mode not in STEP_MODES:
                raise ValueError(f"step_mode must be one of {STEP_MODES}, got {step_mode!r}")
            self.step_mode = step_mode
        if max_workers is not None and max_workers != self.max_workers:
            self.max_workers = max_workers
            self._reset_pool()  # resize on next concurrent step
        if on_wave is not None:
            self.on_wave = on_wave
        if report_history is not None:
            if report_history < 1:
                raise ValueError("report_history must be >= 1")
            self.history_limit = report_history
        return self

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
        ``None`` to report the wall time measured around the call. In
        concurrent mode this runs on a dispatch thread; it may touch only
        its own segment plus thread-safe transports (the broker).
        """
        raise NotImplementedError

    def _drop_streams(self, seg: Any) -> None:
        """Release any transport resources of a killed segment (broker topics)."""

    def _begin_concurrent_step(self) -> None:
        """Hook before a concurrent dispatch (the torch backend snapshots
        per-topic sequence targets here so boundary reads sync on their
        producers)."""

    def _end_concurrent_step(self) -> None:
        """Hook after a concurrent dispatch completes or fails."""

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
        self._waves_cache = self._order_cache = None
        return seg

    def kill(self, segment_name: str) -> None:
        seg = self.segments.pop(segment_name)
        self.forwarding.pop(segment_name, None)
        self.ewma_ms.pop(segment_name, None)
        self.seg_deps.pop(segment_name, None)
        for deps in self.seg_deps.values():
            deps.discard(segment_name)
        self._waves_cache = self._order_cache = None
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

    # -- stepping pipeline --------------------------------------------------------
    def segment_waves(self) -> List[List[str]]:
        """Topological levels of the segment dependency DAG (cached; segments
        in one wave are independent and step concurrently)."""
        if self._waves_cache is None:
            order = {n: s.spec.created_at for n, s in self.segments.items()}
            self._waves_cache = compute_waves(self.seg_deps, order)
        return self._waves_cache

    def _step_named(self, name: str) -> float:
        seg = self.segments[name]
        s0 = time.perf_counter()
        if self.tracer.enabled:
            with self.tracer.span(name, "segment", step=self.step_count):
                simulated = self._step_one(seg)
        else:
            simulated = self._step_one(seg)
        ms = simulated if simulated is not None else (time.perf_counter() - s0) * 1e3
        self._m_seg_ms.observe(ms)
        return ms

    def _step_segments(self) -> Dict[str, float]:
        """The sync sweep: every segment once, in launch order (topological)."""
        if self._order_cache is None:
            self._order_cache = sorted(self.segments,
                                       key=lambda n: self.segments[n].spec.created_at)
        return {name: self._step_named(name) for name in self._order_cache}

    def _step_segments_concurrent(self) -> Dict[str, float]:
        """Dependency-aware concurrent dispatch (:meth:`_dispatch_concurrent`);
        falls back to the caller's thread when the backend models time
        instead of spending it (``concurrent_dispatch = False``)."""
        if not self.concurrent_dispatch:
            return self._step_segments()
        self._begin_concurrent_step()
        try:
            with self.tracer.span(
                "wave_dispatch", "step", step=self.step_count, segments=len(self.segments),
            ):
                return self._dispatch_concurrent()
        finally:
            self._end_concurrent_step()

    def _dispatch_concurrent(self) -> Dict[str, float]:
        """The ready queue over the persistent pool: every segment steps on
        a dispatch thread as soon as its producers have finished."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.max_workers, thread_name_prefix="repro-step"
            )
        order = {n: s.spec.created_at for n, s in self.segments.items()}
        return run_ready_queue(
            self.seg_deps, self._step_named, self.max_workers, order, pool=self._pool,
            recover=self._step_recover,
        )

    def _reset_pool(self) -> None:
        """Drop the dispatch pool only (recreated lazily at the next
        concurrent step) — the pool-resize half of :meth:`close`, safe to
        call on a live backend."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- cluster-plane hooks (overridden by the multiproc backend) --------------
    def _step_recover(self, name: str, exc: BaseException) -> bool:
        """Attempt to recover from a failed segment step so the dispatch
        loop can re-queue the item instead of erroring the step. Backends
        without a self-healing worker pool decline."""
        return False

    def worker_health(self) -> Optional[Dict[str, Any]]:
        """Worker-pool health snapshot; ``None`` for in-process backends."""
        return None

    def _emit_worker_event(self, kind: str, worker: Optional[int] = None,
                           detail: str = "", ms: float = 0.0) -> None:
        """Record a cluster-plane event and forward it to the user hook.

        A failing user hook must never break recovery, so hook exceptions
        are swallowed after the event is recorded."""
        from repro_torch.cluster.events import WorkerEvent

        event = WorkerEvent(kind=kind, worker=worker, step=self.step_count,
                            detail=detail, ms=ms)
        self.worker_events.append(event)
        if len(self.worker_events) > 256:
            del self.worker_events[:-256]
        if self.on_worker_event is not None:
            try:
                self.on_worker_event(event)
            except Exception:  # pragma: no cover - user-hook safety
                pass

    def close(self) -> None:
        """Release stepping resources (the persistent dispatch pool).

        Idempotent; stepping after close() lazily recreates the pool."""
        self._reset_pool()

    def step(self) -> StepReport:
        if self.tracer.enabled:
            with self.tracer.span("step", "step", step=self.step_count + 1):
                return self._step_impl()
        return self._step_impl()

    def _step_impl(self) -> StepReport:
        t0 = time.perf_counter()
        concurrent = self.step_mode == "concurrent"
        seg_ms = self._step_segments_concurrent() if concurrent else self._step_segments()
        waves = self.segment_waves()
        wave_ms = [
            (max if concurrent else sum)([seg_ms[n] for n in wave if n in seg_ms] or [0.0])
            for wave in waves
        ]
        live, paused_n, cost = self.account()
        stragglers = self._update_stragglers(seg_ms)
        self.step_count += 1
        if self.on_wave is not None:
            for i, wave in enumerate(waves):
                self.on_wave(
                    WaveEvent(step=self.step_count, index=i, segments=tuple(wave),
                              wave_ms=wave_ms[i])
                )
        report = StepReport(
            step=self.step_count,
            live_tasks=live,
            paused_tasks=paused_n,
            cost=cost,
            wall_ms=(time.perf_counter() - t0) * 1e3,
            segment_ms=seg_ms,
            stragglers=stragglers,
            makespan_ms=sum(wave_ms),
        )
        self._m_steps.inc()
        self._m_step_wall.observe(report.wall_ms)
        self._m_live.set(live)
        self._m_paused.set(paused_n)
        self._m_cost.set(cost)
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
    def live_task_count(self) -> int:
        return sum(len(s.live_task_ids()) for s in self.segments.values())

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
            device_of=dict(getattr(self, "device_of", {})),
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
            "ewma_ms": {k: float(v) for k, v in self.ewma_ms.items()},
            "redispatches": [[int(s), n] for s, n in self.redispatches],
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
        reference's backends).
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
        self.ewma_ms = {k: float(v) for k, v in state.get("ewma_ms", {}).items()}
        self.redispatches = [(int(s), n) for s, n in state.get("redispatches", ())]
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

    def segment_latency_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-segment latency digest from the same ``StepReport.segment_ms``
        history that feeds :meth:`latency_samples` (killed segments skipped
        identically), so the fusion calibrator and any monitoring reader
        agree by construction. This — not ``ewma_ms``, a smoothed
        straggler-detection signal that resets when it flags — is the
        canonical per-segment latency surface; use
        ``StreamSystem.segment_latency_ms()`` from the API layer.

        Returns ``{segment: {"mean_ms", "last_ms", "max_ms", "samples"}}``.
        """
        agg: Dict[str, Dict[str, float]] = {}
        for report in self.reports:
            for name, ms in report.segment_ms.items():
                if name not in self.segments:  # killed since — same skip as above
                    continue
                cell = agg.get(name)
                if cell is None:
                    cell = agg[name] = {
                        "mean_ms": 0.0, "last_ms": 0.0, "max_ms": 0.0, "samples": 0, "_sum": 0.0,
                    }
                ms = float(ms)
                cell["_sum"] += ms
                cell["samples"] += 1
                cell["last_ms"] = ms
                cell["max_ms"] = max(cell["max_ms"], ms)
        for cell in agg.values():
            cell["mean_ms"] = cell.pop("_sum") / cell["samples"]
        return agg

    # -- straggler mitigation -----------------------------------------------------
    def _update_stragglers(self, seg_ms: Dict[str, float]) -> List[str]:
        """Fold this step's segment_ms into the EWMAs and flag the segments
        whose EWMA exceeds ``STRAGGLER_FACTOR`` times the median, as the
        reference does; each flag goes to :meth:`_straggler` and into the
        step's report."""
        flagged: List[str] = []
        for name, ms in seg_ms.items():
            prev = self.ewma_ms.get(name)
            self.ewma_ms[name] = ms if prev is None else (
                EWMA_ALPHA * ms + (1 - EWMA_ALPHA) * prev
            )
        # prune EWMAs of killed segments
        for name in list(self.ewma_ms):
            if name not in self.segments:
                del self.ewma_ms[name]
        if len(self.ewma_ms) >= 2:
            vals = sorted(self.ewma_ms.values())
            median = vals[len(vals) // 2]
            for name, ew in list(self.ewma_ms.items()):
                if median > STRAGGLER_MIN_MEDIAN_MS and ew > STRAGGLER_FACTOR * median:
                    flagged.append(name)
                    self._straggler(name)
        return flagged

    def _straggler(self, segment_name: str) -> None:
        """A flagged straggler. In process there is nowhere to move it: its
        EWMA is reset (judged afresh). A placed backend (the multiproc
        workers, :class:`~repro_torch.runtime.scheduler.PlacedBackendMixin`)
        asks its placement policy and moves it, and logs the move in
        ``redispatches``."""
        del self.ewma_ms[segment_name]

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
    "multiproc": ("repro_torch.runtime.worker", "MultiprocBackend"),
    "sharded": ("repro_torch.runtime.sharded", "ShardedBackend"),
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
