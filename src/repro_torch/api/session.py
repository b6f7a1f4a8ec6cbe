"""ReuseSession — the facade over control plane and data plane.

The port's copy of ``repro.api.session``. One object owns the paper's
§4.3 Manager lifecycle: submissions, removals, defragmentation, execution
and observability. By default the session is control-plane only (a
:class:`~repro_torch.core.manager.ReuseManager`); with ``execute=True`` it
owns a full :class:`~repro_torch.runtime.system.StreamSystem` driving a
pluggable :class:`~repro_torch.runtime.backend.ExecutionBackend`:
``backend="torch"`` (default — the data plane streams event batches
through the port's operators and kernels, on the card unless
``device="cpu"``), ``"multiproc"`` (the same segments stepped inside
persistent worker processes over a shared-memory or TCP stream transport —
``workers=`` sizes the pool, ``transport=`` picks the wire,
``backend_options=`` the rest) or ``"dryrun"`` (pure cost-model stepping —
full OPMW trace sweeps in milliseconds).

    session = ReuseSession(strategy="signature", execute=True, device="cpu")
    session.on_merge(lambda ev: print("merged", ev.name, "→", ev.running_dag))
    session.on_step(lambda ev: print(ev.live_tasks, ev.cost))
    receipt = session.submit(flow("alice").source("urban")...)
    batch = session.submit_many([flow_b, flow_c])
    session.run(5)
    print(session.stats().task_reduction)

Durability: ``checkpoint_dir=`` (plus ``checkpoint_every=N`` steps for an
automatic cadence) makes the whole system crash-recoverable —
``ReuseSession.restore(checkpoint_dir)`` rebuilds control plane *and* data
plane from the newest valid checkpoint and resumes exactly where the
crashed process stopped (see :mod:`repro_torch.runtime.checkpoint`), on
the same device or another.

Concurrent stepping (``step_mode="concurrent"``, ``max_workers``,
``on_wave``) and the telemetry plane (``configure_obs``,
``metrics_snapshot``, ``prometheus_text``, ``drain_spans``,
``export_chrome_trace``, ``segment_latency_ms``) and the worker plane's
``on_worker_event`` and ``worker_health`` are the reference's, and so is
the cluster plane: ``supervise=`` (a worker supervisor that recovers a
lost worker) and ``autoscale=`` (the pool resized on its pressure), on
``backend="multiproc"``; any other backend raises the reference's
``ValueError``. ``backend="sharded"`` places segments across devices.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from repro_torch.core import DataflowError, ReuseManager
from repro_torch.core.graph import Dataflow
from repro_torch.core.manager import RemovalReceipt, SubmissionReceipt
from repro_torch.core.strategies import MergeStrategy

from .builder import DataflowBuilder, as_dataflow
from .events import (
    BatchSubmitReceipt,
    DefragEvent,
    MergeEvent,
    SessionStats,
    StepEvent,
    UnmergeEvent,
    WaveEvent,
)

Submittable = Union[Dataflow, DataflowBuilder]
Hook = Callable[[Any], None]



class ReuseSession:
    def __init__(
        self,
        strategy: Union[str, MergeStrategy] = "signature",
        *,
        execute: bool = False,
        backend: Union[str, Any] = "torch",
        device: Optional[Any] = None,
        base_batch: int = 32,
        check_invariants: bool = False,
        journal_path: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_keep_last: Optional[int] = None,
        checkpoint_background: Optional[bool] = None,
        step_mode: Optional[str] = None,
        max_workers: Optional[int] = None,
        report_history: Optional[int] = None,
        system: Optional[Any] = None,
        on_merge: Optional[Hook] = None,
        on_unmerge: Optional[Hook] = None,
        on_defrag: Optional[Hook] = None,
        on_step: Optional[Hook] = None,
        on_wave: Optional[Hook] = None,
        transport: Optional[Any] = None,
        workers: Optional[int] = None,
        backend_options: Optional[Dict[str, Any]] = None,
        supervise: Union[bool, Dict[str, Any]] = False,
        autoscale: Optional[Union[bool, Dict[str, Any]]] = None,
        on_worker_event: Optional[Hook] = None,
    ):
        self._hooks: Dict[str, List[Hook]] = {
            "merge": [],
            "unmerge": [],
            "defrag": [],
            "step": [],
            "wave": [],
        }
        if on_merge:
            self._hooks["merge"].append(on_merge)
        if on_unmerge:
            self._hooks["unmerge"].append(on_unmerge)
        if on_defrag:
            self._hooks["defrag"].append(on_defrag)
        if on_step:
            self._hooks["step"].append(on_step)
        if on_wave:
            self._hooks["wave"].append(on_wave)
        self._system = None
        if system is not None:
            # Wrap an existing StreamSystem (the restore() path) — hooks
            # and stepping knobs passed alongside apply to the wrapped
            # planes; checkpoint wiring and the device are the system's
            # own and cannot be changed here (pass them to
            # StreamSystem/restore instead).
            rebind = {
                "device": device,
                "checkpoint_dir": checkpoint_dir,
                "checkpoint_every": checkpoint_every,
                "checkpoint_keep_last": checkpoint_keep_last,
                "checkpoint_background": checkpoint_background,
                "transport": transport,
                "workers": workers,
                "backend_options": backend_options,
                "supervise": supervise or None,
                "autoscale": autoscale,
                "on_worker_event": on_worker_event,
            }
            if any(v is not None for v in rebind.values()):
                names = ", ".join(k for k, v in rebind.items() if v is not None)
                raise DataflowError(
                    f"{names} cannot be changed when wrapping an existing "
                    "StreamSystem — configure them on the system (or pass "
                    "them to ReuseSession.restore / StreamSystem.restore)"
                )
            self._system = system
            self.manager = system.manager
            system.backend.configure_stepping(
                step_mode=step_mode,
                max_workers=max_workers,
                on_wave=self._dispatch_wave,
                report_history=report_history,
            )
        elif execute:
            from repro_torch.runtime.system import StreamSystem

            self._system = StreamSystem(
                strategy=strategy,
                base_batch=base_batch,
                check_invariants=check_invariants,
                journal_path=journal_path,
                backend=backend,
                device=device,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                checkpoint_keep_last=checkpoint_keep_last,
                checkpoint_background=bool(checkpoint_background),
                step_mode=step_mode,
                max_workers=max_workers,
                on_wave=self._dispatch_wave,
                report_history=report_history,
                transport=transport,
                workers=workers,
                backend_options=backend_options,
                supervise=supervise,
                autoscale=autoscale,
                on_worker_event=on_worker_event,
            )
            self.manager: ReuseManager = self._system.manager
        else:
            bad = {
                "device": device,
                "checkpoint_dir": checkpoint_dir,
                "checkpoint_every": checkpoint_every,
                "checkpoint_keep_last": checkpoint_keep_last,
                "checkpoint_background": checkpoint_background,
                "step_mode": step_mode,
                "max_workers": max_workers,
                "report_history": report_history,
                "transport": transport,
                "workers": workers,
                "backend_options": backend_options,
                "supervise": supervise or None,
                "autoscale": autoscale,
                "on_worker_event": on_worker_event,
            }
            if any(v is not None for v in bad.values()):
                names = ", ".join(k for k, v in bad.items() if v is not None)
                raise DataflowError(
                    f"{names} need a data plane — create the session with "
                    "execute=True (the control plane is journaled via "
                    "journal_path)"
                )
            self.manager = ReuseManager(
                strategy=strategy,
                check_invariants=check_invariants,
                journal_path=journal_path,
            )

    def _dispatch_wave(self, event: WaveEvent) -> None:
        if self._hooks["wave"]:
            self._emit("wave", event)

    # -- construction helpers ------------------------------------------------
    @classmethod
    def restore(cls, path: str, **kwargs: Any) -> "ReuseSession":
        """Rebuild a session from durable state.

        Two flavors, dispatched on what ``path`` holds:

        * a **checkpoint directory** (or one ``ckpt-*.json`` file) — full
          crash recovery: replay the control-plane journal, redeploy every
          data-plane segment on the checkpointed backend (or ``backend=``
          for a cross-backend restore, ``device=`` for another device),
          re-pause, re-attach any ``on_merge``/``on_step``/... hooks passed
          here, and resume stepping with trajectories identical to an
          uninterrupted run. The restored session keeps checkpointing into
          the same directory at the checkpointed cadence unless overridden.
        * a **journal file** — the control-plane-only restore
          (``execute=False``).
        """
        import os

        from repro_torch.runtime.checkpoint import is_checkpoint_path

        if os.path.isdir(path) or is_checkpoint_path(path):
            from repro_torch.runtime.system import StreamSystem

            hooks = {
                k: kwargs.pop(k, None)
                for k in ("on_merge", "on_unmerge", "on_defrag", "on_step", "on_wave")
            }
            system = StreamSystem.restore(path, **kwargs)
            return cls(system=system, **{k: v for k, v in hooks.items() if v})
        session = cls(**kwargs)
        if session._system is not None:
            raise DataflowError(
                "restore() from a journal rebuilds the control plane only "
                "(execute=False); restore from a checkpoint directory for the data plane"
            )
        session.manager = ReuseManager.restore(
            path,
            strategy=session.manager._strategy,
            check_invariants=session.manager.check_invariants,
        )
        return session

    def checkpoint(self, checkpoint_dir: Optional[str] = None) -> str:
        """Write one durable full-system checkpoint; returns its path."""
        return self._require_system("checkpoint").checkpoint(checkpoint_dir)

    # -- properties -----------------------------------------------------------
    @property
    def strategy(self) -> str:
        return self.manager.strategy

    @property
    def executes(self) -> bool:
        """True when the session owns a data plane (StreamSystem)."""
        return self._system is not None

    @property
    def backend_name(self) -> Optional[str]:
        """Registry name of the data-plane backend (None for control-plane)."""
        if self._system is None:
            return None
        return self._system.backend.name or type(self._system.backend).__name__

    @property
    def names(self) -> List[str]:
        """Names of currently submitted dataflows."""
        return sorted(self.manager.submitted)

    @property
    def running_task_count(self) -> int:
        return self.manager.running_task_count

    @property
    def submitted_task_count(self) -> int:
        return self.manager.submitted_task_count

    # -- hooks ----------------------------------------------------------------
    def on_merge(self, fn: Hook) -> Hook:
        """Register a merge observer (usable as a decorator)."""
        self._hooks["merge"].append(fn)
        return fn

    def on_unmerge(self, fn: Hook) -> Hook:
        self._hooks["unmerge"].append(fn)
        return fn

    def on_defrag(self, fn: Hook) -> Hook:
        self._hooks["defrag"].append(fn)
        return fn

    def on_step(self, fn: Hook) -> Hook:
        """Register a per-step observer (fires on ``step()`` and ``run()``)."""
        self._hooks["step"].append(fn)
        return fn

    def on_wave(self, fn: Hook) -> Hook:
        """Register a wave observer: one :class:`WaveEvent` per dependency
        wave per step (which segments stepped together, and the wave's
        contribution to the step makespan)."""
        self._hooks["wave"].append(fn)
        return fn

    def _emit(self, kind: str, event: Any) -> None:
        for fn in self._hooks[kind]:
            fn(event)

    # -- operations -----------------------------------------------------------
    def submit(self, df: Submittable) -> SubmissionReceipt:
        """Submit one dataflow (builder or Dataflow) — merge per §4.1."""
        dataflow = as_dataflow(df)
        target = self._system if self._system is not None else self.manager
        receipt = target.submit(dataflow)
        self._emit(
            "merge",
            MergeEvent(
                name=receipt.name,
                running_dag=receipt.running_dag,
                num_reused=receipt.num_reused,
                num_created=receipt.num_created,
                batched=False,
                receipt=receipt,
            ),
        )
        return receipt

    def preview(self, df: Submittable, validate: bool = True):
        """Plan a submission without committing it (admission control).

        Returns the :class:`~repro_torch.core.merge.MergePlan` the next
        :meth:`submit` of this dataflow would enact against the current
        running set — ``plan.num_created`` is the number of new running
        tasks. The session (control plane *and* data plane) is left
        untouched.
        """
        return self.manager.preview(as_dataflow(df), validate=validate)

    def submit_many(self, dfs: Iterable[Submittable]) -> BatchSubmitReceipt:
        """Submit a batch with batch-aware planning (one signature pass and
        one merged-DAG rebuild per overlapping group — see
        :meth:`repro_torch.core.manager.ReuseManager.submit_many`)."""
        dataflows = [as_dataflow(df) for df in dfs]
        target = self._system if self._system is not None else self.manager
        receipts = target.submit_many(dataflows)
        for receipt in receipts:
            self._emit(
                "merge",
                MergeEvent(
                    name=receipt.name,
                    running_dag=receipt.running_dag,
                    num_reused=receipt.num_reused,
                    num_created=receipt.num_created,
                    batched=True,
                    receipt=receipt,
                ),
            )
        return BatchSubmitReceipt(receipts=tuple(receipts))

    def remove(self, name: str) -> RemovalReceipt:
        """Remove a submission — unmerge per §4.2."""
        target = self._system if self._system is not None else self.manager
        receipt = target.remove(name)
        self._emit(
            "unmerge",
            UnmergeEvent(
                name=receipt.name,
                terminated_tasks=set(receipt.terminated_tasks),
                surviving_dags=list(receipt.surviving_dags),
                receipt=receipt,
            ),
        )
        return receipt

    def defragment(self) -> DefragEvent:
        """Relaunch fused segments (state-preserving defrag; data plane only)."""
        system = self._require_system("defragment")
        killed = system.defragment()
        event = DefragEvent(
            segments_killed=killed,
            segments_after=len(system.backend.segments),
            deployed_tasks_after=system.deployed_task_count,
        )
        self._emit("defrag", event)
        return event

    def fuse(self, min_length: int = 2, overhead_ms: float = 0.25) -> Dict[str, List[str]]:
        """Fuse linear same-DAG segment chains into single fused segments.

        The depth-only sibling of :meth:`defragment`: private segment-to-
        segment pipes collapse into one segment whose straight-line runs go
        through the multi-op kernels, while paused residue stays untouched.
        Candidate chains are scored against the latency model first (see
        :attr:`fusion_report` for every accept/reject). Returns ``{fused
        segment name: [member names replaced]}``.
        """
        return self._require_system("fuse").fuse(min_length=min_length, overhead_ms=overhead_ms)

    @property
    def fusion_report(self):
        """The last :meth:`fuse` call's planner verdicts
        (:class:`repro_torch.core.defrag.FusionReport`), or ``None``."""
        return self._system.fusion_report if self._system is not None else None

    # -- execution -------------------------------------------------------------
    def step(self):
        report = self._require_system("step").step()
        self._emit_step(report)
        return report

    def run(self, steps: int):
        system = self._require_system("run")
        reports = []
        for _ in range(steps):
            report = system.step()
            self._emit_step(report)
            reports.append(report)
        return reports

    def _emit_step(self, report: Any) -> None:
        if not self._hooks["step"]:
            return
        self._emit(
            "step",
            StepEvent(
                step=report.step,
                live_tasks=report.live_tasks,
                paused_tasks=report.paused_tasks,
                cost=report.cost,
                wall_ms=report.wall_ms,
                report=report,
            ),
        )

    def sink_digests(self, name: str) -> Dict[str, Dict[str, Any]]:
        """Per-sink count/checksum for a submission (output identity check)."""
        return self._require_system("sink_digests").sink_digests(name)

    def quiesce(self) -> None:
        """Drain in-flight data-plane work (concurrent dispatch, queued
        background checkpoints) without releasing anything — see
        :meth:`repro_torch.runtime.system.StreamSystem.quiesce`."""
        self._require_system("quiesce").quiesce()

    def close(self) -> None:
        """Release data-plane resources (the concurrent dispatch pool, the
        background checkpoint writer; a multiproc backend's worker pool and
        transport).

        Idempotent — control-plane state survives; an in-process data plane
        re-creates its pool lazily on the next step."""
        if self._system is not None:
            self._system.close()

    def __enter__(self) -> "ReuseSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _require_system(self, op: str):
        if self._system is None:
            raise DataflowError(
                f"{op}() needs a data plane — create the session with execute=True"
            )
        return self._system

    # -- observability -----------------------------------------------------------
    def verify(self) -> None:
        """Check the §3.3 system invariants (C1 sink coverage, C2 minimization)."""
        self.manager.verify()

    def reuse_counts(self) -> Dict[str, int]:
        return self.manager.reuse_counts()

    def stats(self) -> SessionStats:
        mgr = self.manager
        hist = Counter(mgr.reuse_counts().values()) if mgr.running else Counter()
        deployed = segments = steps = 0
        cache = {"hits": 0, "misses": 0, "evictions": 0, "entries": 0}
        if self._system is not None:
            deployed = self._system.deployed_task_count
            segments = len(self._system.backend.segments)
            steps = self._system.backend.step_count
            cache = self._system.backend.compile_cache_stats()
        return SessionStats(
            strategy=self.strategy,
            submitted_dataflows=len(mgr.submitted),
            running_dataflows=len(mgr.running),
            submitted_task_count=mgr.submitted_task_count,
            running_task_count=mgr.running_task_count,
            reuse_histogram=dict(hist),
            deployed_task_count=deployed,
            segments=segments,
            steps_run=steps,
            backend=self.backend_name,
            compile_cache_hits=cache.get("hits", 0),
            compile_cache_misses=cache.get("misses", 0),
            compile_cache_evictions=cache.get("evictions", 0),
            compile_cache_entries=cache.get("entries", 0),
        )

    def worker_health(self) -> Optional[Dict[str, Any]]:
        """Cluster-plane health snapshot (worker liveness, respawns,
        staleness marking). ``None`` for control-plane sessions and
        in-process backends — only a worker-pool backend can be sick."""
        if self._system is None:
            return None
        return self._system.worker_health()

    # -- telemetry plane (repro_torch.obs) -------------------------------------
    def configure_obs(
        self,
        metrics: Optional[bool] = None,
        trace: Optional[bool] = None,
        sample_stride: Optional[int] = None,
        trace_capacity: Optional[int] = None,
    ) -> "ReuseSession":
        """Turn the metrics registry and/or span tracing on or off.

        ``trace=True`` arms span tracing on every layer (wave dispatch,
        per-segment steps, broker fetch and publish, compile misses,
        merge/unmerge, checkpoints); ``sample_stride=N`` records every Nth
        span per name. ``metrics=False`` swaps in a null registry for
        overhead-sensitive runs. Needs a data plane.
        """
        self._require_system("configure_obs").configure_obs(
            metrics=metrics,
            trace=trace,
            sample_stride=sample_stride,
            trace_capacity=trace_capacity,
        )
        return self

    def enable_tracing(self, sample_stride: int = 1) -> "ReuseSession":
        """Shorthand for ``configure_obs(trace=True, sample_stride=...)``."""
        return self.configure_obs(trace=True, sample_stride=sample_stride)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Metrics snapshot — counters, gauges and histograms as plain
        JSON-safe dicts."""
        return self._require_system("metrics_snapshot").metrics_snapshot()

    def prometheus_text(self) -> str:
        """The snapshot as Prometheus text exposition 0.0.4."""
        return self._require_system("prometheus_text").prometheus_text()

    def drain_spans(self) -> List[Dict[str, Any]]:
        """Drain buffered trace spans (destructive)."""
        return self._require_system("drain_spans").drain_spans()

    def export_chrome_trace(self, path: str) -> int:
        """Drain spans into a Chrome/Perfetto-loadable trace file; returns
        the number of spans written."""
        return self._require_system("export_chrome_trace").export_chrome_trace(path)

    def segment_latency_ms(self) -> Dict[str, Dict[str, float]]:
        """Canonical per-segment step-latency digest (mean/last/max/samples
        in ms) — the same measured samples the fusion calibrator consumes;
        see :meth:`repro_torch.runtime.system.StreamSystem.segment_latency_ms`."""
        return self._require_system("segment_latency_ms").segment_latency_ms()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        plane = f"data[{self.backend_name}]" if self.executes else "control"
        return (
            f"ReuseSession(strategy={self.strategy!r}, plane={plane}, "
            f"submitted={len(self.manager.submitted)}, running_tasks={self.running_task_count})"
        )
