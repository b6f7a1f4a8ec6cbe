"""StreamSystem — the Reusable Dataflow Manager bound to the port's data plane.

Glues the control plane (:class:`repro_torch.core.ReuseManager`) to an
:class:`~repro_torch.runtime.backend.ExecutionBackend` as the paper's §4.3
Manager binds to Storm:

  * ``submit`` — run the merge algorithm; launch one new segment holding the
    created tasks ``T_x``; signal reused boundary tasks (``S_x⁺`` upstream
    ends) to *forward* their derived streams to broker topics.
  * ``remove`` — run the unmerge algorithm; *pause* terminated tasks via the
    control flags (Reuse) or kill the submission's segments outright (the
    Default baseline, which owns its topologies).
  * ``fuse`` — replace each accepted linear chain of segments by one fused
    segment, whose straight-line kernel runs go through the multi-op
    kernels.
  * ``defragment`` — enact :func:`repro_torch.core.defrag.plan_defrag`:
    relaunch one segment per running DAG, carrying task states over,
    dropping paused tasks and broker hops.

Stepping runs in the reference's two modes: ``step_mode="sync"`` steps
segments one after another in launch order; ``"concurrent"`` steps every
segment whose producers have finished at once — on ``max_workers``
dispatch threads, or on the card on ``max_workers`` CUDA streams that the
stepping thread issues each wave onto — and ``on_wave`` observes each
dependency wave. Both give the same sink digests.

Durability: with ``checkpoint_dir=`` (and optionally ``checkpoint_every=N``
steps) the system writes versioned on-disk checkpoints — control-plane
journal + the backend's full ``dump_state`` — and
:meth:`StreamSystem.restore` rebuilds the whole system from the newest
valid one: replay the journal, redeploy every segment (on the checkpointed
backend, another one, or another device), re-pause, and resume stepping
with trajectories identical to an uninterrupted run. The payload is the
reference's, so checkpoints cross between the packages.

Telemetry (:mod:`repro_torch.obs`): the backend owns the metrics
registry and the span tracer; the system wires the control plane and the
checkpoint store into them and mirrors broker, compile-cache and reuse
state into the registry at scrape time (``metrics_snapshot``,
``prometheus_text``, ``drain_spans``, ``export_chrome_trace``), under the
reference's metric and span names.

Worker processes (the reference's multiproc plane): ``backend="multiproc"``
steps the segments inside ``workers`` spawned processes on the card (or
the CPU with ``device="cpu"``), boundary streams over ``transport``
(``"shm"`` or ``"tcp"``); ``backend_options`` carries the backend's other
knobs (placement, step batching, launcher, worker plane), ``on_worker_event``
observes the cluster plane's events and :meth:`StreamSystem.worker_health`
reports the pool. ``supervise=`` arms the worker supervisor
(:class:`repro_torch.cluster.WorkerSupervisor`: heartbeats, in-step
recovery of a lost worker from spill or wire snapshots) and
``autoscale=`` the autoscaler (:class:`repro_torch.cluster.Autoscaler`,
fed one observation after every step). A checkpoint records the pool
(workers, transport, placement) and a restore onto ``"multiproc"``
re-spawns it. ``backend="sharded"`` places the segments across devices
(:class:`repro_torch.runtime.sharded.ShardedBackend`).

The port's copy of ``repro.runtime.system``. The data plane runs on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import os
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Set, Union

from repro_torch.core import MergeStrategy, ReuseManager
from repro_torch.core.defrag import (
    FusionPlan,
    FusionReport,
    canonical_parents,
    plan_defrag,
    plan_fusion,
    score_fusion_plan,
)
from repro_torch.core.graph import Dataflow
from repro_torch.core.manager import RemovalReceipt, SubmissionReceipt
from repro_torch.obs import render_prometheus, write_chrome_trace

from .backend import ExecutionBackend, SegmentSpec, StepReport, compute_batches, resolve_backend
from .checkpoint import BackgroundCheckpointWriter, CheckpointStore, deferred_encoder
from .scheduler import Placement, place_round_robin

# the reference's in-process backend is the port's torch backend: a payload
# of the one restores on the other with its backend_config (the transport)
_PORT_BACKEND = {"inprocess": "torch"}


class StreamSystem:
    def __init__(
        self,
        strategy: Union[str, MergeStrategy] = "signature",
        base_batch: int = 32,
        check_invariants: bool = False,
        journal_path: Optional[str] = None,
        backend: Union[str, ExecutionBackend] = "torch",
        device: Optional[Any] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_keep_last: Optional[int] = None,
        checkpoint_background: bool = False,
        step_mode: Optional[str] = None,
        max_workers: Optional[int] = None,
        on_wave: Optional[Any] = None,
        report_history: Optional[int] = None,
        transport: Optional[Any] = None,
        workers: Optional[int] = None,
        backend_options: Optional[Dict[str, Any]] = None,
        supervise: Union[bool, Dict[str, Any]] = False,
        autoscale: Optional[Union[bool, Dict[str, Any]]] = None,
        on_worker_event: Optional[Any] = None,
    ):
        self.manager = ReuseManager(
            strategy=strategy, check_invariants=check_invariants, journal_path=journal_path
        )
        # Backend construction knobs: `transport=` picks the stream
        # transport ("shm"/"tcp"), `workers=` sizes the multiproc worker
        # pool, `device=` places the data plane; anything else rides in
        # backend_options. They apply when the backend is named (or a
        # class) — a pre-built instance already made those choices.
        options: Dict[str, Any] = dict(backend_options or {})
        if transport is not None:
            options["transport"] = transport
        if workers is not None:
            options["workers"] = workers
        if device is not None:
            options["device"] = device
        if options and isinstance(backend, ExecutionBackend):
            raise ValueError(
                "device=/transport=/workers=/backend_options= need a backend name or "
                "class: a backend instance is already constructed"
            )
        self.backend = resolve_backend(backend, **options)
        if on_worker_event is not None:
            self.backend.on_worker_event = on_worker_event
        self.backend.configure_stepping(
            step_mode=step_mode,
            max_workers=max_workers,
            on_wave=on_wave,
            report_history=report_history,
        )
        self.base_batch = base_batch
        self.task_batch: Dict[str, int] = {}  # running task id -> output batch size
        self._seg_counter = 0
        self._segments_of: Dict[str, List[str]] = {}  # submission -> segment names
        # Last fusion planner verdicts (every accept/reject with reasons) —
        # refreshed by each fuse() call.
        self.fusion_report: Optional[FusionReport] = None
        if checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every needs a checkpoint_dir")
        if checkpoint_keep_last and not checkpoint_dir:
            raise ValueError("checkpoint_keep_last needs a checkpoint_dir")
        if checkpoint_background and not checkpoint_dir:
            raise ValueError("checkpoint_background needs a checkpoint_dir")
        self.checkpoint_keep_last = checkpoint_keep_last
        self.checkpoint_store = (
            CheckpointStore(checkpoint_dir, keep_last=checkpoint_keep_last)
            if checkpoint_dir
            else None
        )
        self.checkpoint_every = checkpoint_every
        # Background checkpointing: the auto-cadence snapshots on the
        # stepping thread (reference capture) and copies to the host,
        # encodes, fsyncs and renames on a writer thread, so
        # checkpoint_every=1 does not pause stepping.
        self.checkpoint_background = bool(checkpoint_background)
        self._ckpt_writer: Optional[BackgroundCheckpointWriter] = None
        # Cluster plane (multiproc only): `supervise=` arms self-healing —
        # a heartbeat thread plus in-step recovery respawn dead/hung
        # workers and redeploy their segments from shadow snapshots;
        # `autoscale=` resizes the worker pool on the EWMA pressure signal
        # after every step. Both accept True or a dict of knobs.
        self._supervisor = None
        self._autoscaler = None
        if supervise:
            from repro_torch.cluster import WorkerSupervisor

            sup_kwargs = supervise if isinstance(supervise, dict) else {}
            self._supervisor = WorkerSupervisor(self.backend, **sup_kwargs).start()
        if autoscale:
            from repro_torch.cluster import Autoscaler

            scale_kwargs = autoscale if isinstance(autoscale, dict) else {}
            self._autoscaler = Autoscaler(self.backend, **scale_kwargs)
        # Telemetry plane: the backend owns the registry and tracer; the
        # system wires the control plane and durability layer into them
        # and contributes a snapshot-time collector mirroring broker /
        # compile-cache / reuse-savings state — scrape-time work only,
        # never on the stepping hot path.
        self.manager.tracer = self.backend.tracer
        if self.checkpoint_store is not None:
            self._wire_checkpoint_store(self.checkpoint_store)
        self._obs_registry: Optional[Any] = None
        self._wire_collectors()

    @property
    def executor(self) -> ExecutionBackend:
        """The reference's alias of the data plane."""
        return self.backend

    @property
    def strategy(self) -> str:
        return self.manager.strategy

    @property
    def reuses(self) -> bool:
        return self.manager._strategy.reuses

    def _mint_segment(self) -> str:
        self._seg_counter += 1
        return f"seg{self._seg_counter}"

    def _span(self, name: str, **args: Any):
        """A "control"-category span on the backend's tracer (no-op when
        tracing is off)."""
        tracer = self.backend.tracer
        if tracer.enabled:
            return tracer.span(name, "control", **args)
        return nullcontext()

    # -- operations ---------------------------------------------------------------
    def submit(self, df: Dataflow) -> SubmissionReceipt:
        receipt = self.manager.submit(df)
        self._deploy(receipt)
        return receipt

    def submit_many(self, dfs: Sequence[Dataflow]) -> List[SubmissionReceipt]:
        """Batch submit: one batch-aware control-plane pass, then one segment
        per member's created tasks, deployed in batch order (so boundary
        streams between batch members flow older segment → newer, keeping the
        backend's launch-order invariant)."""
        receipts = self.manager.submit_many(dfs)
        for receipt in receipts:
            self._deploy(receipt)
        return receipts

    def _deploy(self, receipt: SubmissionReceipt) -> None:
        run_df = self.manager.running[receipt.running_dag]
        created: Set[str] = set(receipt.plan.created.values())
        if not created:  # fully contained in running DAGs — nothing to launch
            self._segments_of[receipt.name] = []
            return

        canon = canonical_parents(run_df)
        order = [tid for tid in run_df.topological_order() if tid in created]
        parents = {tid: canon[tid] for tid in order}
        self.task_batch = compute_batches(order, parents, self.task_batch, self.base_batch)

        # Control signal: reused upstream ends of boundary streams forward
        # their derived stream to the broker (paper's control topic).
        for up_id, _down in receipt.plan.new_streams_boundary:
            self.backend.forward(up_id)

        spec = SegmentSpec(
            name=self._mint_segment(),
            dag_name=receipt.running_dag,
            task_ids=order,
            parents=parents,
            publish=set(),
            batch_of={t: self.task_batch[t] for t in order},
        )
        self.backend.deploy(spec, run_df)
        self._segments_of[receipt.name] = [spec.name]

    def remove(self, name: str) -> RemovalReceipt:
        own_segments = self._segments_of.pop(name, [])
        receipt = self.manager.remove(name)
        if not self.reuses:
            # Default: the submission owns its topologies — kill them.
            for seg_name in own_segments:
                if seg_name in self.backend.segments:
                    self.backend.kill(seg_name)
        else:
            # Reuse: Storm can't kill a subset of a topology — pause instead.
            self.backend.pause(set(receipt.terminated_tasks))
        # Terminated running-task ids are never re-minted, so their batch
        # entries are dead either way (paused tasks keep the batch copied
        # into their SegmentSpec).
        for tid in receipt.terminated_tasks:
            self.task_batch.pop(tid, None)
        return receipt

    def defragment(self) -> int:
        """Relaunch one segment per running DAG; returns segments killed.

        The relaunched segments are built as the reference builds them (not
        fusion-built), so their specs, payloads and compile-cache keys are
        the reference's."""
        with self._span("defrag", segments=len(self.backend.segments)):
            return self._defragment_impl()

    def _defragment_impl(self) -> int:
        plan = plan_defrag(self.manager.running)
        killed = len(self.backend.segments)
        # Carry live task states across the relaunch (beyond-paper:
        # state-preserving defrag — Storm would restart cold).
        carried: Dict[str, Any] = {}
        live: Set[str] = set()
        for fused in plan.fused:
            live |= set(fused.order)
        for seg in list(self.backend.segments.values()):
            for tid in seg.spec.task_ids:
                if tid in live:
                    carried[tid] = seg.states[tid]
        for seg_name in list(self.backend.segments):
            self.backend.kill(seg_name)
        for fused in plan.fused:
            run_df = self.manager.running[fused.dag_name]
            spec = SegmentSpec(
                name=self._mint_segment(),
                dag_name=fused.dag_name,
                task_ids=fused.order,
                parents=fused.parents,
                publish=set(),
                batch_of={t: self.task_batch[t] for t in fused.order},
            )
            self.backend.deploy(
                spec, run_df, init_states={t: carried[t] for t in fused.order if t in carried}
            )
        # Dropped paused tasks are no longer deployed anywhere — their batch
        # entries go with them.
        self.task_batch = {t: b for t, b in self.task_batch.items() if t in live}
        # Segment ownership bookkeeping: after defrag, segments are shared —
        # submissions no longer own segments (only meaningful for Default,
        # which never defragments).
        for sub in self._segments_of:
            self._segments_of[sub] = []
        return killed

    def _score_fusion(self, plan: FusionPlan, overhead_ms: float) -> FusionReport:
        """Score a fusion plan with the latency model fit on this backend's
        measured segment times; before any sample exists every segment
        models as 0 ms and all private-pipe chains are accepted."""
        from repro_torch.ops.costs import cost_weight_for_task, fit_latency_model

        backend = self.backend
        samples = backend.latency_samples()
        model = fit_latency_model(samples) if samples else None
        seg_ms: Dict[str, float] = {}
        for name, seg in backend.segments.items():
            if model is None:
                seg_ms[name] = 0.0
                continue
            units: Dict[str, float] = {}
            for tid in seg.spec.task_ids:
                task = backend.task_defs[tid]
                units[task.type] = units.get(task.type, 0.0) + (
                    cost_weight_for_task(task) * seg.spec.batch_of[tid]
                )
            seg_ms[name] = model.segment_ms(units)
        return score_fusion_plan(
            plan,
            backend.seg_deps,
            seg_ms,
            slot_of=getattr(backend, "device_of", None),
            n_slots=backend._n_slots() if hasattr(backend, "_n_slots") else 1,
            overhead_ms=overhead_ms,
        )

    def _migrate_chain(self, members: List[str], target: int) -> None:
        """Consolidate a chain's members onto one slot before fusing.

        Cross-worker chains must be worker-local before the fused segment
        is built (it lives on exactly one worker); the straggler-migration
        machinery moves them — states RPC, kill, redeploy with carried
        states and re-applied pauses. Backends without placement have
        nothing to do.
        """
        device_of = getattr(self.backend, "device_of", None)
        if device_of is None:
            return
        for m in members:
            cur = device_of.get(m)
            if cur is None or cur == target:
                continue
            self.backend._move_segment(self.backend.segments[m], cur, target)
            device_of[m] = target

    def fuse(self, min_length: int = 2, overhead_ms: float = 0.25) -> Dict[str, List[str]]:
        """Fuse linear same-DAG segment chains into single fused segments.

        Enacts :func:`repro_torch.core.defrag.plan_fusion`: each maximal
        chain of segments joined by private (no fan-in/fan-out) boundary
        streams is replaced by ONE segment, whose intermediate streams stop
        going through broker topics and whose straight-line kernel runs go
        through the multi-op kernels. Candidate chains are scored first
        (:func:`repro_torch.core.defrag.score_fusion_plan`); every verdict
        lands in :attr:`fusion_report`.

        Returns ``{fused segment name: [member names replaced]}``.
        """
        with self._span("fuse", segments=len(self.backend.segments)):
            return self._fuse_impl(min_length, overhead_ms)

    def _fuse_impl(self, min_length: int, overhead_ms: float) -> Dict[str, List[str]]:
        dag_of = {n: s.spec.dag_name for n, s in self.backend.segments.items()}
        plan = plan_fusion(self.backend.seg_deps, dag_of, min_length=min_length)
        self.fusion_report = self._score_fusion(plan, overhead_ms=overhead_ms)
        fused: Dict[str, List[str]] = {}
        for decision in self.fusion_report.decisions:
            if not decision.accepted:
                continue
            chain = decision.chain
            members = chain.members
            if any(m not in self.backend.segments for m in members):
                continue  # stale plan entry: never fuse over a dead segment
            self._migrate_chain(members, decision.target_slot)
            specs = [self.backend.segments[m].spec for m in members]
            # Chain order is upstream→downstream and member task_ids are
            # topological, so concatenation is topological for the union.
            combined: List[str] = []
            parents: Dict[str, List[str]] = {}
            batch_of: Dict[str, int] = {}
            for s in specs:
                combined.extend(s.task_ids)
                parents.update({t: list(s.parents[t]) for t in s.task_ids})
                batch_of.update(s.batch_of)
            # Keep every member's current forwarding set: a forwarded topic
            # may also feed external segments or observers.
            publish: Set[str] = set()
            for m in members:
                publish |= self.backend.forwarding.get(m, set())
            # Synthetic task-definition container: fused chains may hold
            # paused tasks that the manager's running DAG no longer lists.
            df = Dataflow(chain.dag_name)
            for tid in combined:
                df.add_task(self.backend.task_defs[tid])
            spec = SegmentSpec(
                name=self._mint_segment(),
                dag_name=chain.dag_name,
                task_ids=combined,
                parents=parents,
                publish=publish,
                batch_of=batch_of,
                # the reference's flag: under background checkpointing its
                # fused step does not donate, and the payload says so
                fused=not self.checkpoint_background,
            )
            # Deploy the fused segment where its members were consolidated —
            # placed backends consult the pin before their placement policy.
            pins = getattr(self.backend, "_pin_slot", None)
            if pins is not None:
                pins[spec.name] = decision.target_slot
            self.backend.fuse_segments(spec, df, members)
            # Reuse-savings attribution, recorded where the decision lands:
            # every accepted chain dispatches one segment where it used to
            # dispatch len(members).
            self.backend.metrics.counter(
                "repro_fusion_segments_saved_total",
                "segment dispatches eliminated per step by accepted chain "
                "fusion (chain length − 1 per fused chain)",
            ).inc(len(members) - 1)
            members_set = set(members)
            for sub, segs in self._segments_of.items():
                if any(s in members_set for s in segs):
                    merged: List[str] = []
                    for s in segs:
                        repl = spec.name if s in members_set else s
                        if repl not in merged:
                            merged.append(repl)
                    self._segments_of[sub] = merged
            fused[spec.name] = list(members)
        return fused

    # -- execution -----------------------------------------------------------------
    def step(self) -> StepReport:
        report = self.backend.step()
        mgr = self.manager
        saved = mgr.submitted_task_count - mgr.running_task_count
        if saved > 0 and report.live_tasks:
            # Reuse-savings attribution in the paper's Fig. 3 cost units:
            # each step, reuse avoided running `saved` tasks that Default
            # would have stepped — modelled at this step's per-live-task
            # cost. Accumulated here (where the step happens), mirrored out
            # by the scrape.
            self.backend.metrics.counter(
                "repro_reuse_core_steps_avoided_total",
                "modelled core-equivalent step cost avoided by reuse, "
                "accumulated per step (per-live-task cost × tasks saved)",
            ).inc(report.cost / report.live_tasks * saved)
        if (
            self.checkpoint_every
            and self.checkpoint_store is not None
            and self.backend.step_count % self.checkpoint_every == 0
        ):
            if self.checkpoint_background:
                self._checkpoint_async()
            else:
                self.checkpoint()
        if self._autoscaler is not None:
            self._autoscaler.observe(report)
        return report

    def run(self, steps: int) -> List[StepReport]:
        # Route through step() so the auto-checkpoint cadence applies.
        return [self.step() for _ in range(steps)]

    # -- durability (full-system checkpoint/restore) --------------------------------
    def checkpoint_payload(self, state_encoder: Optional[Any] = None) -> Dict[str, Any]:
        """The full durable state: control-plane journal + data-plane dump.

        Deterministic for a given system state (no wall-clock stamps — the
        envelope written by :class:`CheckpointStore` carries those), which
        is what makes ``payload → restore → payload`` a fixed point. The
        keys are the reference's. ``state_encoder`` is forwarded to the
        backend dump — the background checkpointer passes the deferring
        marker encoder."""
        return {
            "backend": self.backend.name or type(self.backend).__name__,
            "backend_config": self.backend.spawn_config(),
            "strategy": self.manager.strategy,
            "journal": list(self.manager.journal),
            "base_batch": int(self.base_batch),
            "seg_counter": int(self._seg_counter),
            "task_batch": {t: int(b) for t, b in self.task_batch.items()},
            "segments_of": {n: list(segs) for n, segs in self._segments_of.items()},
            "checkpoint_every": self.checkpoint_every,
            "checkpoint_keep_last": self.checkpoint_keep_last,
            "checkpoint_background": self.checkpoint_background,
            # Stepping-pipeline config rides along so a restore lands in the
            # same mode by default; the segment dependency DAG itself is
            # derived state and is rebuilt by redeploy, never persisted.
            "step_mode": self.backend.step_mode,
            "max_workers": self.backend.max_workers,
            "data": self.backend.dump_state(state_encoder),
        }

    def _checkpoint_async(self) -> None:
        """Queue a snapshot for the writer thread (auto-cadence path)."""
        if self._ckpt_writer is None:
            self._ckpt_writer = BackgroundCheckpointWriter(self.checkpoint_store)
        self._ckpt_writer.submit(self.checkpoint_payload(deferred_encoder))

    def flush_checkpoints(self) -> None:
        """Block until queued background checkpoints are durably on disk."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.flush()

    def checkpoint(self, checkpoint_dir: Optional[str] = None) -> str:
        """Write one durable checkpoint synchronously; returns its path.

        Queued background checkpoints are flushed first so ids on disk
        stay chronological."""
        store = (
            CheckpointStore(checkpoint_dir, keep_last=self.checkpoint_keep_last)
            if checkpoint_dir
            else self.checkpoint_store
        )
        if store is None:
            raise ValueError(
                "no checkpoint_dir configured — pass one to checkpoint() or the constructor"
            )
        self._wire_checkpoint_store(store)
        self.flush_checkpoints()
        return store.save(self.checkpoint_payload())

    @classmethod
    def from_payload(
        cls,
        payload: Dict[str, Any],
        backend: Optional[Union[str, ExecutionBackend]] = None,
        device: Optional[Any] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_keep_last: Optional[int] = None,
        checkpoint_background: Optional[bool] = None,
        step_mode: Optional[str] = None,
        max_workers: Optional[int] = None,
        on_wave: Optional[Any] = None,
        journal_path: Optional[str] = None,
        check_invariants: bool = False,
        transport: Optional[Any] = None,
        workers: Optional[int] = None,
        backend_options: Optional[Dict[str, Any]] = None,
        supervise: Union[bool, Dict[str, Any]] = False,
        autoscale: Optional[Union[bool, Dict[str, Any]]] = None,
        on_worker_event: Optional[Any] = None,
    ) -> "StreamSystem":
        """Reconstruct a full system from a checkpoint payload.

        Replays the control-plane journal (minting the exact same running
        task ids and DAG names), then redeploys every checkpointed segment
        on the target backend — by default the checkpointed one, or any
        other registered backend for a cross-backend restore. A payload of
        the reference's names its backend (``"inprocess"``) and restores
        here with ``backend="torch"``; its ``backend_config`` applies only
        when the names match: a ``"multiproc"`` payload re-spawns its worker
        pool (workers, transport, placement; the reference's ``"jit"``
        worker plane is the port's ``"torch"``), and explicit
        ``transport=``/``workers=``/``backend_options=`` override it.
        ``device`` places a torch or multiproc backend (the card by
        default). ``step_mode``/``max_workers`` override the checkpointed
        stepping config — a checkpoint taken in either mode restores into
        either mode (the segment dependency DAG is derived state, rebuilt
        by the redeploy)."""
        mgr = ReuseManager.replay(
            payload["journal"],
            strategy=payload["strategy"],
            journal_path=journal_path,
        )
        mgr.check_invariants = check_invariants
        target = backend if backend is not None else payload["backend"]
        options: Dict[str, Any] = {}
        saved = payload.get("backend")
        if isinstance(target, str) and target == _PORT_BACKEND.get(saved, saved):
            options.update(payload.get("backend_config") or {})
        if backend_options:
            options.update(backend_options)
        if transport is not None:
            options["transport"] = transport
        if workers is not None:
            options["workers"] = workers
        if device is not None:
            options["device"] = device
        if options and isinstance(target, ExecutionBackend):
            raise ValueError(
                "device=/transport=/workers=/backend_options= need a backend name: "
                "a backend instance is already constructed")
        system = cls(
            strategy=payload["strategy"],
            base_batch=int(payload["base_batch"]),
            backend=resolve_backend(target, **options),
            supervise=supervise,
            autoscale=autoscale,
            on_worker_event=on_worker_event,
            checkpoint_dir=checkpoint_dir,
            checkpoint_background=(
                checkpoint_background
                if checkpoint_background is not None
                else (bool(payload.get("checkpoint_background", False)) and bool(checkpoint_dir))
            ),
        )
        # The cadence/retention survive the restore even when no
        # checkpoint_dir is configured yet (step() only auto-checkpoints
        # once a store exists), so payload → restore → payload stays a
        # fixed point.
        system.checkpoint_every = (
            checkpoint_every if checkpoint_every is not None else payload.get("checkpoint_every")
        )
        system.checkpoint_keep_last = (
            checkpoint_keep_last
            if checkpoint_keep_last is not None
            else payload.get("checkpoint_keep_last")
        )
        if system.checkpoint_store is not None:
            system.checkpoint_store.keep_last = system.checkpoint_keep_last
        system.backend.configure_stepping(
            step_mode=step_mode if step_mode is not None else payload.get("step_mode"),
            max_workers=max_workers if max_workers is not None else payload.get("max_workers"),
            on_wave=on_wave,
        )
        system.manager = mgr
        system.manager.tracer = system.backend.tracer  # replaced the wired one
        system.task_batch = {t: int(b) for t, b in payload["task_batch"].items()}
        system._seg_counter = int(payload["seg_counter"])
        system._segments_of = {n: list(s) for n, s in payload["segments_of"].items()}
        system.backend.restore_state(payload["data"])
        if check_invariants:
            system.manager.verify()
        return system

    @classmethod
    def restore(
        cls,
        path: str,
        backend: Optional[Union[str, ExecutionBackend]] = None,
        device: Optional[Any] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_keep_last: Optional[int] = None,
        checkpoint_background: Optional[bool] = None,
        step_mode: Optional[str] = None,
        max_workers: Optional[int] = None,
        on_wave: Optional[Any] = None,
        journal_path: Optional[str] = None,
        check_invariants: bool = False,
        transport: Optional[Any] = None,
        workers: Optional[int] = None,
        backend_options: Optional[Dict[str, Any]] = None,
        supervise: Union[bool, Dict[str, Any]] = False,
        autoscale: Optional[Union[bool, Dict[str, Any]]] = None,
        on_worker_event: Optional[Any] = None,
    ) -> "StreamSystem":
        """Restore from ``path`` — a checkpoint directory (newest valid
        checkpoint wins; torn last checkpoints are skipped) or one concrete
        ``ckpt-*.json`` file. The restored system keeps checkpointing into
        the same directory unless ``checkpoint_dir`` says otherwise."""
        if os.path.isdir(path):
            payload = CheckpointStore(path).latest_payload()
            default_dir = path
        else:
            default_dir = os.path.dirname(path) or "."
            payload = CheckpointStore(default_dir).load(path)["payload"]
        return cls.from_payload(
            payload,
            backend=backend,
            device=device,
            checkpoint_dir=checkpoint_dir or default_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_keep_last=checkpoint_keep_last,
            checkpoint_background=checkpoint_background,
            step_mode=step_mode,
            max_workers=max_workers,
            on_wave=on_wave,
            journal_path=journal_path,
            check_invariants=check_invariants,
            transport=transport,
            workers=workers,
            backend_options=backend_options,
            supervise=supervise,
            autoscale=autoscale,
            on_worker_event=on_worker_event,
        )

    def quiesce(self) -> None:
        """Drain in-flight work without releasing anything.

        Blocks until any concurrent dispatch in progress has finished (the
        stepping pool is drained and dropped; it is re-created lazily on
        the next concurrent step) and queued background checkpoints are
        durably on disk, so a checkpoint written next can never race a
        step.
        """
        self.flush_checkpoints()
        self.backend._reset_pool()

    def close(self) -> None:
        """Release data-plane resources: flush queued background
        checkpoints, then close the backend (its dispatch pool; for the
        multiproc backend also the worker pool and the transport).

        Idempotent; single-process systems stay usable — stepping
        recreates what they need lazily."""
        if self._supervisor is not None:
            self._supervisor.stop()
        if self._ckpt_writer is not None:
            self._ckpt_writer.close()
            self._ckpt_writer = None
        self.backend.close()

    def worker_health(self) -> Optional[Dict[str, Any]]:
        """Cluster-plane health: worker liveness, respawn history, recent
        events, autoscaler state. ``None`` for in-process backends (there
        is no worker pool to be unhealthy)."""
        health = self.backend.worker_health()
        if health is None:
            return None
        if self._supervisor is not None:
            health["heartbeat_interval"] = self._supervisor.heartbeat_interval
            health["heartbeat_running"] = self._supervisor.running
        if self._autoscaler is not None:
            health["autoscale"] = self._autoscaler.state()
        return health

    def placement(self) -> Placement:
        return place_round_robin(
            {name: len(seg.spec.task_ids) for name, seg in self.backend.segments.items()}
        )

    # -- observability ----------------------------------------------------------------
    def sink_digests(self, sub_name: str) -> Dict[str, Dict[str, Any]]:
        """Per submitted sink: count/checksum state — the output stream
        identity used to verify Default ≡ Reuse (paper's §3.3 guarantee)."""
        sub_df = self.manager.submitted[sub_name]
        task_map = self.manager.task_maps[sub_name]
        out: Dict[str, Dict[str, Any]] = {}
        for sink_id in sub_df.sink_ids:
            st = self.backend.sink_state(task_map[sink_id])
            out[sink_id] = {
                "count": int(st["count"]),
                "checksum": float(st["checksum"]),
            }
        return out

    def segment_latency_ms(self) -> Dict[str, Dict[str, float]]:
        """Canonical per-segment step-latency digest (mean/last/max/samples
        in ms), from the same measured ``StepReport.segment_ms`` history
        the fusion calibrator reads — see
        :meth:`ExecutionBackend.segment_latency_stats`."""
        return self.backend.segment_latency_stats()

    # -- telemetry plane ---------------------------------------------------------
    def _wire_checkpoint_store(self, store: CheckpointStore) -> None:
        """Point a store at the backend's tracer/registry (encode/fsync
        spans and the checkpoint counters live inside the store, so the
        background writer thread is instrumented identically)."""
        store.tracer = self.backend.tracer
        store.metrics = self.backend.metrics

    def _wire_collectors(self) -> None:
        """Register the scrape-time collector on the backend's registry.

        Idempotent per registry instance — :meth:`configure_obs` swaps the
        registry, after which the next call re-registers on the new one.
        """
        registry = self.backend.metrics
        if registry is self._obs_registry:
            return
        registry.add_collector(self._collect_obs)
        self._obs_registry = registry

    def _collect_obs(self) -> None:
        """Mirror broker / compile-cache / reuse state into the registry.

        Runs inside every registry snapshot, never on the stepping hot
        path. Counters use ``set_total`` — the underlying sources are
        already cumulative. The broker's counters go out under the
        reference's transport names.
        """
        m = self.backend.metrics
        broker = getattr(self.backend, "transport", None)
        if broker is not None:
            counters = broker.counters()
            m.counter(
                "repro_transport_publishes_total",
                "event batches published onto boundary-stream topics",
            ).set_total(counters["publishes"])
            m.counter(
                "repro_transport_bytes_published_total",
                "payload bytes published onto boundary-stream topics",
            ).set_total(counters["bytes_published"])
            m.counter(
                "repro_transport_fetches_total",
                "boundary-stream fetches (plain, synced and zero-copy views)",
            ).set_total(broker.fetch_count)
        cache = self.backend.compile_cache_stats()
        m.counter(
            "repro_compile_cache_hits_total",
            "structurally identical segments served from the compiled-segment cache",
        ).set_total(cache.get("hits", 0))
        m.counter(
            "repro_compile_cache_misses_total",
            "segment structures compiled because no cached executable matched",
        ).set_total(cache.get("misses", 0))
        m.counter(
            "repro_compile_cache_evictions_total",
            "compiled-segment cache LRU evictions",
        ).set_total(cache.get("evictions", 0))
        m.gauge(
            "repro_compile_cache_entries",
            "distinct segment structures currently cached",
        ).set(cache.get("entries", 0))
        mgr = self.manager
        m.gauge(
            "repro_reuse_tasks_saved",
            "running tasks avoided right now by collaborative reuse "
            "(submitted task count minus running task count)",
        ).set(max(mgr.submitted_task_count - mgr.running_task_count, 0))
        oc = mgr.op_counts
        m.counter(
            "repro_reuse_tasks_submitted_total",
            "running tasks requested across all submissions (reused + created)",
        ).set_total(oc["tasks_submitted"])
        m.counter(
            "repro_reuse_tasks_reused_total",
            "requested tasks satisfied by an already-running task",
        ).set_total(oc["tasks_reused"])
        m.counter(
            "repro_merge_events_total",
            "submissions that merged into the running set reusing >=1 task",
        ).set_total(oc["merge_events"])
        m.counter(
            "repro_unmerge_events_total",
            "removals (each plans and applies one unmerge)",
        ).set_total(oc["unmerge_events"])

    def configure_obs(
        self,
        metrics: Optional[bool] = None,
        trace: Optional[bool] = None,
        sample_stride: Optional[int] = None,
        trace_capacity: Optional[int] = None,
    ) -> "StreamSystem":
        """Reconfigure the telemetry plane and re-wire every consumer
        (control plane, checkpoint store, collectors) onto the resulting
        registry/tracer — the system-level twin of
        :meth:`ExecutionBackend.configure_obs`."""
        self.backend.configure_obs(
            metrics=metrics,
            trace=trace,
            sample_stride=sample_stride,
            trace_capacity=trace_capacity,
        )
        self.manager.tracer = self.backend.tracer
        if self.checkpoint_store is not None:
            self._wire_checkpoint_store(self.checkpoint_store)
        self._wire_collectors()
        return self

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The registry snapshot, collectors included."""
        return self.backend.metrics_snapshot()

    def prometheus_text(self) -> str:
        """The snapshot rendered as Prometheus text exposition 0.0.4."""
        return render_prometheus(self.metrics_snapshot())

    def drain_spans(self) -> List[Dict[str, Any]]:
        """Drain buffered trace spans (destructive)."""
        return self.backend.drain_spans()

    def export_chrome_trace(self, path: str) -> int:
        """Drain spans into a Chrome/Perfetto trace file; returns the
        number of spans written."""
        spans = self.drain_spans()
        write_chrome_trace(path, spans)
        return len(spans)

    @property
    def running_task_count(self) -> int:
        return self.manager.running_task_count

    @property
    def deployed_task_count(self) -> int:
        return self.backend.deployed_task_count
