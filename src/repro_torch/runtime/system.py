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

The port's copy of ``repro.runtime.system``, trimmed to the stream path
(submit, submit_many, remove, step, run, fuse, sink_digests). The data
plane runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Union

from repro_torch.core import MergeStrategy, ReuseManager
from repro_torch.core.defrag import FusionPlan, FusionReport, canonical_parents, plan_fusion, score_fusion_plan
from repro_torch.core.graph import Dataflow
from repro_torch.core.manager import RemovalReceipt, SubmissionReceipt

from .backend import ExecutionBackend, SegmentSpec, StepReport, compute_batches, resolve_backend


class StreamSystem:
    def __init__(
        self,
        strategy: Union[str, MergeStrategy] = "signature",
        base_batch: int = 32,
        check_invariants: bool = False,
        journal_path: Optional[str] = None,
        backend: Union[str, ExecutionBackend] = "torch",
        device: Optional[Any] = None,
    ):
        self.manager = ReuseManager(
            strategy=strategy, check_invariants=check_invariants, journal_path=journal_path
        )
        if device is not None and isinstance(backend, ExecutionBackend):
            raise ValueError(
                "device= needs a backend name or class: a backend instance "
                "already has its device"
            )
        self.backend = resolve_backend(backend, **({} if device is None else {"device": device}))
        self.base_batch = base_batch
        self.task_batch: Dict[str, int] = {}  # running task id -> output batch size
        self._seg_counter = 0
        self._segments_of: Dict[str, List[str]] = {}  # submission -> segment names
        # Last fusion planner verdicts (every accept/reject with reasons) —
        # refreshed by each fuse() call.
        self.fusion_report: Optional[FusionReport] = None

    @property
    def reuses(self) -> bool:
        return self.manager._strategy.reuses

    def _mint_segment(self) -> str:
        self._seg_counter += 1
        return f"seg{self._seg_counter}"

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
            plan, backend.seg_deps, seg_ms, slot_of=None, n_slots=1, overhead_ms=overhead_ms
        )

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
                fused=True,
            )
            self.backend.fuse_segments(spec, df, members)
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
        return self.backend.step()

    def run(self, steps: int) -> List[StepReport]:
        return [self.step() for _ in range(steps)]

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

    @property
    def running_task_count(self) -> int:
        return self.manager.running_task_count

    @property
    def deployed_task_count(self) -> int:
        return self.backend.deployed_task_count
