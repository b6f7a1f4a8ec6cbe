"""Reusable Dataflow Manager — paper §4.3, control plane.

Maintains the submitted set 𝔻, the running set 𝔻̄, the decomposition map
Δ : 𝔻̄ → P(𝔻) and inverse Φ : 𝔻 → 𝔻̄, the per-submission task maps
(submitted id → running id), and a durable journal of operations for
crash-recovery (replay reconstructs the state byte-identically — the
fault-tolerance story for the control plane).

``strategy`` picks the equivalence engine from the pluggable registry
(:mod:`repro_torch.core.strategies`): ``"signature"`` (Merkle index, beyond-paper
fast path, default), ``"faithful"`` (the paper's bijection check) or
``"none"`` (the Default baseline — no reuse, every submission runs
independently; used for the paper's Default-vs-Reuse comparisons). A
:class:`~repro_torch.core.strategies.MergeStrategy` instance is also accepted.
"""
from __future__ import annotations

import json
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from . import invariants
from .equivalence import ancestor_graph
from .graph import Dataflow, DataflowError, Task
from .merge import MergePlan, apply_merge, build_plan
from .signatures import SignatureIndex, compute_signatures
from .strategies import MergeStrategy, resolve_strategy
from .unmerge import UnmergePlan, apply_unmerge, plan_unmerge


@dataclass
class SubmissionReceipt:
    """Returned to the user on submit — where their outputs land (§4.1)."""

    name: str
    running_dag: str
    sink_map: Dict[str, str]  # submitted sink id → running task id
    num_reused: int
    num_created: int
    plan: MergePlan


@dataclass
class RemovalReceipt:
    name: str
    terminated_tasks: Set[str]
    surviving_dags: List[str]
    plan: UnmergePlan


class ReuseManager:
    def __init__(
        self,
        strategy: Union[str, MergeStrategy] = "signature",
        check_invariants: bool = False,
        journal_path: Optional[str] = None,
    ):
        self._strategy = resolve_strategy(strategy)
        self.strategy = self._strategy.name  # back-compat string view
        self.check_invariants = check_invariants
        self.journal_path = journal_path

        self.submitted: Dict[str, Dataflow] = {}
        self.running: Dict[str, Dataflow] = {}
        self.task_maps: Dict[str, Dict[str, str]] = {}  # sub name → (sub id → run id)
        self.phi: Dict[str, str] = {}  # Φ : submitted → running
        self.delta: Dict[str, Set[str]] = {}  # Δ : running → submitted set
        self.index = SignatureIndex()
        self._task_counter = 0
        self._dag_counter = 0
        self.journal: List[Dict[str, Any]] = []
        # -- telemetry plane (repro_torch.obs, optional) ---------------------
        # An owning StreamSystem wires its backend's Tracer in here so
        # merge/unmerge/preview planning shows up as "control" spans; the
        # cumulative op counters below are mirrored into the metrics
        # registry by a snapshot-time collector (never read on the hot
        # path). Journal replay re-runs submit/remove, so a restored
        # manager's counters are consistent with its rebuilt Δ/Φ state.
        self.tracer: Optional[Any] = None
        self.op_counts: Dict[str, int] = {
            "tasks_submitted": 0,  # running tasks requested (reused + created)
            "tasks_reused": 0,  # requested tasks satisfied by a running task
            "tasks_created": 0,  # requested tasks that had to be instantiated
            "merge_events": 0,  # submissions that reused ≥1 running task
            "unmerge_events": 0,  # removals (every removal plans an unmerge)
            "previews": 0,  # admission-control dry plans
        }

    def _span(self, name: str, **args: Any):
        """A "control"-category tracer span, or a no-op without a tracer."""
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            return tracer.span(name, "control", **args)
        return nullcontext()

    def _count_merge(self, plan: MergePlan) -> None:
        oc = self.op_counts
        oc["tasks_submitted"] += plan.num_reused + plan.num_created
        oc["tasks_reused"] += plan.num_reused
        oc["tasks_created"] += plan.num_created
        if plan.num_reused:
            oc["merge_events"] += 1

    # -- id minting ----------------------------------------------------------
    def _mint_task_id(self, type_hint: str = "t") -> str:
        self._task_counter += 1
        return f"r{self._task_counter}.{type_hint[:16]}"

    def _mint_dag_name(self) -> str:
        self._dag_counter += 1
        return f"run{self._dag_counter}"

    # -- validation ----------------------------------------------------------
    def _validate_submission(self, df: Dataflow) -> Dict[str, str]:
        """Structural + de-dup validation; returns the signature map (one pass)."""
        df.validate()
        for tid in df.tasks:
            t = df.tasks[tid]
            if not t.is_sink and not df.children(tid):
                raise DataflowError(
                    f"task {tid!r} is a non-sink leaf; submitted DAGs must "
                    f"terminate in sink tasks (paper §3.3 C2)"
                )
        sigs = compute_signatures(df)
        if len(set(sigs.values())) != len(sigs):
            raise DataflowError(f"submitted dataflow {df.name!r} is not de-dup (§3.2)")
        return sigs

    # -- operations ------------------------------------------------------------
    def submit(self, df: Dataflow, validate: bool = True) -> SubmissionReceipt:
        """Merge a submitted de-dup DAG into the running set (paper §4.1)."""
        if df.name in self.submitted:
            raise DataflowError(f"dataflow {df.name!r} already submitted")
        sigs: Optional[Dict[str, str]] = None
        if validate:
            sigs = self._validate_submission(df)
        elif self._strategy.wants_signatures:
            sigs = compute_signatures(df)

        df = df.copy()  # signatures are keyed by task id, which copy preserves
        merged_name = self._mint_dag_name()
        with self._span("merge", dataflow=df.name, running_dag=merged_name):
            plan = self._strategy.plan(self, df, merged_name, sigs=sigs)
            # Update Δ/Φ: all submissions supported by the absorbed DAGs now
            # map to the merged DAG.
            absorbed: Set[str] = set()
            for run_name in plan.overlapping:
                absorbed |= self.delta.pop(run_name, set())
            apply_merge(self.running, df, plan)
        for sub_name in absorbed:
            self.phi[sub_name] = merged_name
        self.submitted[df.name] = df
        self.task_maps[df.name] = plan.task_map
        self.phi[df.name] = merged_name
        self.delta[merged_name] = absorbed | {df.name}
        self._strategy.on_merged(self, df, plan, sigs=sigs)

        self._journal({"op": "submit", "dataflow": df.to_json()})
        self._count_merge(plan)
        receipt = SubmissionReceipt(
            name=df.name,
            running_dag=merged_name,
            sink_map={s: plan.task_map[s] for s in df.sink_ids},
            num_reused=plan.num_reused,
            num_created=plan.num_created,
            plan=plan,
        )
        if self.check_invariants:
            self.verify()
        return receipt

    def preview(self, df: Dataflow, validate: bool = True) -> MergePlan:
        """Plan the merge for ``df`` WITHOUT committing it.

        Runs the strategy's matching against the current running set and
        returns the resulting :class:`~repro_torch.core.merge.MergePlan` —
        ``plan.num_created`` is the number of new running tasks the
        submission would instantiate, which is what admission control
        charges against a slot pool (a fully-reused submission costs 0).

        The manager is left bit-identical: the plan mints placeholder ids
        through the task counter, which is restored afterwards, so a
        preview followed by the real :meth:`submit` produces exactly the
        ids (and journal) an un-previewed submit would have. No journal
        entry is written. ``validate=False`` skips the structural de-dup
        check for trusted callers on a hot admission path.
        """
        if df.name in self.submitted:
            raise DataflowError(f"dataflow {df.name!r} already submitted")
        sigs: Optional[Dict[str, str]] = None
        if validate:
            sigs = self._validate_submission(df)
        elif self._strategy.wants_signatures:
            sigs = compute_signatures(df)
        saved_counter = self._task_counter
        self.op_counts["previews"] += 1
        try:
            with self._span("preview", dataflow=df.name):
                return self._strategy.plan(self, df, "__preview__", sigs=sigs)
        finally:
            self._task_counter = saved_counter

    def submit_many(
        self, dfs: Sequence[Dataflow], validate: bool = True
    ) -> List[SubmissionReceipt]:
        """Submit a batch with batch-aware planning (beyond-paper).

        Under heavy multi-tenant arrival rates, N overlapping submissions
        paid N independent merges: each submit re-hashed its DAG up to three
        times (de-dup check, matching, index maintenance) and rebuilt the
        growing merged running DAG from scratch. The batch planner

          1. computes each DAG's Merkle signatures exactly once and shares
             them across validation, matching and index maintenance;
          2. groups the batch with the running set by source-type
             connectivity (union-find), plans every member against the
             running set *plus the batch tasks planned so far* — so
             cross-submission overlap inside the batch is de-duplicated
             before anything touches the running set; and
          3. rebuilds each group's merged running DAG once, not once per
             member.

        The result is state-identical to sequential :meth:`submit` calls
        (same running task ids and DAG names, same Δ/Φ, same journal entries
        in the same order — the journal still holds one ``submit`` op per
        member, so replay needs no new op type). Receipts differ from
        sequential in one deliberate way: every member's receipt (and its
        ``plan.merged_name``) names the group's *final* merged DAG — the
        one actually present in the running set — rather than an
        intermediate name a later member immediately absorbed.
        Strategies without ``supports_batch`` fall back to sequential;
        batch-capable strategies supply the matching via
        :meth:`~repro_torch.core.strategies.MergeStrategy.batch_match`.
        """
        dfs = list(dfs)
        if not dfs:
            return []
        names_seen: Set[str] = set()
        for df in dfs:
            if df.name in self.submitted or df.name in names_seen:
                raise DataflowError(f"dataflow {df.name!r} already submitted")
            names_seen.add(df.name)
        if not self._strategy.supports_batch or len(dfs) == 1:
            return [self.submit(df, validate=validate) for df in dfs]

        # One signature pass per member, shared with validation.
        sigs_of: Dict[str, Dict[str, str]] = {}
        copies: List[Dataflow] = []
        for df in dfs:
            sigs_of[df.name] = (
                self._validate_submission(df) if validate else compute_signatures(df)
            )
            copies.append(df.copy())

        # Group records; planning then walks members in BATCH order so dag
        # names and task ids mint exactly as sequential submits would.
        records: List[Dict[str, Any]] = []
        record_of: Dict[str, Dict[str, Any]] = {}
        for members, run_names in self._group_by_sources(copies):
            overlap_tasks: Set[str] = set()
            for rn in run_names:
                overlap_tasks |= set(self.running[rn].tasks)
            rec: Dict[str, Any] = {
                "members": [],
                "plans": [],
                "run_names": run_names,
                "overlap_tasks": overlap_tasks,
                "created_by_sig": {},
                "merged_name": "",
                "last_idx": -1,
            }
            records.append(rec)
            for df in members:
                record_of[df.name] = rec

        for idx, df in enumerate(copies):
            rec = record_of[df.name]
            merged_name = self._mint_dag_name()  # the group keeps the last name
            sigs = sigs_of[df.name]
            matches = self._strategy.batch_match(
                self, df, sigs, rec["overlap_tasks"], rec["created_by_sig"]
            )
            plan = build_plan(df, matches, rec["run_names"], self._mint_task_id, merged_name)
            for tid, rid in plan.created.items():
                rec["created_by_sig"][sigs[tid]] = rid
            rec["members"].append(df)
            rec["plans"].append(plan)
            rec["merged_name"] = merged_name
            rec["last_idx"] = idx

        # Apply each group once, in the order sequential submits would have
        # last touched them (preserves the running set's insertion order).
        for rec in sorted(records, key=lambda r: r["last_idx"]):
            self._apply_group(rec, sigs_of)

        # Journal + receipts in batch order, mirroring sequential submits.
        receipts: List[SubmissionReceipt] = []
        for df in copies:
            plan = record_of[df.name]["plans"][record_of[df.name]["members"].index(df)]
            self._journal({"op": "submit", "dataflow": df.to_json()})
            self._count_merge(plan)
            receipts.append(
                SubmissionReceipt(
                    name=df.name,
                    running_dag=plan.merged_name,
                    sink_map={s: plan.task_map[s] for s in df.sink_ids},
                    num_reused=plan.num_reused,
                    num_created=plan.num_created,
                    plan=plan,
                )
            )
        if self.check_invariants:
            self.verify()
        return receipts

    def _group_by_sources(
        self, dfs: List[Dataflow]
    ) -> List[Tuple[List[Dataflow], List[str]]]:
        """Partition batch members + running DAGs into connected groups.

        Two dataflows land in the same group iff they are transitively
        connected through shared source types — exactly the closure that
        sequential merging would produce (paper §4.1 source pruning).
        Returns ``(members, overlapping_running_names)`` per group, members
        in batch order.
        """
        parent: Dict[Any, Any] = {}

        def find(x: Any) -> Any:
            parent.setdefault(x, x)
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a: Any, b: Any) -> None:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for df in dfs:
            for st in df.source_types:
                union(("df", df.name), ("src", st))
        for run_name, run_df in self.running.items():
            for st in run_df.source_types:
                union(("run", run_name), ("src", st))

        members: Dict[Any, List[Dataflow]] = {}
        for df in dfs:
            members.setdefault(find(("df", df.name)), []).append(df)
        groups: List[Tuple[List[Dataflow], List[str]]] = []
        for root, group_dfs in members.items():
            run_names = [rn for rn in self.running if find(("run", rn)) == root]
            groups.append((group_dfs, run_names))
        return groups

    def _apply_group(self, rec: Dict[str, Any], sigs_of: Dict[str, Dict[str, str]]) -> None:
        """Enact one connected group of a batch in a single merged-DAG rebuild."""
        members: List[Dataflow] = rec["members"]
        plans: List[MergePlan] = rec["plans"]
        run_names: List[str] = rec["run_names"]
        merged_name: str = rec["merged_name"]
        # Every member's plan reports the group's final DAG — intermediate
        # minted names never materialize in the running set.
        for plan in plans:
            plan.merged_name = merged_name

        merged = Dataflow(merged_name)
        for rn in run_names:
            for t in self.running[rn].tasks.values():
                merged.add_task(t)
            for s in self.running[rn].streams:
                merged.add_stream(*s)
        for df, plan in zip(members, plans):
            for sub_id, run_id in plan.created.items():
                t = df.tasks[sub_id]
                merged.add_task(Task(id=run_id, type=t.type, config=t.config))
            for s in plan.new_streams_internal:
                merged.add_stream(*s)
            for s in plan.new_streams_boundary:
                merged.add_stream(*s)

        absorbed: Set[str] = set()
        for rn in run_names:
            absorbed |= self.delta.pop(rn, set())
            del self.running[rn]
        self.running[merged_name] = merged
        for sub_name in absorbed:
            self.phi[sub_name] = merged_name
        self.delta[merged_name] = set(absorbed)

        for df, plan in zip(members, plans):
            self.submitted[df.name] = df
            self.task_maps[df.name] = plan.task_map
            self.phi[df.name] = merged_name
            self.delta[merged_name].add(df.name)
            self._strategy.on_merged(self, df, plan, sigs=sigs_of[df.name])

    def remove(self, name: str) -> RemovalReceipt:
        """Remove a submitted DAG and unmerge the running set (paper §4.2)."""
        if name not in self.submitted:
            raise DataflowError(f"dataflow {name!r} was not submitted")
        run_name = self.phi[name]
        run_df = self.running[run_name]
        remaining = sorted(self.delta[run_name] - {name})
        with self._span("unmerge", dataflow=name, running_dag=run_name):
            plan = plan_unmerge(
                run_df,
                remaining_task_maps={n: self.task_maps[n] for n in remaining},
                remaining_sinks={n: self.submitted[n].sink_ids for n in remaining},
                removed_name=name,
                mint_name=self._mint_dag_name,
            )
            apply_unmerge(self.running, plan)
        # Re-point Δ/Φ for the survivors: a submitted DAG belongs to the
        # component that contains its mapped tasks (exactly one, verified).
        del self.delta[run_name]
        for comp_name in plan.components:
            self.delta[comp_name] = set()
        for sub_name in remaining:
            mapped = set(self.task_maps[sub_name].values())
            homes = [cn for cn, comp in plan.components.items() if mapped & comp]
            if len(homes) != 1 or not mapped <= plan.components[homes[0]]:
                raise AssertionError(
                    f"unmerge split submitted DAG {sub_name!r} across components"
                )
            self.phi[sub_name] = homes[0]
            self.delta[homes[0]].add(sub_name)
        # Drop empty components (cannot happen if remaining non-empty; if no
        # remaining submissions, everything was terminated).
        for comp_name in [c for c, subs in self.delta.items() if not subs and c in plan.components]:
            if not self.running[comp_name].tasks:
                del self.running[comp_name]
                del self.delta[comp_name]

        del self.submitted[name]
        del self.task_maps[name]
        del self.phi[name]
        self._strategy.on_unmerged(self, plan.terminated_tasks)

        self._journal({"op": "remove", "name": name})
        self.op_counts["unmerge_events"] += 1
        receipt = RemovalReceipt(
            name=name,
            terminated_tasks=set(plan.terminated_tasks),
            surviving_dags=list(plan.components),
            plan=plan,
        )
        if self.check_invariants:
            self.verify()
        return receipt

    # -- introspection / stats -------------------------------------------------
    def verify(self) -> None:
        invariants.check_all(self.submitted, self.running, self.task_maps, self.phi)

    @property
    def running_task_count(self) -> int:
        """The paper's primary metric (Fig. 2)."""
        return sum(len(df.tasks) for df in self.running.values())

    @property
    def submitted_task_count(self) -> int:
        return sum(len(df.tasks) for df in self.submitted.values())

    def reuse_counts(self) -> Dict[str, int]:
        """For each running task, how many submitted DAGs use it (Fig. 4)."""
        counts: Dict[str, int] = {
            tid: 0 for df in self.running.values() for tid in df.tasks
        }
        for sub_name, sub_df in self.submitted.items():
            run_df = self.running[self.phi[sub_name]]
            used: Set[str] = set()
            for sink_id in sub_df.sink_ids:
                used |= ancestor_graph(run_df, self.task_maps[sub_name][sink_id]).task_ids
            for tid in used:
                counts[tid] += 1
        return counts

    # -- durability (control-plane fault tolerance) -----------------------------
    def _journal(self, entry: Dict[str, Any]) -> None:
        entry = dict(entry, ts=time.time())
        self.journal.append(entry)
        if self.journal_path:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps(entry) + "\n")

    def snapshot(self) -> Dict[str, Any]:
        return {
            "strategy": self.strategy,
            "journal": self.journal,
        }

    @classmethod
    def replay(
        cls, journal: List[Dict[str, Any]], strategy: Optional[str] = None, **kwargs: Any
    ) -> "ReuseManager":
        """Rebuild manager state by re-running the operation journal.

        Durable journaling is suspended during the replay itself — otherwise
        a ``journal_path`` pointing at the source file would re-append every
        replayed op, duplicating the journal on each restore. The path is
        re-armed afterwards so *subsequent* operations keep journaling.
        """
        journal_path = kwargs.pop("journal_path", None)
        mgr = cls(strategy=strategy or "signature", **kwargs)
        for entry in journal:
            if entry["op"] == "submit":
                mgr.submit(Dataflow.from_json(entry["dataflow"]))
            elif entry["op"] == "remove":
                mgr.remove(entry["name"])
            else:
                raise ValueError(f"unknown journal op {entry['op']!r}")
        # Keep the original entries (timestamps included), not the re-journaled
        # copies, so a restored manager's journal matches the source.
        mgr.journal = [dict(e) for e in journal]
        mgr.journal_path = journal_path
        return mgr

    @classmethod
    def restore(cls, journal_path: str, **kwargs: Any) -> "ReuseManager":
        journal: List[Dict[str, Any]] = []
        with open(journal_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    journal.append(json.loads(line))
        kwargs.setdefault("journal_path", journal_path)
        return cls.replay(journal, **kwargs)
