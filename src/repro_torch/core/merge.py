"""Merging algorithm — paper §4.1.

Given a newly submitted de-dup DAG ``D_n`` and the set of running DAGs
``D̄``, find the overlapping running DAGs ``Y`` (shared source pruning),
compute the maximal ancestor intersection, reuse the overlapping tasks
``T_o``/streams ``S_o``, and instantiate only the non-overlapping remainder
``T_x`` plus internal streams ``S_x*`` and boundary streams ``S_x⁺``.

Two equivalence strategies are supported:
  * ``"faithful"`` — the paper's bijection check over ancestor graphs.
  * ``"signature"`` — the Merkle-signature index (beyond-paper fast path).
Both produce identical plans (cross-checked by tests).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .equivalence import EquivalenceChecker
from .graph import Dataflow, Stream, Task
from .signatures import SignatureIndex, compute_signatures


@dataclass
class MergePlan:
    """Everything the data plane needs to enact a merge."""

    submitted_name: str
    merged_name: str
    overlapping: List[str]  # names of running DAGs in Y (to be replaced)
    # submitted task id -> running task id for tasks reused from D̄ (⊇ T_o cover)
    reused: Dict[str, str] = field(default_factory=dict)
    # submitted task id -> freshly minted running task id (T_x)
    created: Dict[str, str] = field(default_factory=dict)
    new_streams_internal: List[Stream] = field(default_factory=list)  # S_x* (running ids)
    new_streams_boundary: List[Stream] = field(default_factory=list)  # S_x⁺ (running ids)

    @property
    def task_map(self) -> Dict[str, str]:
        """submitted id → running id over all tasks of D_n."""
        out = dict(self.reused)
        out.update(self.created)
        return out

    @property
    def num_reused(self) -> int:
        return len(self.reused)

    @property
    def num_created(self) -> int:
        return len(self.created)


def find_overlapping(running: Dict[str, Dataflow], submitted: Dataflow) -> List[str]:
    """Y = {D̄_i : T̄_i ∩ T_n ∩ R ≠ ∅} — source-task pruning (paper §4.1).

    Source tasks are abstractly identified by their ``type`` (config is the
    constant 'SOURCE'), so the intersection tests source-type overlap.
    """
    new_sources = submitted.source_types
    return [name for name, df in running.items() if df.source_types & new_sources]


def _match_faithful(merged: Dataflow, submitted: Dataflow) -> Dict[str, str]:
    """submitted task id → equivalent running task id, via bijection check."""
    checker = EquivalenceChecker(submitted, merged)
    matches: Dict[str, str] = {}
    # Topological order: a task can only match if all its parents matched,
    # which prunes the pairwise search dramatically.
    order = submitted.topological_order()
    candidates_by_abstract: Dict[Tuple[str, str], List[str]] = {}
    for tid, t in merged.tasks.items():
        candidates_by_abstract.setdefault((t.type, t.config), []).append(tid)
    for tid in order:
        t = submitted.tasks[tid]
        if not t.is_source and not all(p in matches for p in submitted.parents(tid)):
            continue
        for cand in candidates_by_abstract.get((t.type, t.config), ()):
            if checker.equivalent(tid, cand):
                matches[tid] = cand
                break
    return matches


def _match_signature(
    index: SignatureIndex,
    running: Dict[str, Dataflow],
    overlapping: List[str],
    submitted: Dataflow,
    sigs: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """submitted task id → running task id via the signature index.

    Any index hit necessarily lies in an overlapping running DAG (equal
    signatures imply equal source ancestry), so the global index is safe.
    ``sigs`` may carry precomputed signatures of ``submitted`` to avoid a
    redundant hashing pass (the batched-submit path computes them once).
    """
    overlap_tasks: Set[str] = set()
    for name in overlapping:
        overlap_tasks |= set(running[name].tasks)
    if sigs is None:
        sigs = compute_signatures(submitted)
    matches: Dict[str, str] = {}
    for tid, sig in sigs.items():
        hit = index.lookup(sig)
        if hit is not None and hit in overlap_tasks:
            matches[tid] = hit
    return matches


def build_plan(
    submitted: Dataflow,
    matches: Dict[str, str],
    overlapping: List[str],
    mint_id: Callable[[str], str],
    merged_name: str,
) -> MergePlan:
    """Assemble a :class:`MergePlan` from an equivalence match.

    ``matches`` maps submitted task ids to already-running task ids (T_o);
    everything else becomes T_x with freshly minted ids, and streams are
    split into internal (S_x*) and boundary (S_x⁺) — paper §4.1.
    """
    plan = MergePlan(
        submitted_name=submitted.name, merged_name=merged_name, overlapping=list(overlapping)
    )
    plan.reused = dict(matches)
    # T_x = T_n \ T_o — tasks to instantiate with fresh running ids.
    for tid in submitted.topological_order():
        if tid not in matches:
            plan.created[tid] = mint_id(submitted.tasks[tid].type)
    # S_x = S_x* ∪ S_x⁺ — paper §4.1. (up ∉ T_o ∧ down ∈ T_o is impossible:
    # a matched task's ancestors are all matched.)
    for s_up, s_down in submitted.streams:
        if s_down in matches:
            continue  # stream already present among reused tasks
        if s_up in matches:
            plan.new_streams_boundary.append((matches[s_up], plan.created[s_down]))
        else:
            plan.new_streams_internal.append((plan.created[s_up], plan.created[s_down]))
    return plan


def plan_merge(
    running: Dict[str, Dataflow],
    submitted: Dataflow,
    mint_id: Callable[[str], str],
    merged_name: str,
    strategy: str = "signature",
    index: Optional[SignatureIndex] = None,
) -> MergePlan:
    """Compute the merge plan for ``submitted`` against the running set."""
    overlapping = find_overlapping(running, submitted)

    if strategy == "signature":
        if index is None:
            raise ValueError("signature strategy requires a SignatureIndex")
        matches = _match_signature(index, running, overlapping, submitted)
    elif strategy == "faithful":
        merged_view = Dataflow("__Y__")
        for name in overlapping:
            for t in running[name].tasks.values():
                merged_view.add_task(t)
            for s in running[name].streams:
                merged_view.add_stream(*s)
        matches = _match_faithful(merged_view, submitted)
    else:
        raise ValueError(f"unknown equivalence strategy {strategy!r}")

    return build_plan(submitted, matches, overlapping, mint_id, merged_name)


def apply_merge(
    running: Dict[str, Dataflow], submitted: Dataflow, plan: MergePlan
) -> Dataflow:
    """Enact the plan: build D̄_m, replace Y in the running set, return D̄_m."""
    merged = Dataflow(plan.merged_name)
    for name in plan.overlapping:
        for t in running[name].tasks.values():
            merged.add_task(t)
        for s in running[name].streams:
            merged.add_stream(*s)
    for sub_id, run_id in plan.created.items():
        t = submitted.tasks[sub_id]
        merged.add_task(Task(id=run_id, type=t.type, config=t.config))
    for s in plan.new_streams_internal:
        merged.add_stream(*s)
    for s in plan.new_streams_boundary:
        merged.add_stream(*s)
    for name in plan.overlapping:
        del running[name]
    running[plan.merged_name] = merged
    return merged
