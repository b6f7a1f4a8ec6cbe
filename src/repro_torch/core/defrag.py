"""Defragmentation planning — the paper's §4.3/§7 future work, implemented.

Repeated merge/unmerge leaves a running DAG deployed as many small segments
joined by broker topics, plus paused tasks that still consume ε resources
(the paper measures ≈7.5 cores of pause residue at the end of the OPMW
drain). Defragmentation stops all segments and relaunches **one** segment
per running DAG containing exactly the live tasks — removing every broker
hop and all pause overhead, and handing XLA a single program so cross-
segment fusion/CSE applies.

This module is pure control-plane planning (graph work only); enactment —
state carry-over and recompilation — lives in
:meth:`repro_torch.runtime.system.StreamSystem.defragment`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Set

from .graph import Dataflow
from .signatures import compute_signatures


@dataclass
class FusedDag:
    """One fused segment to launch for a running DAG."""

    dag_name: str
    order: List[str]  # all live tasks, topological
    parents: Dict[str, List[str]]  # canonical (signature-sorted) parent order


@dataclass
class DefragPlan:
    fused: List[FusedDag] = field(default_factory=list)

    @property
    def total_tasks(self) -> int:
        return sum(len(f.order) for f in self.fused)


def canonical_parents(df: Dataflow) -> Dict[str, List[str]]:
    """Parent lists sorted by Merkle signature.

    Equivalent tasks have equal signatures and de-dup DAGs have distinct
    signatures within a parent set, so this order is invariant under the
    equivalence bijection — Default and Reuse runs interleave parent streams
    identically and sink outputs stay bit-identical.
    """
    sigs = compute_signatures(df)
    return {t: sorted(df.parents(t), key=lambda p: sigs[p]) for t in df.tasks}


@dataclass
class FusionChain:
    """A maximal linear run of same-DAG segments to compile into one."""

    dag_name: str
    members: List[str]  # segment names, upstream -> downstream


@dataclass
class FusionPlan:
    chains: List[FusionChain] = field(default_factory=list)

    @property
    def total_segments(self) -> int:
        return sum(len(c.members) for c in self.chains)


def plan_fusion(
    seg_deps: Mapping[str, Set[str]],
    dag_of: Mapping[str, str],
    min_length: int = 2,
) -> FusionPlan:
    """Find maximal linear segment chains worth fusing.

    A pair ``(a, b)`` is a *sole link* when ``b``'s only dependency is
    ``a`` and ``a``'s only dependent is ``b`` — the boundary stream
    between them is a private pipe with no fan-in or fan-out. Fusing
    exactly these chains collapses the pipe into an XLA temporary
    without serialising anything that was running in parallel: wide
    waves stay wide, only depth is fused. Segment dependencies only
    arise from boundary streams *within* one merged running DAG, so a
    chain never spans DAGs; ``dag_of`` labels the chain with its newest
    member's running-DAG name (merges rename the running DAG, so
    members carry different historical names).

    Pure planning (graph work only) like :func:`plan_defrag`; enactment
    lives in :meth:`repro_torch.runtime.system.StreamSystem.fuse`.

    Only segments present in **both** ``seg_deps`` and ``dag_of`` are
    planned over, and dependency edges onto absent segments are dropped:
    after a fuse/unmerge/defragment cycle either view can briefly hold
    stale names, and a chain must never propose a killed segment. Re-runs
    on an unchanged system are idempotent — a fused chain is a single
    node with no sole link, so it is simply not proposed again.
    """
    nodes = set(seg_deps) & set(dag_of)
    deps = {n: {d for d in seg_deps.get(n, ()) if d in nodes} for n in nodes}
    dependents: Dict[str, List[str]] = {name: [] for name in deps}
    for name in sorted(deps):
        for dep in deps[name]:
            if dep in dependents:
                dependents[dep].append(name)

    def sole_link(a: str, b: str) -> bool:
        return deps.get(b, set()) == {a} and dependents.get(a) == [b]

    def successor(a: str) -> Optional[str]:
        down = dependents.get(a, [])
        if len(down) == 1 and sole_link(a, down[0]):
            return down[0]
        return None

    plan = FusionPlan()
    for name in sorted(deps):
        # chain heads: extendable forward, not extendable backward
        if successor(name) is None:
            continue
        preds = deps.get(name, set())
        if len(preds) == 1 and sole_link(next(iter(preds)), name):
            continue  # interior node — its head starts the chain
        members = [name]
        nxt = successor(name)
        while nxt is not None:
            members.append(nxt)
            nxt = successor(nxt)
        if len(members) >= min_length:
            plan.chains.append(
                FusionChain(dag_name=dag_of.get(members[-1], ""), members=members)
            )
    return plan


# -- wave-aware fusion scoring -------------------------------------------------


@dataclass
class FusionDecision:
    """One accept/reject verdict from :func:`score_fusion_plan`."""

    chain: FusionChain
    accepted: bool
    reason: str
    est_benefit_ms: float = 0.0
    est_penalty_ms: float = 0.0
    target_slot: int = 0
    member_slots: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {
            "dag": self.chain.dag_name,
            "members": list(self.chain.members),
            "accepted": bool(self.accepted),
            "reason": self.reason,
            "est_benefit_ms": round(float(self.est_benefit_ms), 4),
            "est_penalty_ms": round(float(self.est_penalty_ms), 4),
            "target_slot": int(self.target_slot),
            "member_slots": dict(self.member_slots),
        }


@dataclass
class FusionReport:
    """Every candidate chain's verdict — the planner's explanation."""

    decisions: List[FusionDecision] = field(default_factory=list)

    @property
    def accepted(self) -> List[FusionDecision]:
        return [d for d in self.decisions if d.accepted]

    @property
    def rejected(self) -> List[FusionDecision]:
        return [d for d in self.decisions if not d.accepted]

    def to_dict(self) -> Dict[str, object]:
        return {
            "accepted": [d.to_dict() for d in self.accepted],
            "rejected": [d.to_dict() for d in self.rejected],
        }


def score_fusion_plan(
    plan: FusionPlan,
    seg_deps: Mapping[str, Set[str]],
    seg_ms: Mapping[str, float],
    slot_of: Optional[Mapping[str, int]] = None,
    n_slots: int = 1,
    overhead_ms: float = 0.25,
) -> FusionReport:
    """Score each candidate chain against a makespan model; keep wide waves wide.

    Fusing a private-pipe chain never serialises anything *within* the
    chain (it is already a serial path), but cross-worker fusion must
    first **consolidate** the members onto one slot — and piling a chain
    onto an already-loaded slot can stretch the step makespan on an
    otherwise well-balanced pool. The model:

      * ``makespan = max(critical_path, max_slot_load)`` — a step can
        finish no sooner than its longest dependency path and no sooner
        than its busiest slot. The critical path is invariant under chain
        contraction (chains are paths), so only the slot-load term moves.
      * benefit  = ``(len − 1) · overhead_ms`` — each fused boundary
        removes one dispatch + broker hop.
      * penalty  = makespan after moving all members onto the cheapest
        slot minus makespan before.

    A chain is accepted iff ``penalty ≤ benefit``; accepted chains update
    the load picture, so later chains are scored against the pool they
    will actually land on. With one slot (in-process/sharded-as-one) the
    penalty is always 0 and every chain is accepted — consolidation is
    the only modelled risk. ``seg_ms`` comes from the dry-run
    :class:`repro_torch.ops.costs.LatencyModel`, fit from live EWMA latency
    samples when the backend has them, so "cheapest slot" tracks the
    EWMA-cheapest worker. Pure planning: no backend types here.
    """
    ms = {n: max(0.0, float(seg_ms.get(n, 0.0))) for n in seg_deps}
    slots = {n: int(slot_of.get(n, 0)) if slot_of else 0 for n in seg_deps}
    n_slots = max(1, int(n_slots))
    loads = [0.0] * n_slots
    for n, m in ms.items():
        loads[slots[n] % n_slots] += m

    # critical path over the segment dependency DAG, memoized bottom-up
    cp_cache: Dict[str, float] = {}

    def cp(n: str) -> float:
        if n not in cp_cache:
            cp_cache[n] = ms.get(n, 0.0) + max(
                (cp(d) for d in seg_deps.get(n, ()) if d in ms), default=0.0
            )
        return cp_cache[n]

    critical = max((cp(n) for n in ms), default=0.0)

    report = FusionReport()
    for chain in plan.chains:
        k = len(chain.members)
        member_slots = {m: slots.get(m, 0) for m in chain.members}
        chain_ms = sum(ms.get(m, 0.0) for m in chain.members)
        benefit = (k - 1) * float(overhead_ms)
        # load picture with the members lifted out, then dropped on the
        # cheapest slot
        minus = list(loads)
        for m in chain.members:
            minus[slots.get(m, 0) % n_slots] -= ms.get(m, 0.0)
        target = min(range(n_slots), key=lambda i: minus[i])
        after = list(minus)
        after[target] += chain_ms
        penalty = max(critical, max(after)) - max(critical, max(loads))
        accepted = penalty <= benefit + 1e-9
        if accepted:
            loads = after
            for m in chain.members:
                slots[m] = target
            reason = (
                f"fuse {k} segments on slot {target}: saves ~{benefit:.3f} ms "
                f"dispatch overhead, makespan +{max(0.0, penalty):.3f} ms"
            )
        else:
            reason = (
                f"consolidating {k} segments ({chain_ms:.3f} ms) onto slot "
                f"{target} would stretch the step makespan by {penalty:.3f} ms "
                f"(> {benefit:.3f} ms saved) — keeping the wave wide"
            )
        report.decisions.append(
            FusionDecision(
                chain=chain,
                accepted=accepted,
                reason=reason,
                est_benefit_ms=benefit,
                est_penalty_ms=penalty,
                target_slot=target,
                member_slots=member_slots,
            )
        )
    return report


def plan_defrag(running: Dict[str, Dataflow]) -> DefragPlan:
    """One fused segment per running DAG (live tasks only — the manager has
    already removed terminated tasks from the running DAGs; paused residue
    exists only in the data plane and is dropped on enactment)."""
    plan = DefragPlan()
    for dag_name in sorted(running):
        df = running[dag_name]
        if not df.tasks:
            continue
        plan.fused.append(
            FusedDag(
                dag_name=dag_name,
                order=df.topological_order(),
                parents=canonical_parents(df),
            )
        )
    return plan
