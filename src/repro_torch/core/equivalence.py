"""Ancestor graphs and task equivalence — paper §3.2.

This module is the *faithful* implementation of the paper's equivalence
machinery: explicit ancestor-graph construction (the recurrence α_D(t)) and
an explicit bijection check between ancestor graphs. The O(V+E) Merkle
signature fast path lives in :mod:`repro_torch.core.signatures`; the two are
cross-checked against each other in the test suite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .graph import Dataflow, Stream, Task


@dataclass(frozen=True)
class AncestorGraph:
    """α_D(t) → A⟨T̄, S̄⟩ — the task, all its ancestors, and their streams."""

    root: str  # task id the graph was derived for
    task_ids: FrozenSet[str]
    streams: FrozenSet[Stream]

    def __len__(self) -> int:
        return len(self.task_ids)

    def is_sub_ancestor_of(self, other: "AncestorGraph") -> bool:
        """A_j ⊂ A_i (strict) — paper §3.2 'sub-ancestor'."""
        return (
            self.task_ids <= other.task_ids
            and self.streams <= other.streams
            and (self.task_ids != other.task_ids or self.streams != other.streams)
        )


def ancestor_graph(df: Dataflow, task_id: str) -> AncestorGraph:
    """Compute α_D(t) iteratively (the paper's recurrence, memo-free)."""
    if task_id not in df.tasks:
        raise KeyError(task_id)
    tasks: Set[str] = set()
    streams: Set[Stream] = set()
    stack = [task_id]
    while stack:
        tid = stack.pop()
        if tid in tasks:
            continue
        tasks.add(tid)
        for p in df.parents(tid):
            streams.add((p, tid))
            if p not in tasks:
                stack.append(p)
    return AncestorGraph(task_id, frozenset(tasks), frozenset(streams))


def ancestor_graph_set(df: Dataflow) -> List[AncestorGraph]:
    """𝔸 = {α_D(t) | t ∈ T} — paper §3.2."""
    return [ancestor_graph(df, tid) for tid in df.tasks]


def maximal(graphs: List[AncestorGraph]) -> List[AncestorGraph]:
    """Ω — keep only ancestor graphs that are not sub-ancestors of another.

    Paper §3.2 'maximal ancestor graph set'.
    """
    out: List[AncestorGraph] = []
    for g in graphs:
        if not any(g.is_sub_ancestor_of(h) for h in graphs if h is not g):
            out.append(g)
    return out


class EquivalenceChecker:
    """Memoized pairwise task-equivalence between two dataflows.

    t_i ↔ t_j ⟺ t_i ≈C t_j AND their ancestor graphs admit a bijection ε of
    config-similar tasks (paper §3.2). For *de-dup* DAGs the bijection, when
    it exists, is unique, so a recursive one-to-one parent matching decides
    equivalence without backtracking: two tasks are equivalent iff they are
    config-similar and their parent sets match one-to-one under equivalence.

    The memo also *constructs* ε (as ``self.witness``) so the merge algorithm
    can rewire boundary streams onto the matched running tasks.
    """

    def __init__(self, df_a: Dataflow, df_b: Dataflow):
        self.a = df_a
        self.b = df_b
        self._memo: Dict[Tuple[str, str], bool] = {}

    def equivalent(self, ta: str, tb: str) -> bool:
        key = (ta, tb)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        # Guard against pathological recursion on deep chains.
        self._memo[key] = False  # provisional (DAGs ⇒ no true cycles)
        result = self._check(ta, tb)
        self._memo[key] = result
        return result

    def _check(self, ta: str, tb: str) -> bool:
        task_a = self.a.tasks[ta]
        task_b = self.b.tasks[tb]
        if not task_a.config_similar(task_b):
            return False
        pa = self.a.parents(ta)
        pb = self.b.parents(tb)
        if len(pa) != len(pb):
            return False
        if not pa:  # both sources (or parentless) — config-similar suffices
            return True
        # One-to-one matching of parents under equivalence. De-dup DAGs make
        # the match unique; we still verify injectivity for safety.
        unmatched_b = set(pb)
        for p in pa:
            match = None
            for q in unmatched_b:
                if self.equivalent(p, q):
                    match = q
                    break
            if match is None:
                return False
            unmatched_b.discard(match)
        return not unmatched_b

    def witness(self, ta: str, tb: str) -> Optional[Dict[str, str]]:
        """Construct ε : ancestors(ta) → ancestors(tb) if equivalent, else None."""
        if not self.equivalent(ta, tb):
            return None
        mapping: Dict[str, str] = {}
        stack = [(ta, tb)]
        while stack:
            x, y = stack.pop()
            if x in mapping:
                continue
            mapping[x] = y
            unmatched = set(self.b.parents(y))
            for p in self.a.parents(x):
                for q in list(unmatched):
                    if self.equivalent(p, q):
                        stack.append((p, q))
                        unmatched.discard(q)
                        break
        return mapping


def find_equivalent_tasks(df_a: Dataflow, df_b: Dataflow) -> Dict[str, str]:
    """All pairs (t_a → t_b) with t_a ↔ t_b; at most one match per task in a
    de-dup DAG. Used to build the ancestor intersection Λ (paper §3.2)."""
    checker = EquivalenceChecker(df_a, df_b)
    out: Dict[str, str] = {}
    for ta in df_a.tasks:
        for tb in df_b.tasks:
            if checker.equivalent(ta, tb):
                out[ta] = tb
                break
    return out


def ancestor_intersection(df_a: Dataflow, df_b: Dataflow) -> List[AncestorGraph]:
    """Λ(D_i, D_j) — ancestor graphs (taken from D_i) of equivalent tasks."""
    matches = find_equivalent_tasks(df_a, df_b)
    return [ancestor_graph(df_a, ta) for ta in matches]


def maximal_ancestor_intersection(df_a: Dataflow, df_b: Dataflow) -> List[AncestorGraph]:
    """Λ̂(D_i, D_j) = Ω(Λ(D_i, D_j)) — paper §3.2."""
    return maximal(ancestor_intersection(df_a, df_b))


def dataflows_disjoint(df_a: Dataflow, df_b: Dataflow) -> bool:
    """D_i ↮ D_j — no equivalent task pair exists (paper §3.2)."""
    return not find_equivalent_tasks(df_a, df_b)


def is_dedup(df: Dataflow) -> bool:
    """A de-dup DAG has no two internally equivalent tasks (paper §3.2)."""
    checker = EquivalenceChecker(df, df)
    tids = list(df.tasks)
    for i, ta in enumerate(tids):
        for tb in tids[i + 1 :]:
            if checker.equivalent(ta, tb):
                return False
    return True


def dedup(df: Dataflow) -> Dataflow:
    """Collapse internally-equivalent tasks (utility; submitted DAGs are
    required to be de-dup, this canonicalizes user input)."""
    checker = EquivalenceChecker(df, df)
    order = df.topological_order()
    rep: Dict[str, str] = {}  # task id -> representative id
    for i, tid in enumerate(order):
        for prev in order[:i]:
            if rep.get(prev, prev) == prev and checker.equivalent(tid, prev):
                rep[tid] = prev
                break
        rep.setdefault(tid, tid)
    out = Dataflow(df.name)
    for tid in order:
        if rep[tid] == tid:
            out.add_task(df.tasks[tid])
    for s_up, s_down in df.streams:
        u, d = rep[s_up], rep[s_down]
        if u != d and (u, d) not in out.streams:
            out.add_stream(u, d)
    return out
