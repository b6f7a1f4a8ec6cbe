"""Merkle ancestor signatures — beyond-paper O(V+E) equivalence fast path.

The paper decides task equivalence by constructing a bijection between
ancestor graphs (see :mod:`repro_torch.core.equivalence`). That is quadratic in
the number of task pairs. We observe that for de-dup DAGs equivalence admits
a *canonical form*:

    sig(t) = H(type ‖ config ‖ sorted-multiset{ sig(p) : p ∈ π(t) })

**Theorem** (tested by property tests against the faithful checker): for
tasks in de-dup DAGs, ``sig(t_i) == sig(t_j)``  ⟺  ``t_i ↔ t_j`` (up to
SHA-256 collisions). Sketch: ⇐ follows by induction on the bijection ε;
⇒ by induction on DAG depth — equal digests force equal ⟨type, config⟩ and
equal parent-signature multisets, and de-dup means signatures within one
parent set are distinct, so the multiset match induces a unique bijection.

This turns merge from O(|T_n|·|T̄|·depth) into O(V+E) hashing plus O(1)
dict lookups against a signature index of the running tasks.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Set

from .graph import Dataflow, Task


def _digest(parts: Iterable[bytes]) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(4, "little"))
        h.update(p)
    return h.hexdigest()


def compute_signatures(df: Dataflow) -> Dict[str, str]:
    """sig(t) for every task in topological order — O(V + E log E)."""
    sigs: Dict[str, str] = {}
    for tid in df.topological_order():
        t = df.tasks[tid]
        parent_sigs = sorted(sigs[p] for p in df.parents(tid))
        sigs[tid] = _digest(
            [t.type.encode(), t.config.encode()] + [s.encode() for s in parent_sigs]
        )
    return sigs


def signature_of(df: Dataflow, task_id: str) -> str:
    """Signature of one task (computes the ancestor closure only)."""
    # Restrict to the ancestor set for efficiency.
    needed: Set[str] = set()
    stack = [task_id]
    while stack:
        tid = stack.pop()
        if tid in needed:
            continue
        needed.add(tid)
        stack.extend(df.parents(tid))
    sigs: Dict[str, str] = {}
    for tid in df.topological_order():
        if tid not in needed:
            continue
        t = df.tasks[tid]
        parent_sigs = sorted(sigs[p] for p in df.parents(tid))
        sigs[tid] = _digest(
            [t.type.encode(), t.config.encode()] + [s.encode() for s in parent_sigs]
        )
    return sigs[task_id]


class SignatureIndex:
    """Incremental index ``sig → running task id`` over the running set.

    The manager keeps one global index (running DAGs are mutually disjoint,
    so signatures never collide across running DAGs for non-equivalent
    tasks; equivalent tasks across running DAGs would violate disjointness).
    """

    def __init__(self) -> None:
        self._by_sig: Dict[str, str] = {}
        self._by_task: Dict[str, str] = {}

    def __len__(self) -> int:
        return len(self._by_sig)

    def add(self, task_id: str, sig: str) -> None:
        self._by_sig[sig] = task_id
        self._by_task[task_id] = sig

    def remove_task(self, task_id: str) -> None:
        sig = self._by_task.pop(task_id, None)
        if sig is not None and self._by_sig.get(sig) == task_id:
            del self._by_sig[sig]

    def lookup(self, sig: str) -> Optional[str]:
        return self._by_sig.get(sig)

    def sig_of(self, task_id: str) -> Optional[str]:
        return self._by_task.get(task_id)

    def add_dataflow(self, df: Dataflow) -> Dict[str, str]:
        sigs = compute_signatures(df)
        for tid, sig in sigs.items():
            self.add(tid, sig)
        return sigs

    def remove_tasks(self, task_ids: Iterable[str]) -> None:
        for tid in task_ids:
            self.remove_task(tid)


def is_dedup_fast(df: Dataflow) -> bool:
    """De-dup check via signatures: no two tasks share a signature."""
    sigs = compute_signatures(df)
    return len(set(sigs.values())) == len(sigs)


def dedup_fast(df: Dataflow) -> Dataflow:
    """Signature-based de-duplication (O(V+E)); mirrors equivalence.dedup."""
    sigs = compute_signatures(df)
    rep: Dict[str, str] = {}
    first: Dict[str, str] = {}
    for tid in df.topological_order():
        s = sigs[tid]
        if s in first:
            rep[tid] = first[s]
        else:
            first[s] = tid
            rep[tid] = tid
    out = Dataflow(df.name)
    for tid in df.topological_order():
        if rep[tid] == tid:
            out.add_task(df.tasks[tid])
    for s_up, s_down in df.streams:
        u, d = rep[s_up], rep[s_down]
        if u != d and (u, d) not in out.streams:
            out.add_stream(u, d)
    return out
