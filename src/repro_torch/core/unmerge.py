"""Unmerging algorithm — paper §4.2.

When a submitted dataflow ``D_r`` is removed: find the running DAG that
contains it (Φ), compute the union of ancestor graphs of the sinks of the
*remaining* submitted DAGs it supports (Δ), terminate every running task and
stream outside that union, and split the survivor into weakly connected
components — each becomes its own running DAG (running DAGs must stay
mutually disjoint).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Set

from .equivalence import ancestor_graph
from .graph import Dataflow, Stream


@dataclass
class UnmergePlan:
    removed_name: str
    running_name: str  # Φ(D_r) — the (single) running DAG affected
    terminated_tasks: Set[str] = field(default_factory=set)  # T_t (running ids)
    terminated_streams: Set[Stream] = field(default_factory=set)  # S_t
    # name → task-id set for each connected component that survives
    components: Dict[str, Set[str]] = field(default_factory=dict)


def plan_unmerge(
    running_df: Dataflow,
    remaining_task_maps: Dict[str, Dict[str, str]],
    remaining_sinks: Dict[str, List[str]],
    removed_name: str,
    mint_name: Callable[[], str],
) -> UnmergePlan:
    """Compute the unmerge plan.

    Args:
      running_df: D̄_i = Φ(D_r).
      remaining_task_maps: for each submitted DAG in Δ(D̄_i) \\ {D_r}, its
        submitted-id → running-id map.
      remaining_sinks: for each of those DAGs, its submitted sink ids.
      removed_name: name of D_r.
      mint_name: mints fresh names for the unmerged component DAGs.
    """
    plan = UnmergePlan(removed_name=removed_name, running_name=running_df.name)

    # Union of ancestor graphs of the remaining sinks (𝔸 in the paper).
    retained: Set[str] = set()
    for sub_name, sinks in remaining_sinks.items():
        task_map = remaining_task_maps[sub_name]
        for sink_id in sinks:
            run_sink = task_map[sink_id]
            retained |= ancestor_graph(running_df, run_sink).task_ids

    # T_t — running tasks in no remaining sink's ancestor graph.
    plan.terminated_tasks = set(running_df.tasks) - retained
    # S_t — streams incident on a terminated task.
    plan.terminated_streams = {
        s for s in running_df.streams if s[0] in plan.terminated_tasks or s[1] in plan.terminated_tasks
    }

    # Split the survivor into weakly connected components.
    survivor = running_df.subgraph("__survivor__", retained)
    for comp in survivor.connected_components():
        plan.components[mint_name()] = comp
    return plan


def apply_unmerge(running: Dict[str, Dataflow], plan: UnmergePlan) -> List[Dataflow]:
    """Enact the plan: replace Φ(D_r) with the surviving components."""
    df = running.pop(plan.running_name)
    new_dfs: List[Dataflow] = []
    for name, comp in plan.components.items():
        new_dfs.append(df.subgraph(name, comp))
        new_dfs[-1].name = name
        running[name] = new_dfs[-1]
    return new_dfs
