"""System invariants C1 + C2 — paper §3.3.

These checkers are the executable form of the paper's two constraints and
are run by the property-based test suite after arbitrary submit/remove
sequences, and optionally (``ReuseManager(check_invariants=True)``) after
every operation.
"""
from __future__ import annotations

from typing import Dict, List, Set

from .equivalence import EquivalenceChecker, ancestor_graph, dataflows_disjoint, is_dedup
from .graph import Dataflow


class InvariantViolation(AssertionError):
    pass


def check_sink_coverage(
    submitted: Dict[str, Dataflow],
    running: Dict[str, Dataflow],
    task_maps: Dict[str, Dict[str, str]],
    phi: Dict[str, str],
) -> None:
    """C1: ∀ sink t_p in submitted DAGs ∃ running t_q with t_p ↔ t_q (eq. 1).

    We verify the *witness* the manager maintains: the mapped running task
    must exist and be ancestor-equivalent to the submitted sink.
    """
    for sub_name, sub_df in submitted.items():
        run_name = phi.get(sub_name)
        if run_name is None or run_name not in running:
            raise InvariantViolation(f"C1: submitted {sub_name!r} has no running DAG (Φ)")
        run_df = running[run_name]
        task_map = task_maps[sub_name]
        checker = EquivalenceChecker(sub_df, run_df)
        for sink_id in sub_df.sink_ids:
            run_id = task_map.get(sink_id)
            if run_id is None or run_id not in run_df.tasks:
                raise InvariantViolation(
                    f"C1: sink {sink_id!r} of {sub_name!r} not mapped into {run_name!r}"
                )
            if not checker.equivalent(sink_id, run_id):
                raise InvariantViolation(
                    f"C1: sink {sink_id!r} of {sub_name!r} not equivalent to running {run_id!r}"
                )


def check_minimization(
    submitted: Dict[str, Dataflow],
    running: Dict[str, Dataflow],
    task_maps: Dict[str, Dict[str, str]],
    phi: Dict[str, str],
) -> None:
    """C2: running DAGs are disjoint de-dup DAGs and every running task and
    stream lies in some submitted sink's ancestor graph (eq. 2)."""
    names = list(running)
    for i, a in enumerate(names):
        if not is_dedup(running[a]):
            raise InvariantViolation(f"C2: running DAG {a!r} is not de-dup")
        for b in names[i + 1 :]:
            if not dataflows_disjoint(running[a], running[b]):
                raise InvariantViolation(f"C2: running DAGs {a!r}, {b!r} are not disjoint")

    # Coverage of running tasks/streams by submitted sinks' ancestor graphs.
    covered_tasks: Dict[str, Set[str]] = {name: set() for name in running}
    covered_streams: Dict[str, Set] = {name: set() for name in running}
    for sub_name, sub_df in submitted.items():
        run_name = phi[sub_name]
        run_df = running[run_name]
        task_map = task_maps[sub_name]
        for sink_id in sub_df.sink_ids:
            ag = ancestor_graph(run_df, task_map[sink_id])
            covered_tasks[run_name] |= ag.task_ids
            covered_streams[run_name] |= set(ag.streams)
    for name, df in running.items():
        extra_tasks = set(df.tasks) - covered_tasks[name]
        if extra_tasks:
            raise InvariantViolation(
                f"C2: running DAG {name!r} has {len(extra_tasks)} task(s) not in any "
                f"submitted sink's ancestor graph: {sorted(extra_tasks)[:5]}"
            )
        extra_streams = df.streams - covered_streams[name]
        if extra_streams:
            raise InvariantViolation(
                f"C2: running DAG {name!r} has {len(extra_streams)} uncovered stream(s)"
            )


def check_all(
    submitted: Dict[str, Dataflow],
    running: Dict[str, Dataflow],
    task_maps: Dict[str, Dict[str, str]],
    phi: Dict[str, str],
) -> None:
    check_sink_coverage(submitted, running, task_maps, phi)
    check_minimization(submitted, running, task_maps, phi)
