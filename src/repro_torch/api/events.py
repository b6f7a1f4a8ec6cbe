"""Typed receipts and lifecycle events surfaced by :class:`ReuseSession`.

The port's copy of ``repro.api.events``. Submissions already return
:class:`~repro_torch.core.manager.SubmissionReceipt` /
:class:`~repro_torch.core.manager.RemovalReceipt`; this module adds the
session-level aggregates (batch receipt, stats snapshot) and the event
objects delivered to ``on_merge`` / ``on_unmerge`` / ``on_defrag`` hooks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Set, Tuple

from repro_torch.core.manager import RemovalReceipt, SubmissionReceipt

# The wave event is minted where waves are scheduled; re-exported here so
# session users import every event type from one place.
from repro_torch.runtime.scheduler import WaveEvent

__all__ = [
    "BatchSubmitReceipt",
    "DefragEvent",
    "MergeEvent",
    "SessionStats",
    "StepEvent",
    "UnmergeEvent",
    "WaveEvent",
]


@dataclass(frozen=True)
class MergeEvent:
    """Fired after a submission merged into the running set (§4.1)."""

    name: str
    running_dag: str
    num_reused: int
    num_created: int
    batched: bool  # True when part of a submit_many batch
    receipt: SubmissionReceipt


@dataclass(frozen=True)
class UnmergeEvent:
    """Fired after a removal unmerged the running set (§4.2)."""

    name: str
    terminated_tasks: Set[str]
    surviving_dags: List[str]
    receipt: RemovalReceipt


@dataclass(frozen=True)
class DefragEvent:
    """Fired after a data-plane defragmentation pass."""

    segments_killed: int
    segments_after: int
    deployed_tasks_after: int


@dataclass(frozen=True)
class StepEvent:
    """Fired after every data-plane step (any backend) — the Fig. 2/3 counters."""

    step: int
    live_tasks: int
    paused_tasks: int
    cost: float  # core-equivalents this step
    wall_ms: float
    report: Any  # the backend's full StepReport

    @property
    def makespan_ms(self) -> float:
        """Dependency-DAG modelled step latency (wave max in concurrent mode)."""
        return self.report.makespan_ms


@dataclass(frozen=True)
class BatchSubmitReceipt:
    """Aggregate receipt for :meth:`ReuseSession.submit_many`."""

    receipts: Tuple[SubmissionReceipt, ...]

    def __iter__(self):
        return iter(self.receipts)

    def __len__(self) -> int:
        return len(self.receipts)

    def __getitem__(self, i: int) -> SubmissionReceipt:
        return self.receipts[i]

    @property
    def names(self) -> List[str]:
        return [r.name for r in self.receipts]

    @property
    def num_reused(self) -> int:
        return sum(r.num_reused for r in self.receipts)

    @property
    def num_created(self) -> int:
        return sum(r.num_created for r in self.receipts)

    @property
    def running_dags(self) -> List[str]:
        return sorted({r.running_dag for r in self.receipts})


@dataclass(frozen=True)
class SessionStats:
    """Point-in-time snapshot of a session (the paper's Fig. 2 metrics)."""

    strategy: str
    submitted_dataflows: int
    running_dataflows: int
    submitted_task_count: int
    running_task_count: int
    reuse_histogram: Dict[int, int] = field(default_factory=dict)
    # data-plane extras (0/None when the session is control-plane only)
    deployed_task_count: int = 0
    segments: int = 0
    steps_run: int = 0
    backend: Any = None  # ExecutionBackend registry name
    # compiled-segment reuse cache counters (collaborative reuse at the
    # compiled-segment level; zeros for backends that never build a step)
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    compile_cache_evictions: int = 0
    compile_cache_entries: int = 0

    @property
    def task_reduction(self) -> float:
        """1 − running/submitted — the headline saving (Fig. 2)."""
        if self.submitted_task_count == 0:
            return 0.0
        return 1.0 - self.running_task_count / self.submitted_task_count
