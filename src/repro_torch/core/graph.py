"""Dataflow graph model — paper §3.1.

An *event* is a discrete unit of data with an opaque payload. An *abstract
task* is ``⟨type, config⟩`` — user logic parameterized by a config. A
*concrete task* additionally carries a globally unique ``id``. A *stream* is
a directed edge transferring events from an upstream task to a downstream
task. A *dataflow* is a DAG of concrete tasks and streams.

Source tasks have ``config == 'SOURCE'`` and no inputs; sink tasks have
``config == 'SINK'`` and no outputs (paper §3.1).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, Iterable, Iterator, List, Mapping, Optional, Set, Tuple

SOURCE_CONFIG = "SOURCE"
SINK_CONFIG = "SINK"


def canonical_config(config: Any) -> str:
    """Canonical string form of a task config (order-insensitive for dicts).

    Config equality in the paper (τ_i.config = τ_j.config) is implemented as
    equality of this canonical JSON form.
    """
    if isinstance(config, str):
        return config
    return json.dumps(config, sort_keys=True, separators=(",", ":"), default=str)


@dataclass(frozen=True)
class AbstractTask:
    """τ = ⟨type, config⟩ — paper §3.1."""

    type: str
    config: str  # canonical form

    @classmethod
    def of(cls, type: str, config: Any) -> "AbstractTask":
        return cls(type=type, config=canonical_config(config))

    @property
    def is_source(self) -> bool:
        return self.config == SOURCE_CONFIG

    @property
    def is_sink(self) -> bool:
        return self.config == SINK_CONFIG


@dataclass(frozen=True)
class Task:
    """Concrete task t = ⟨id, type, config⟩ — paper §3.1."""

    id: str
    type: str
    config: str  # canonical form

    @classmethod
    def make(cls, id: str, type: str, config: Any) -> "Task":
        return cls(id=id, type=type, config=canonical_config(config))

    @property
    def abstract(self) -> AbstractTask:
        return AbstractTask(self.type, self.config)

    @property
    def is_source(self) -> bool:
        return self.config == SOURCE_CONFIG

    @property
    def is_sink(self) -> bool:
        return self.config == SINK_CONFIG

    def type_similar(self, other: "Task") -> bool:
        """t_i ≈T t_j — paper §3.2."""
        return self.type == other.type

    def config_similar(self, other: "Task") -> bool:
        """t_i ≈C t_j — paper §3.2."""
        return self.type == other.type and self.config == other.config


Stream = Tuple[str, str]  # s = ⟨t_up.id, t_down.id⟩


class DataflowError(ValueError):
    pass


class Dataflow:
    """D = ⟨T, S⟩ — a DAG of concrete tasks and streams (paper §3.1).

    Mutable container used both for user-submitted dataflows and for the
    running (merged) dataflows maintained by the manager.
    """

    __slots__ = ("name", "tasks", "streams", "_children", "_parents")

    def __init__(self, name: str, tasks: Iterable[Task] = (), streams: Iterable[Stream] = ()):
        self.name = name
        self.tasks: Dict[str, Task] = {}
        self.streams: Set[Stream] = set()
        self._children: Dict[str, Set[str]] = {}
        self._parents: Dict[str, Set[str]] = {}
        for t in tasks:
            self.add_task(t)
        for s in streams:
            self.add_stream(*s)

    # -- construction ------------------------------------------------------
    def add_task(self, task: Task) -> Task:
        if task.id in self.tasks:
            existing = self.tasks[task.id]
            if existing != task:
                raise DataflowError(f"duplicate task id {task.id!r} with different definition")
            return existing
        self.tasks[task.id] = task
        self._children.setdefault(task.id, set())
        self._parents.setdefault(task.id, set())
        return task

    def add_stream(self, up_id: str, down_id: str) -> Stream:
        if up_id not in self.tasks or down_id not in self.tasks:
            raise DataflowError(f"stream ({up_id!r}→{down_id!r}) references unknown task")
        if up_id == down_id:
            raise DataflowError(f"self-loop stream on {up_id!r}")
        s = (up_id, down_id)
        self.streams.add(s)
        self._children[up_id].add(down_id)
        self._parents[down_id].add(up_id)
        return s

    def remove_task(self, task_id: str) -> None:
        if task_id not in self.tasks:
            raise DataflowError(f"unknown task {task_id!r}")
        for s in [s for s in self.streams if task_id in s]:
            self.remove_stream(*s)
        del self.tasks[task_id]
        del self._children[task_id]
        del self._parents[task_id]

    def remove_stream(self, up_id: str, down_id: str) -> None:
        self.streams.discard((up_id, down_id))
        self._children.get(up_id, set()).discard(down_id)
        self._parents.get(down_id, set()).discard(up_id)

    # -- accessors ----------------------------------------------------------
    def __contains__(self, task_id: str) -> bool:
        return task_id in self.tasks

    def __len__(self) -> int:
        return len(self.tasks)

    def parents(self, task_id: str) -> Set[str]:
        """π_D(t) — immediate upstream predecessors (paper §3.2)."""
        return set(self._parents.get(task_id, set()))

    def children(self, task_id: str) -> Set[str]:
        return set(self._children.get(task_id, set()))

    @property
    def source_ids(self) -> List[str]:
        """I = T ∩ R — input (source) tasks."""
        return [t.id for t in self.tasks.values() if t.is_source]

    @property
    def sink_ids(self) -> List[str]:
        """O = T ∩ N — output (sink) tasks."""
        return [t.id for t in self.tasks.values() if t.is_sink]

    @property
    def source_types(self) -> Set[str]:
        """Abstract identity of source tasks (type uniquely names a source)."""
        return {t.type for t in self.tasks.values() if t.is_source}

    def topological_order(self) -> List[str]:
        """Kahn topological order; raises on cycles."""
        indeg = {tid: len(self._parents[tid]) for tid in self.tasks}
        frontier = sorted(tid for tid, d in indeg.items() if d == 0)
        order: List[str] = []
        import heapq

        heapq.heapify(frontier)
        while frontier:
            tid = heapq.heappop(frontier)
            order.append(tid)
            for c in self._children[tid]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    heapq.heappush(frontier, c)
        if len(order) != len(self.tasks):
            raise DataflowError(f"dataflow {self.name!r} has a cycle")
        return order

    def validate(self) -> None:
        """Structural validation: acyclic, connected, sources/sinks well-formed.

        Weak connectivity is required of *submitted* dataflows: the paper's
        Δ/Φ bookkeeping (§4.2) assumes each submission lives in exactly one
        running DAG, which only holds when the submission is one weakly
        connected application. A disconnected submission should be split by
        the user into separate dataflows.
        """
        self.topological_order()
        for t in self.tasks.values():
            if t.is_source and self._parents[t.id]:
                raise DataflowError(f"source task {t.id!r} has input streams")
            if t.is_sink and self._children[t.id]:
                raise DataflowError(f"sink task {t.id!r} has output streams")
        for tid in self.tasks:
            t = self.tasks[tid]
            if not t.is_source and not self._parents[tid]:
                raise DataflowError(f"non-source task {tid!r} has no input streams")
        if len(self.tasks) and len(self.connected_components()) > 1:
            raise DataflowError(
                f"dataflow {self.name!r} is not weakly connected; submit "
                f"each component as its own dataflow"
            )

    def connected_components(self) -> List[Set[str]]:
        """Weakly connected components (used by unmerge — paper §4.2)."""
        seen: Set[str] = set()
        comps: List[Set[str]] = []
        for start in self.tasks:
            if start in seen:
                continue
            comp: Set[str] = set()
            stack = [start]
            while stack:
                tid = stack.pop()
                if tid in comp:
                    continue
                comp.add(tid)
                stack.extend(self._children[tid] - comp)
                stack.extend(self._parents[tid] - comp)
            seen |= comp
            comps.append(comp)
        return comps

    def subgraph(self, name: str, task_ids: Set[str]) -> "Dataflow":
        tasks = [self.tasks[tid] for tid in task_ids]
        streams = [s for s in self.streams if s[0] in task_ids and s[1] in task_ids]
        return Dataflow(name, tasks, streams)

    def copy(self, name: Optional[str] = None) -> "Dataflow":
        return Dataflow(name or self.name, self.tasks.values(), self.streams)

    def __repr__(self) -> str:
        return f"Dataflow({self.name!r}, |T|={len(self.tasks)}, |S|={len(self.streams)})"

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "tasks": [
                {"id": t.id, "type": t.type, "config": t.config} for t in self.tasks.values()
            ],
            "streams": sorted(list(s) for s in self.streams),
        }

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Dataflow":
        df = cls(obj["name"])
        for t in obj["tasks"]:
            df.add_task(Task.make(t["id"], t["type"], t["config"]))
        for up, down in obj["streams"]:
            df.add_stream(up, down)
        return df


def up(s: Stream) -> str:
    """up(s) — paper §3.1."""
    return s[0]


def down(s: Stream) -> str:
    """down(s) — paper §3.1."""
    return s[1]
