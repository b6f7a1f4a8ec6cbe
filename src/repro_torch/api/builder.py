"""Fluent construction of validated de-dup dataflows.

The paper's client API (§3.1) takes a DAG of concrete tasks; hand-wiring
``Task.make`` + ``add_stream`` is verbose and easy to get structurally
wrong (dangling leaves, duplicate equivalence classes). The builder keeps
a *cursor* — each ``then`` appends downstream of the previous step — and
supports branches and fan-ins through labels:

    df = (flow("stats")
          .source("urban")
          .then("senml_parse", schema="urban", label="parse")
          .then("win", w=16, label="w")
          .then("avg")                       # branch 1 continues from win
          .sink("store")
          .at("w")                           # move cursor back to win
          .then("moment2")                   # branch 2 off the window op
          .sink("store")
          .build())

Fan-in: ``then("join", after=["a", "b"])`` wires both labelled steps into
the new task. ``build()`` coalesces any structurally equivalent duplicate
steps (same Merkle signature — paper §3.2) and validates, so every built
dataflow is submission-ready.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.graph import SINK_CONFIG, SOURCE_CONFIG, Dataflow, DataflowError, Task
from repro_torch.core.signatures import dedup_fast

After = Union[str, Sequence[str], None]


class DataflowBuilder:
    """Fluent builder; every step method returns ``self`` for chaining."""

    def __init__(self, name: str):
        if not name:
            raise DataflowError("dataflow name must be non-empty")
        self.name = name
        self._tasks: List[Task] = []
        self._streams: List[Tuple[str, str]] = []
        self._labels: Dict[str, str] = {}  # label -> task id
        self._cursor: Optional[str] = None
        self._counter = 0

    # -- step methods -------------------------------------------------------
    def source(self, source_type: str, *, label: Optional[str] = None) -> "DataflowBuilder":
        """Add a source task (abstractly identified by its type — §3.1)."""
        return self._add(source_type, SOURCE_CONFIG, label=label, after=())

    def then(
        self,
        task_type: str,
        *,
        label: Optional[str] = None,
        after: After = None,
        **config: Any,
    ) -> "DataflowBuilder":
        """Append a task downstream of the cursor (or of ``after`` labels)."""
        return self._add(task_type, config, label=label, after=after)

    def sink(
        self,
        sink_type: str = "store",
        *,
        label: Optional[str] = None,
        after: After = None,
    ) -> "DataflowBuilder":
        """Terminate the current chain in a sink task."""
        return self._add(sink_type, SINK_CONFIG, label=label, after=after)

    def at(self, label: str) -> "DataflowBuilder":
        """Move the cursor to a labelled step (start of a branch)."""
        self._cursor = self._resolve(label)
        return self

    branch = at  # readability alias: .branch("w").then(...)

    # -- compilation --------------------------------------------------------
    def build(self, validate: bool = True) -> Dataflow:
        """Compile to a :class:`Dataflow`; validated and de-dup by construction.

        Structurally equivalent duplicate steps (equal type, config and
        ancestry) are coalesced — the §3.2 de-dup transform — and the
        submission contract is enforced eagerly (every chain must terminate
        in a sink — §3.3 C2), so a built dataflow is submission-ready.
        """
        df = Dataflow(self.name, self._tasks, self._streams)
        df = dedup_fast(df)
        if validate:
            df.validate()
            for tid, t in df.tasks.items():
                if not t.is_sink and not df.children(tid):
                    raise DataflowError(
                        f"step {tid!r} dangles — every chain in flow {self.name!r} "
                        f"must end with .sink() (paper §3.3 C2)"
                    )
        return df

    # -- internals ----------------------------------------------------------
    def _resolve(self, label: str) -> str:
        if label not in self._labels:
            raise DataflowError(
                f"unknown label {label!r} in flow {self.name!r} "
                f"(known: {', '.join(sorted(self._labels)) or 'none'})"
            )
        return self._labels[label]

    def _parents(self, after: After) -> List[str]:
        if after is None:
            if self._cursor is None:
                raise DataflowError(
                    f"flow {self.name!r} has no upstream step yet — start with .source()"
                )
            return [self._cursor]
        if isinstance(after, str):
            return [self._resolve(after)]
        return [self._resolve(a) for a in after]

    def _add(
        self,
        task_type: str,
        config: Any,
        *,
        label: Optional[str],
        after: After,
    ) -> "DataflowBuilder":
        parents = self._parents(after) if after != () else []
        tid = f"{self.name}/{self._counter}.{task_type}"
        self._counter += 1
        task = Task.make(tid, task_type, config)
        self._tasks.append(task)
        for p in parents:
            self._streams.append((p, tid))
        if label is not None:
            if label in self._labels:
                raise DataflowError(f"duplicate label {label!r} in flow {self.name!r}")
            self._labels[label] = tid
        self._cursor = tid
        return self

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"DataflowBuilder({self.name!r}, steps={len(self._tasks)})"


def flow(name: str) -> DataflowBuilder:
    """Start a fluent dataflow definition: ``flow("alice").source(...)…``"""
    return DataflowBuilder(name)


def as_dataflow(obj: Union[Dataflow, DataflowBuilder]) -> Dataflow:
    """Accept either a built Dataflow or a builder (session entry points)."""
    if isinstance(obj, DataflowBuilder):
        return obj.build()
    if isinstance(obj, Dataflow):
        return obj
    raise TypeError(f"expected Dataflow or DataflowBuilder, got {type(obj).__name__}")
