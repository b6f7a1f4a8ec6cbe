"""Submission/removal traces (paper §5.1) and trace replay over the API.

The port's copy of ``repro.workloads.traces``: the same seed gives the
same events.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Iterator, List, Tuple

import numpy as np

from repro_torch.core.graph import Dataflow


@dataclass(frozen=True)
class TraceEvent:
    op: str  # "add" | "remove"
    name: str


def replay(
    session, dags: Iterable[Dataflow], events: Iterable[TraceEvent]
) -> Iterator[Tuple[TraceEvent, Any]]:
    """Drive a :class:`repro_torch.api.ReuseSession` through a trace.

    Yields ``(event, receipt)`` after each step so callers can sample
    point-in-time metrics (Fig. 2/3/4 accounting); lifecycle hooks on the
    session observe merges/unmerges as they happen.
    """
    by_name = {d.name: d for d in dags}
    for ev in events:
        if ev.op == "add":
            yield ev, session.submit(by_name[ev.name].copy())
        elif ev.op == "remove":
            yield ev, session.remove(ev.name)
        else:
            raise ValueError(f"unknown trace op {ev.op!r}")


def seq_trace(dags: List[Dataflow], seed: int = 0) -> List[TraceEvent]:
    """Sequential Submit/Drain: add all (uniform, without replacement),
    then remove all in (a different) random order — 2·N steps."""
    rng = np.random.default_rng(seed)
    names = [d.name for d in dags]
    add = list(rng.permutation(names))
    drain = list(rng.permutation(names))
    return [TraceEvent("add", n) for n in add] + [TraceEvent("remove", n) for n in drain]


def rw_trace(
    dags: List[Dataflow],
    seed: int = 1,
    steps: int = 100,
    init: int | None = None,
) -> List[TraceEvent]:
    """Random Walk: preload ≈⅔ of the workload, then `steps` add/remove
    coin flips, then drain. A submitted DAG is never resubmitted while
    present (paper §5.1)."""
    rng = np.random.default_rng(seed)
    names = [d.name for d in dags]
    if init is None:
        init = (2 * len(names)) // 3
    preload = list(rng.permutation(names)[:init])
    events = [TraceEvent("add", n) for n in preload]
    present = set(preload)
    absent = [n for n in names if n not in present]
    for _ in range(steps):
        do_add = bool(rng.random() < 0.5)
        if do_add and absent:
            n = absent.pop(int(rng.integers(len(absent))))
            present.add(n)
            events.append(TraceEvent("add", n))
        elif present:
            # sorted() so the draw is a pure function of the seed — set
            # iteration order varies with PYTHONHASHSEED across processes.
            n = sorted(present)[int(rng.integers(len(present)))]
            present.discard(n)
            absent.append(n)
            events.append(TraceEvent("remove", n))
    for n in list(rng.permutation(sorted(present))):
        events.append(TraceEvent("remove", n))
    return events
