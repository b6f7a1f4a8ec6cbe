"""Segment-step reuse cache — collaborative reuse extended down to the step.

The port of ``repro.runtime.compile_cache``. The paper shares *streams*
between overlapping dataflows; this module shares the *step* between
segments that are **structurally identical** — same task types, same
canonical configs, same batch sizes, same internal wiring, same fused flag.
That is the common case under churn: a removed dataflow resubmitted later,
many users submitting the same template, or a Default-strategy run where
every submission deploys its own copy.

Mechanism (the reference's, with its keys and counters):

  * :func:`structural_signature` — canonicalize a :class:`SegmentSpec`
    (task ids → ``t0, t1, …`` in spec order, external boundary parents →
    ``x0, x1, …`` in first-appearance order) and hash types/configs/
    batches/wiring with the length-prefixed SHA-256 of the merge algorithm
    (:mod:`repro_torch.core.signatures`). The hex string is the
    reference's, byte for byte.
  * :class:`CompileCache` — an LRU of **canonical** segment steps. On a
    miss the canonical twin of the spec is built on the cache's device
    (:func:`~repro_torch.runtime.segment.build_segment`) and its step
    function and operators are cached; hit or miss, the real segment steps
    through a :class:`_RenamedStepFn` adapter that maps its task ids and
    topics onto the canonical names per call. Operators hold only device
    constants (a source's key and ramp, the gains), so structurally
    identical segments share them.

Where the reference's artifact is a traced XLA executable, the port's is
the canonical torch step; on the card each segment captures that step into
CUDA graphs of its own (:mod:`repro_torch.runtime.graphs`), because a graph
bakes in the addresses of one segment's buffers. A cache belongs to one
backend and serves every device that backend places segments on, as the
reference's one cache serves every device of its ``sharded`` backend: the
counters count a structure once for all devices. Beneath each key the
cache keeps one canonical step per device, because a step's operators hold
tensors of their device; building a known structure on another device
counts as the hit it is in the reference. A miss is traced as the
reference's ``compile_miss`` span (category ``compile``) when the owning
backend's tracer is on.

The cache takes no lock: segments are built only by ``deploy``, which runs
between steps on the caller's thread, never on a dispatch thread of
concurrent stepping on the CPU (those only step segments already built).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.graph import Dataflow, Task
from repro_torch.core.signatures import _digest
from repro_torch.ops import Operator

from .backend import SegmentSpec
from .broker import topic_for
from .segment import build_segment

__all__ = [
    "CompileCache",
    "process_compile_cache",
    "structural_signature",
]


def _canonical_maps(spec: SegmentSpec) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Task-id and external-parent renamings erasing all naming history.

    Task ids map in ``spec.task_ids`` order; external (boundary) parents
    map in first-appearance order over the per-task parent lists — the
    same order :func:`build_segment` derives its boundary topics in, so
    the canonical segment's boundary wiring is isomorphic to the real one.
    """
    tid_map = {t: f"t{i}" for i, t in enumerate(spec.task_ids)}
    ext: List[str] = []
    for t in spec.task_ids:
        for p in spec.parents[t]:
            if p not in tid_map and p not in ext:
                ext.append(p)
    ext_map = {p: f"x{i}" for i, p in enumerate(ext)}
    return tid_map, ext_map


def structural_signature(spec: SegmentSpec, dataflow: Dataflow) -> str:
    """Structural identity of a segment's step.

    Two specs with equal signatures step the same operators over the same
    wiring: the key covers the fused flag and, per task in order, ⟨type,
    canonical config, batch, canonically renamed parent refs⟩. Parent refs
    keep their per-task *list order* (concatenation order is semantics);
    ``publish`` is excluded (the step returns every task's output
    regardless — forwarding is a runtime choice).
    """
    tid_map, ext_map = _canonical_maps(spec)
    parts: List[bytes] = [b"fused" if spec.fused else b"unfused"]
    for t in spec.task_ids:
        task = dataflow.tasks[t]
        refs = ",".join(
            tid_map[p] if p in tid_map else ext_map[p] for p in spec.parents[t]
        )
        parts.extend(
            (
                task.type.encode(),
                task.config.encode(),
                str(int(spec.batch_of[t])).encode(),
                refs.encode(),
            )
        )
    return _digest(parts)


def _canonicalize(
    spec: SegmentSpec, dataflow: Dataflow
) -> Tuple[SegmentSpec, Dataflow, Dict[str, str], Dict[str, str]]:
    """The canonical twin of ⟨spec, dataflow⟩ plus the renaming maps."""
    tid_map, ext_map = _canonical_maps(spec)
    ref = {**tid_map, **ext_map}
    canon_spec = SegmentSpec(
        name="canonical",
        dag_name="canonical",
        task_ids=[tid_map[t] for t in spec.task_ids],
        parents={
            tid_map[t]: [ref[p] for p in spec.parents[t]] for t in spec.task_ids
        },
        publish={tid_map[t] for t in spec.publish if t in tid_map},
        batch_of={tid_map[t]: int(spec.batch_of[t]) for t in spec.task_ids},
        created_at=0,
        fused=spec.fused,
    )
    canon_df = Dataflow("canonical")
    for t in spec.task_ids:
        task = dataflow.tasks[t]
        # direct construction: config is already a canonical string and must
        # round-trip byte-exactly into the canonical task definition
        canon_df.add_task(Task(id=tid_map[t], type=task.type, config=task.config))
    return canon_spec, canon_df, tid_map, ext_map


class _Canonical(NamedTuple):
    """What the cache keeps of a canonical segment: its step and the parts
    of it that segments share (no states: each segment owns its own)."""

    step_fn: Any
    operators: Dict[str, Operator]
    fused_runs: Dict[str, List[str]]


class _RenamedStepFn:
    """Per-segment adapter over a shared canonical step function.

    Renames the segment's dict keys (task ids, boundary topic strings)
    onto the canonical names on the way in and back on the way out, and
    exposes the shared canonical operators and peephole runs under the
    segment's own task ids.
    """

    def __init__(self, canon: _Canonical, tid_map: Dict[str, str], topic_map: Dict[str, str]):
        self._fn = canon.step_fn
        self._tid = dict(tid_map)
        self._topic = dict(topic_map)  # real boundary topic -> canonical topic
        self._tid_rev = {v: k for k, v in tid_map.items()}
        self.operators = {t: canon.operators[c] for t, c in self._tid.items()}
        self.fused_runs = {
            self._tid_rev[tail]: [self._tid_rev[t] for t in run]
            for tail, run in canon.fused_runs.items()
        }

    def __call__(self, states, active, inputs):
        new_states, outputs = self._fn(
            {self._tid[k]: v for k, v in states.items()},
            {self._tid[k]: v for k, v in active.items()},
            {self._topic[k]: v for k, v in inputs.items()},
        )
        return (
            {self._tid_rev[k]: v for k, v in new_states.items()},
            {self._tid_rev[k]: v for k, v in outputs.items()},
        )


class CompileCache:
    """LRU cache of canonical segment steps, keyed by structure.

    ``device`` is where segments are built unless :meth:`step_fn_for` is
    given another; each key holds one canonical step per device it was
    built on. ``capacity`` bounds the number of distinct structures held;
    eviction is least-recently-used and drops the structure on every
    device (an evicted step stays alive only while segments still
    reference it). Counters are cumulative for the cache's lifetime —
    ``stats()`` is the surface ``session.stats()`` aggregates, with the
    reference's keys.
    """

    def __init__(self, device: torch.device | str, capacity: int = 128):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.device = torch.device(device)
        self.capacity = int(capacity)
        self._entries: "OrderedDict[str, Dict[torch.device, _Canonical]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # optional repro_torch.obs.Tracer set by the owning backend; a miss
        # (a canonical build) is the expensive event worth a span
        self.tracer: Optional[Any] = None

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {
            "hits": int(self.hits),
            "misses": int(self.misses),
            "evictions": int(self.evictions),
            "entries": len(self._entries),
        }

    def step_fn_for(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        device: Optional[torch.device | str] = None,
        count: bool = True,
    ) -> _RenamedStepFn:
        """The (shared, canonical) step function for a spec on ``device``
        (default the cache's), adapter-wrapped.

        A structure the cache holds is a hit, on whichever device it was
        built; a new one is a miss. The canonical twin is built uncached
        on ``device`` where that device has none yet. ``count=False`` (a
        segment moved to another device, which the reference's cache never
        sees) counts nothing, leaves the LRU order alone, and adds no
        structure the cache does not hold.
        """
        device = self.device if device is None else torch.device(device)
        key = structural_signature(spec, dataflow)
        per_device = self._entries.get(key)
        canon_spec, canon_df, tid_map, ext_map = _canonicalize(spec, dataflow)
        if count:
            if per_device is not None:
                self.hits += 1
                self._entries.move_to_end(key)
            else:
                self.misses += 1
                per_device = self._entries[key] = {}
                if len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1
        canon = per_device.get(device) if per_device is not None else None
        if canon is None:
            tracer = self.tracer
            if count and tracer is not None and tracer.enabled and not per_device:
                with tracer.span("compile_miss", "compile", signature=key[:12],
                                 tasks=len(spec.task_ids), fused=bool(spec.fused)):
                    seg = build_segment(canon_spec, canon_df, device=device)
            else:
                seg = build_segment(canon_spec, canon_df, device=device)
            canon = _Canonical(seg.step_fn, seg.operators, seg.fused_runs)
            if per_device is not None:
                per_device[device] = canon
        topic_map = {topic_for(p): topic_for(c) for p, c in ext_map.items()}
        return _RenamedStepFn(canon, tid_map, topic_map)


# One cache per process and device, for a data plane that builds its
# segments inside worker processes (the reference's multiproc workers).
_PROCESS_CACHES: Dict[torch.device, CompileCache] = {}


def process_compile_cache(device: torch.device | str) -> CompileCache:
    device = torch.device(device)
    if device not in _PROCESS_CACHES:
        _PROCESS_CACHES[device] = CompileCache(device)
    return _PROCESS_CACHES[device]
