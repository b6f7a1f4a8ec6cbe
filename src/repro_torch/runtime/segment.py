"""Segments — partial DAGs stepped as one unit (the Storm-topology analogue).

The port of ``repro.runtime.segment``. A segment owns a subset of a
running DAG's tasks and steps their composition in topological order;
structural changes launch new segments wired through the broker
(incremental merge) or replace a chain of segments by one fused segment.

Batched event semantics:
  * every stream carries one ``(B_t, EVENT_WIDTH)`` batch per step;
  * a task's input batch is the concatenation of its parents' outputs in
    canonical order (sorted by Merkle ancestor signature — equivalent tasks
    sort identically, so Default and Reuse runs process events in the same
    order);
  * interleave semantics ⇒ B_task = Σ B_parent; sources emit B₀.

Pause (paper §4.3): each task has a host-side ``active`` flag. A paused
task's operator is skipped and it emits zeros of its output shape, which a
shape probe on the ``meta`` device finds when the segment is built. The
flags are Python bools, so neither pausing nor stepping waits for the card.

With a :class:`~repro_torch.runtime.compile_cache.CompileCache`, the step
function and the operators are the canonical twin's, shared by every
structurally identical segment. On the card the torch backend steps a
segment through CUDA graphs of that step, with the states updated in place
(:mod:`repro_torch.runtime.graphs`); ``Segment.graphs`` holds them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.core.graph import Dataflow
from repro_torch.ops import EVENT_WIDTH, Operator, operator_for_task

from .backend import SegmentSpec
from .broker import topic_for

PyTree = Any


@dataclass
class Segment:
    spec: SegmentSpec
    operators: Dict[str, Operator]
    step_fn: Callable  # (states, active, inputs) -> (states, outputs)
    states: Dict[str, PyTree]
    active: Dict[str, bool]
    boundary_topics: List[str]  # topics fetched from the broker each step
    cost_of: Dict[str, float] = field(default_factory=dict)  # per-task cost_weight
    # tail task -> the run (head .. tail) its multi-op kernel computes
    fused_runs: Dict[str, List[str]] = field(default_factory=dict)
    steps_run: int = 0
    # the captured step on the card (runtime/graphs.py:CapturedStep), or None
    graphs: Any = None

    @property
    def name(self) -> str:
        return self.spec.name

    def live_task_ids(self) -> List[str]:
        return [t for t in self.spec.task_ids if self.active[t]]

    def pause(self, task_ids: Set[str]) -> None:
        for tid in task_ids:
            if tid in self.active:
                self.active[tid] = False

    def resume(self, task_ids: Set[str]) -> None:
        for tid in task_ids:
            if tid in self.active:
                self.active[tid] = True


def _peephole_fused_kernels(
    spec: SegmentSpec,
    dataflow: Dataflow,
    operators: Dict[str, Operator],
    parents: Dict[str, List[str]],
    *,
    device: torch.device | str,
) -> Dict[str, List[str]]:
    """Collapse straight-line elementwise runs onto the multi-op kernels.

    Within a fused segment, a run ``elementwise → … → (rmsnorm|elementwise)``
    where every link is a private single-parent/single-consumer edge
    computes a pure composition — the tail's operator is swapped for one
    fused kernel applied to the run head's input
    (``repro_torch.ops.riot.make_fused_operator``), so the whole run is one
    launch on the card. Interior operators keep computing: every task's
    output stays published-switchable (a later merge may subscribe to any
    topic).

    Mutates ``operators`` and ``parents`` (the step closure's locals) only —
    ``spec`` is untouched, so boundary wiring, state structure and per-task
    cost accounting are unchanged. A copy of the reference's peephole that
    also returns the runs it swapped, as ``{tail: [head, …, tail]}``.
    """
    runs: Dict[str, List[str]] = {}
    if not spec.fused:
        return runs
    from repro_torch.ops.riot import FUSABLE_ELEMENTWISE, FUSED_TAILS, make_fused_operator

    in_segment = set(spec.task_ids)
    children: Dict[str, List[str]] = {}
    for t in spec.task_ids:
        for p in parents[t]:
            if p in in_segment:
                children.setdefault(p, []).append(t)
    used: Set[str] = set()
    for tid in reversed(spec.task_ids):  # tails first (task_ids is topo-sorted)
        if tid in used or dataflow.tasks[tid].type not in FUSED_TAILS:
            continue
        run = [tid]
        cur = tid
        while True:
            ps = parents[cur]
            if len(ps) != 1:
                break
            p = ps[0]
            if (
                p not in in_segment
                or children.get(p) != [cur]
                or dataflow.tasks[p].type not in FUSABLE_ELEMENTWISE
            ):
                break
            run.append(p)
            cur = p
        if len(run) < 2:
            continue
        run.reverse()  # head .. tail
        fused_op = make_fused_operator(
            [dataflow.tasks[t] for t in run], batch=spec.batch_of[tid], device=device
        )
        if fused_op is None:
            continue
        operators[tid] = fused_op
        parents[tid] = list(parents[run[0]])
        used.update(run[:-1])
        runs[tid] = run
    return runs


def _output_shape(
    task, batch: int, x_shape: Tuple[int, ...], dtype: torch.dtype
) -> Tuple[Tuple[int, ...], torch.dtype]:
    """Shape and dtype of a task's output batch for an input of ``x_shape``
    and ``dtype``, from a ``meta``-device run (the reference's
    ``jax.eval_shape`` of the operator on its real input).

    Operators may change the event width (``lm_embed`` lifts (B, 8) to (B,
    d), and the stages after it take (B, d)), so a paused task's zeros take
    the operator's output shape for the input it would have been given.
    Meta tensors carry shapes only: the probe computes nothing and launches
    no kernel.
    """
    op = operator_for_task(task, batch=batch, device="meta")
    x = torch.empty(x_shape, dtype=dtype, device="meta")
    _, y = op.apply(op.init_state(batch), x)
    return tuple(y.shape), y.dtype


def build_segment(
    spec: SegmentSpec,
    dataflow: Dataflow,
    init_states: Optional[Dict[str, PyTree]] = None,
    cache: Any = None,
    *,
    device: torch.device | str,
    count: bool = True,
) -> Segment:
    """Build a segment: its operators on ``device`` and one step function.

    With a ``cache`` (a :class:`repro_torch.runtime.compile_cache.CompileCache`),
    the step function and operators are looked up by the spec's structural
    signature: a structurally identical segment built earlier on ``device``
    shares them, and this segment steps through the cache's renaming
    adapter. ``count=False`` keeps the lookup out of the cache's counters
    (a segment moved to another device).
    """
    device = torch.device(device)
    if cache is not None:
        step_fn = cache.step_fn_for(spec, dataflow, device=device, count=count)
        operators, fused_runs = step_fn.operators, step_fn.fused_runs
    else:
        operators, step_fn, fused_runs = _compile(spec, dataflow, device)

    in_segment = set(spec.task_ids)
    boundary_parents: List[str] = []
    for tid in spec.task_ids:
        for p in spec.parents[tid]:
            if p not in in_segment and p not in boundary_parents:
                boundary_parents.append(p)
    boundary_topics = [topic_for(p) for p in boundary_parents]

    states: Dict[str, PyTree] = {}
    for tid in spec.task_ids:
        if init_states and tid in init_states:
            states[tid] = init_states[tid]
        else:
            states[tid] = operators[tid].init_state(spec.batch_of[tid])
    return Segment(
        spec=spec,
        operators=operators,
        step_fn=step_fn,
        states=states,
        active={tid: True for tid in spec.task_ids},
        boundary_topics=boundary_topics,
        cost_of={tid: operators[tid].cost_weight for tid in spec.task_ids},
        fused_runs=fused_runs,
    )


def _compile(
    spec: SegmentSpec, dataflow: Dataflow, device: torch.device
) -> Tuple[Dict[str, Operator], Callable, Dict[str, List[str]]]:
    """The operators of a spec's tasks, its step function and its peephole runs."""
    operators: Dict[str, Operator] = {}
    for tid in spec.task_ids:
        operators[tid] = operator_for_task(
            dataflow.tasks[tid], batch=spec.batch_of[tid], device=device
        )
    task_ids = list(spec.task_ids)
    parents = {t: list(spec.parents[t]) for t in task_ids}
    batch_of = dict(spec.batch_of)
    # (task, input shape, dtype) -> the task's output shape and dtype, noted
    # at its live steps; a paused task's zeros take it. Only a task paused
    # before it ever stepped live is probed (on the meta device), which a
    # segment's first, eager step does: never inside a CUDA-graph capture.
    Shape = Tuple[Tuple[int, ...], torch.dtype]
    out_shape: Dict[Tuple[str, Tuple[int, ...], torch.dtype], Shape] = {}

    def shape_key(tid: str, xs: List[torch.Tensor]):
        return tid, (sum(x.shape[0] for x in xs), *xs[0].shape[1:]), xs[0].dtype

    def paused_output(tid: str, xs: List[torch.Tensor]) -> torch.Tensor:
        key = shape_key(tid, xs)
        if key not in out_shape:
            out_shape[key] = _output_shape(dataflow.tasks[tid], batch_of[tid], *key[1:])
        shape, dtype = out_shape[key]
        return torch.zeros(shape, dtype=dtype, device=device)
    fused_runs = _peephole_fused_kernels(spec, dataflow, operators, parents, device=device)

    def step_fn(
        states: Dict[str, PyTree],
        active: Dict[str, bool],
        inputs: Dict[str, torch.Tensor],
    ):
        outputs: Dict[str, torch.Tensor] = {}  # task id -> output batch
        new_states: Dict[str, PyTree] = {}
        for i, tid in enumerate(task_ids):
            op, st = operators[tid], states[tid]
            y: Optional[torch.Tensor] = None
            try:
                if not active[tid]:
                    st2 = st
                    if op.is_source:
                        y = torch.zeros((batch_of[tid], EVENT_WIDTH), dtype=torch.float32, device=device)
                    elif not op.is_sink:
                        y = paused_output(tid, [outputs[p] if p in outputs
                                                else inputs[topic_for(p)] for p in parents[tid]])
                elif op.is_source:
                    st2, y = op.apply(st)
                else:
                    xs = [outputs[p] if p in outputs else inputs[topic_for(p)] for p in parents[tid]]
                    x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)
                    st2, y = op.apply(st, x)
                    if y is not None:
                        out_shape.setdefault(shape_key(tid, xs), (tuple(y.shape), y.dtype))
            except Exception as err:
                # the position names the task under any renaming (a cached
                # step runs under canonical ids): graphs.py reports it
                err.task_index = i
                raise
            new_states[tid] = st2
            if y is not None:
                outputs[tid] = y
        # All task outputs come back; the backend publishes the forwarding
        # subset to the broker (runtime-switchable, no rebuild).
        return new_states, outputs

    return operators, step_fn, fused_runs


def donation_report(seg: Segment, inputs: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Whether a segment's step updates its states in place, and its bytes.

    The port of the reference's check of XLA buffer donation. A segment
    stepped through CUDA graphs (:mod:`repro_torch.runtime.graphs`) writes
    its new states into the buffers it owns: ``alias_size_in_bytes`` counts
    those state bytes, and ``donation_holds`` is true when it is above 0.
    The argument bytes are the static state and input buffers, the output
    bytes the graph's outputs, the temporary bytes what the graph's private
    memory pool reserved beyond them (``torch.cuda.memory_reserved`` around
    the capture). A segment stepped eagerly (on the CPU, or with
    ``capture=False``) replaces its states each step: nothing is aliased,
    and no memory analysis is reported, as in the reference on a backend
    without one. ``inputs`` are the segment's boundary batches; on the card
    a pattern of ``active`` flags not captured yet is captured with them.
    """
    report: Dict[str, Any] = {
        "fused": bool(seg.spec.fused),
        "donation_holds": False,
        "alias_size_in_bytes": 0,
    }
    if seg.graphs is None:
        return report
    mem = seg.graphs.memory(seg, inputs)
    report.update(mem)
    # live bytes a step allocates beyond its aliased states — the number the
    # fused-vs-unfused roofline compares
    report["total_allocation_size"] = (
        mem["argument_size_in_bytes"]
        + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"]
        - mem["alias_size_in_bytes"]
    )
    report["donation_holds"] = mem["alias_size_in_bytes"] > 0
    return report
