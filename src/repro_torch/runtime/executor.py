"""TorchBackend — the port's data plane behind the ExecutionBackend API.

Steps deployed segments in launch order: merges only ever add segments
downstream of existing ones (boundary streams flow old → new), so launch
order is a valid topological order of the segment graph. Task states and
streams are torch tensors on the backend's device; the operators launch
the port's CUDA kernels when that device is the card.

The port of ``repro.runtime.executor.InProcessJitBackend``. Where the
reference compiles each segment's step into one XLA executable through
its :class:`~repro_torch.runtime.compile_cache.CompileCache`, the port
shares the canonical step through the same cache and, on the card,
replays each segment's step as CUDA graphs with its states updated in
place (:mod:`repro_torch.runtime.graphs`). ``capture=False`` keeps the
eager step on the card, against which the tests hold the captured one. The
step ends by waiting for the card's stream, where the reference calls
``jax.block_until_ready``, so that ``segment_ms`` measures compute rather
than enqueueing.

Checkpoints carry no device: decoded states become tensors on this
backend's device, so a checkpoint taken on the card restores on the CPU,
and the other way round, and payloads of the reference's ``inprocess``
backend restore here (and this backend's there).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.graph import Dataflow

from .backend import ExecutionBackend, PyTree, SegmentSpec
from .broker import Broker, topic_for
from .checkpoint import decode_pytree
from .compile_cache import CompileCache
from .graphs import CapturedStep, CaptureStats, map_leaves
from .segment import Segment, build_segment


def resolve_device(device: Optional[Any]) -> torch.device:
    """The caller's device, or the card. Without a card and without an
    explicit device this raises: the port never slips onto the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


class TorchBackend(ExecutionBackend):
    """Segments of torch operators, broker topics between them, task states
    on ``device`` (the card unless the caller passes ``device="cpu"``).

    On the card each segment steps through CUDA graphs after its first,
    eager step, unless ``capture=False``; on the CPU ``capture`` has no
    effect. Structurally identical segments share one canonical step
    (``compile_cache``) either way."""

    name = "torch"

    def __init__(self, device: Optional[Any] = None, capture: bool = True):
        super().__init__()
        self.device = resolve_device(device)
        self.broker = Broker()
        self.compile_cache = CompileCache(self.device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.capture_stats = CaptureStats()
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # state leaves that a restore could not take from the checkpoint
        # and reset to the operator's template (see _conform_state)
        self.template_fallbacks = 0

    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
    ) -> Segment:
        seg = build_segment(
            spec, dataflow, init_states=init_states, cache=self.compile_cache, device=self.device
        )
        if self.capture:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            seg.graphs = CapturedStep(self._capture_stream, self.capture_stats)
        return seg

    def kill(self, segment_name: str) -> None:
        seg = self.segments[segment_name]
        super().kill(segment_name)
        if seg.graphs is not None:
            seg.graphs.release()

    def _drop_streams(self, seg: Segment) -> None:
        for tid in seg.spec.task_ids:
            self.broker.drop(topic_for(tid))

    def _step_one(self, seg: Segment) -> None:
        inputs = {t: self.broker.fetch(t) for t in seg.boundary_topics}
        if seg.graphs is not None:
            # copies the inputs into the graph's, replays; states in place
            outputs = seg.graphs.step(seg, inputs)
        else:
            new_states, outputs = seg.step_fn(seg.states, seg.active, inputs)
            seg.states = new_states
        for tid in self.forwarding[seg.name]:
            if tid in outputs:
                self.broker.publish(topic_for(tid), outputs[tid])
        # The Storm worker finishes its batch before acking: wait for the
        # card so segment_ms measures compute, not enqueueing.
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        seg.steps_run += 1

    # -- durability hooks ---------------------------------------------------------
    def dump_state(self, state_encoder: Optional[Callable[..., Any]] = None) -> Dict[str, Any]:
        """On the card, a deferring ``state_encoder`` (the background
        checkpointer's) gets a copy of every state leaf and broker topic,
        made on the stepping stream — later steps write states and graph
        outputs in place — and a CUDA event recorded after those copies,
        which the writer thread waits on before its copy to the host."""
        if state_encoder is None or self.device.type != "cuda":
            return super().dump_state(state_encoder)
        ready = torch.cuda.Event()
        defer = state_encoder

        def copy_and_defer(value: Any) -> Any:
            return defer(map_leaves(lambda t: t.clone(), value), ready=ready)

        state = super().dump_state(copy_and_defer)
        ready.record(torch.cuda.current_stream(self.device))
        return state

    def _decode_init_states(
        self, spec: SegmentSpec, dataflow: Dataflow, states_enc: Dict[str, Any]
    ) -> Dict[str, PyTree]:
        """Conform checkpointed states to this backend's operator templates,
        as tensors on this backend's device in the template's dtype.

        Same-package restores round-trip bit-exactly, and so do the
        reference's ``inprocess`` states, whose leaves have the port's
        shapes and dtypes. A dry-run checkpoint carries only sink counters
        and ``()`` placeholders: leaves that do not match the template
        fall back to it and are counted in :attr:`template_fallbacks`.
        """
        from repro_torch.ops import operator_for_task

        out: Dict[str, PyTree] = {}
        fallbacks: List[int] = [0]
        for tid, enc in states_enc.items():
            batch = spec.batch_of[tid]
            op = operator_for_task(dataflow.tasks[tid], batch=batch, device=self.device)
            out[tid] = _conform_state(decode_pytree(enc), op.init_state(batch), fallbacks)
        self.template_fallbacks += fallbacks[0]
        return out

    def _dump_extra(self) -> Dict[str, Any]:
        """Broker topic buffers + publish counters (the reference's keys).

        Strictly, buffers are reconstructible (launch order is topological,
        so every boundary topic is re-published upstream within the first
        post-restore step before its consumer fetches it) — but persisting
        them keeps a restored broker observable-identical.
        """
        counters = self.broker.counters()
        return {
            "broker": {
                topic: self._state_encoder(batch)
                for topic, batch in sorted(self.broker.topics().items())
            },
            "broker_bytes_published": int(counters["bytes_published"]),
            "broker_publishes": int(counters["publishes"]),
        }

    def _restore_extra(self, extra: Dict[str, Any]) -> None:
        for topic, enc in extra.get("broker", {}).items():
            self.broker.publish(topic, torch.as_tensor(decode_pytree(enc)).to(self.device))
        # publish() above bumped the counters; restore the checkpointed view
        self.broker.restore_counters(
            int(extra.get("broker_bytes_published", 0)),
            int(extra.get("broker_publishes", 0)),
        )


def _conform_state(value: Any, template: Any, fallbacks: List[int]) -> Any:
    """Merge a decoded state pytree onto an operator's init-state template.

    Matching leaves adopt the checkpointed value (as a tensor in the
    template's dtype, on its device); structural mismatches — missing dict
    keys, wrong tuple arity, wrong array shape, ``()`` placeholders from a
    dry-run checkpoint — resolve to the template, leaf by leaf, and add the
    template leaves they reset to ``fallbacks[0]``."""
    if isinstance(template, dict):
        if not isinstance(value, dict):
            return _fall_back(template, fallbacks)
        return {k: _conform_state(value.get(k, _MISSING), t, fallbacks) for k, t in template.items()}
    if isinstance(template, (tuple, list)):
        if not isinstance(value, (tuple, list)) or len(value) != len(template):
            return _fall_back(template, fallbacks)
        return type(template)(_conform_state(v, t, fallbacks) for v, t in zip(value, template))
    if value is _MISSING or value is None:
        return _fall_back(template, fallbacks)
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(template.shape):
        return _fall_back(template, fallbacks)
    return torch.as_tensor(arr).to(device=template.device, dtype=template.dtype)


def _fall_back(template: Any, fallbacks: List[int]) -> Any:
    fallbacks[0] += _leaves(template)
    return template


def _leaves(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_leaves(t) for t in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_leaves(t) for t in tree)
    return 1


_MISSING = object()
