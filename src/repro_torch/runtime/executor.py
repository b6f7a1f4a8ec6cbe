"""TorchBackend — the port's data plane behind the ExecutionBackend API.

In sync mode the backend steps deployed segments in launch order: merges
only ever add segments downstream of existing ones (boundary streams flow
old → new), so launch order is a valid topological order of the segment
graph. In concurrent mode (:meth:`ExecutionBackend.configure_stepping`)
segments whose producers have finished step at once, and each boundary
read checks its producer's publish of this step (per-topic sequencing, as
the reference's ``_topic_target``). On the CPU that is the reference's
ready queue over a pool of dispatch threads. On the card the stepping
thread issues the waves itself (:meth:`TorchBackend._issue_waves`): each
segment of a wave goes onto one of a fixed set of CUDA streams, waits on
an event of each of its producers, and the step ends with one synchronize.
Task states and streams are torch tensors on the backend's device; the
operators launch the port's CUDA kernels when that device is the card.

The port of ``repro.runtime.executor.InProcessJitBackend``. Where the
reference compiles each segment's step into one XLA executable through
its :class:`~repro_torch.runtime.compile_cache.CompileCache`, the port
shares the canonical step through the same cache and, on the card,
replays each segment's step as CUDA graphs with its states updated in
place (:mod:`repro_torch.runtime.graphs`). ``capture=False`` keeps the
eager step on the card, against which the tests hold the captured one. A
segment's step ends by waiting for its stream, where the reference calls
``jax.block_until_ready``, so that ``segment_ms`` measures compute rather
than enqueueing.

Boundary streams ride a pluggable transport (``transport=``, as the
reference's): the default ``"inproc"`` broker passes tensors by
reference, so nothing leaves the device; over ``"shm"`` or ``"tcp"``
each boundary batch crosses the host as a numpy array, through the
segment's :class:`~repro_torch.runtime.staging.HostStaging` (the route
the worker processes take), and a captured step still copies it into its
static input buffers. ``self.broker`` is the reference's alias of the
transport.

Checkpoints carry no device: decoded states become tensors on this
backend's device, so a checkpoint taken on the card restores on the CPU,
and the other way round, and payloads of the reference's ``inprocess``
backend restore here (and this backend's there).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Dataflow

from .backend import ExecutionBackend, PyTree, SegmentSpec
from .broker import Broker, topic_for
from .checkpoint import decode_pytree
from .compile_cache import CompileCache
from .graphs import CapturedStep, CaptureStats, map_leaves
from .segment import Segment, build_segment
from .staging import HostStaging
from .transport import Transport, resolve_transport


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
    (``compile_cache``) either way. ``step_mode`` and ``max_workers`` are
    the reference's; on the card ``max_workers`` is the number of streams
    a concurrent step issues its waves onto (None: the widest wave's
    width). ``transport``/``transport_options`` pick the boundary-stream
    transport, as the reference's ``transport=`` does."""

    name = "torch"

    def __init__(
        self,
        device: Optional[Any] = None,
        capture: bool = True,
        step_mode: str = "sync",
        max_workers: Optional[int] = None,
        transport: Any = "inproc",
        transport_options: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(step_mode=step_mode, max_workers=max_workers)
        self.device = resolve_device(device)
        self.transport: Transport = resolve_transport(transport, **(transport_options or {}))
        self.broker = self.transport  # the reference's alias
        # segment name -> its host staging, where the transport carries
        # numpy arrays (shm, tcp); None for the in-process broker
        self._staging: Optional[Dict[str, HostStaging]] = (
            None if isinstance(self.transport, Broker) else {})
        # one step cache for every device the backend builds segments on
        # (a placed backend's too), as the reference's
        self.compile_cache = CompileCache(self.device)
        self.compile_cache.tracer = self.tracer
        self.capture = bool(capture) and self.device.type == "cuda"
        self.capture_stats = CaptureStats()
        # per device: the stream graphs are captured on, and the streams a
        # concurrent step on the card issues its waves onto, made as a
        # wider step first needs them; each segment's pair of timing events
        # there (see _issue_waves)
        self._capture_streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._wave_streams: Dict[torch.device, List[torch.cuda.Stream]] = {}
        self._seg_events: Dict[str, Tuple[torch.cuda.Event, torch.cuda.Event]] = {}
        # Per-topic sequence targets for the concurrent step in flight
        # (None outside one): each forwarding task publishes exactly once
        # per step, so a boundary read of this step must observe sequence
        # start+1 on its producer's topic — and only on that topic.
        self._topic_target: Optional[Dict[str, int]] = None
        # state leaves that a restore could not take from the checkpoint
        # and reset to the operator's template (see _conform_state)
        self.template_fallbacks = 0

    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
    ) -> Segment:
        return self._build_on(spec, dataflow, init_states, self.device)

    def _build_on(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
        device: torch.device,
        count: bool = True,
    ) -> Segment:
        seg = build_segment(spec, dataflow, init_states=init_states, cache=self.compile_cache,
                            device=device, count=count)
        if self.capture:
            seg.graphs = CapturedStep(self._capture_stream(device), self.capture_stats)
        return seg

    def _device_of_segment(self, name: str) -> torch.device:
        """The device a segment's states and step live on."""
        return self.device

    def _capture_stream(self, device: torch.device) -> torch.cuda.Stream:
        stream = self._capture_streams.get(device)
        if stream is None:
            stream = self._capture_streams[device] = torch.cuda.Stream(device)
        return stream

    def kill(self, segment_name: str) -> None:
        seg = self.segments[segment_name]
        super().kill(segment_name)
        self._seg_events.pop(segment_name, None)
        if self._staging is not None:
            self._staging.pop(segment_name, None)
        if seg.graphs is not None:
            seg.graphs.release()

    def _drop_streams(self, seg: Segment) -> None:
        for tid in seg.spec.task_ids:
            self.broker.drop(topic_for(tid))

    def _fetch_inputs(self, seg: Segment) -> Dict[str, Any]:
        """Boundary inputs for one segment.

        During a concurrent step each topic read synchronizes on *its*
        producer's publish of this step (per-topic sequencing) — the
        ready-queue already dispatched producers first, so the wait is a
        cheap verification, but it guarantees deterministic inputs even
        under a looser dispatch. Over a numpy transport each input comes
        through the segment's host staging, as a tensor on its device.
        """
        targets = self._topic_target
        if self._staging is not None:
            staging = self._staging_of(seg.name)
            return {
                t: staging.fetch(self.transport, t, targets.get(t) if targets else None)
                for t in seg.boundary_topics
            }
        if targets is None:
            return {t: self.broker.fetch(t) for t in seg.boundary_topics}
        return {
            t: self.broker.fetch_synced(t, targets[t]) if t in targets else self.broker.fetch(t)
            for t in seg.boundary_topics
        }

    def _staging_of(self, name: str) -> HostStaging:
        staging = self._staging.get(name)
        if staging is None:
            staging = self._staging[name] = HostStaging(self._device_of_segment(name))
        return staging

    def _begin_concurrent_step(self) -> None:
        seqs = self.broker.sequences()
        self._topic_target = {
            topic_for(tid): seqs.get(topic_for(tid), 0) + 1
            for name, tids in self.forwarding.items()
            if name in self.segments
            for tid in tids
        }

    def _end_concurrent_step(self) -> None:
        self._topic_target = None

    def _dispatch_concurrent(self) -> Dict[str, float]:
        if self.device.type != "cuda":
            return super()._dispatch_concurrent()
        return self._issue_waves()

    def _issue_waves(self) -> Dict[str, float]:
        """A concurrent step on the card, issued from the stepping thread.

        Segment ``i`` of each wave goes onto wave stream ``i mod n``; before
        it, that stream waits on the end event of each of the segment's
        producers, so a consumer reads a batch only once it is complete,
        whichever stream wrote it. No dispatch thread and no synchronize
        comes between two segments: the host issues the whole step and
        then waits once for every stream. Returns each segment's device ms
        between a pair of events around its work on its stream.

        Tensors shared across streams stay safe without ``record_stream``
        because nothing a step reads is freed before that synchronize:
        published batches stay in the broker until the next step publishes
        again, graph buffers live as long as their segment, and the states
        a step replaces (an eager step's old states, a first load's
        originals) are held here until the end.
        """
        waves = self.segment_waves()
        width = self.max_workers or max((len(w) for w in waves), default=1)
        device_of = {name: self._device_of_segment(name) for wave in waves for name in wave}
        streams: Dict[torch.device, List[torch.cuda.Stream]] = {}
        current: Dict[torch.device, torch.cuda.Stream] = {}
        for device in set(device_of.values()) or {self.device}:
            streams[device] = self._streams(device, width)
            current[device] = torch.cuda.current_stream(device)
            start = torch.cuda.Event()
            start.record(current[device])
            for stream in streams[device]:
                stream.wait_event(start)
        done: Dict[str, torch.cuda.Event] = {}
        held: List[Any] = []
        try:
            for wave in waves:
                for i, name in enumerate(wave):
                    seg = self.segments[name]
                    stream = streams[device_of[name]][i % width]
                    for producer in self.seg_deps[name]:
                        stream.wait_event(done[producer])
                    begin, end = self._events_of(name)
                    held.append(seg.states)
                    with torch.cuda.stream(stream):
                        begin.record(stream)
                        if self.tracer.enabled:
                            with self.tracer.span(name, "segment", step=self.step_count):
                                self._run(seg)
                        else:
                            self._run(seg)
                        end.record(stream)
                    done[name] = end
        finally:
            for device, stream_list in streams.items():
                for stream in stream_list:
                    current[device].wait_stream(stream)
                current[device].synchronize()
            del held
        seg_ms = {name: self._seg_events[name][0].elapsed_time(end) for name, end in done.items()}
        for ms in seg_ms.values():
            self._m_seg_ms.observe(ms)
        return seg_ms

    def _streams(self, device: torch.device, n: int) -> List[torch.cuda.Stream]:
        """The first ``n`` wave streams of ``device``. PyTorch hands streams
        out round-robin from a pool of 32 per device, so one equal to the
        device's capture stream is passed over."""
        made = self._wave_streams.setdefault(device, [])
        capture = self._capture_streams.get(device)
        while len(made) < n:
            stream = torch.cuda.Stream(device)
            # compared with ``==``: torch.cuda.Stream defines only __eq__,
            # and ``stream != None`` (no capture stream) is false
            if not stream == capture:
                made.append(stream)
        return made[:n]

    def _events_of(self, name: str) -> Tuple[torch.cuda.Event, torch.cuda.Event]:
        events = self._seg_events.get(name)
        if events is None:
            events = self._seg_events[name] = (
                torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        return events

    def _step_one(self, seg: Segment) -> None:
        device = self._device_of_segment(seg.name)
        if device.type != "cuda":
            self._run(seg)
            return
        with torch.cuda.device(device):
            self._run(seg)
            # The Storm worker finishes its batch before acking: wait for
            # the card so segment_ms measures compute, not enqueueing.
            torch.cuda.current_stream(device).synchronize()

    def _run(self, seg: Segment) -> None:
        """Fetch, step and publish ``seg`` on the current stream, without
        waiting for it."""
        if self.tracer.enabled:
            with self.tracer.span("fetch", "transport", segment=seg.name,
                                  topics=len(seg.boundary_topics)):
                inputs = self._fetch_inputs(seg)
        else:
            inputs = self._fetch_inputs(seg)
        if seg.graphs is not None:
            # copies the inputs into the graph's, replays; states in place
            outputs = seg.graphs.step(seg, inputs)
        else:
            new_states, outputs = seg.step_fn(seg.states, seg.active, inputs)
            seg.states = new_states
        if self.tracer.enabled:
            with self.tracer.span("publish", "transport", segment=seg.name):
                self._publish(seg, outputs)
        else:
            self._publish(seg, outputs)
        seg.steps_run += 1

    def _publish(self, seg: Segment, outputs: Dict[str, Any]) -> None:
        tids = [tid for tid in self.forwarding[seg.name] if tid in outputs]
        if self._staging is not None:
            # on the card this waits for the segment's stream
            outputs = self._staging_of(seg.name).to_host(outputs, tids)
        for tid in tids:
            self.broker.publish(topic_for(tid), outputs[tid])

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
            # a numpy transport's topics are private host copies already
            return defer(map_leaves(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                    value), ready=ready)

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
        """Transport topic buffers + publish counters (the reference's keys).

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
            batch = np.asarray(decode_pytree(enc))
            if self._staging is None:
                batch = torch.as_tensor(batch).to(self.device)
            self.broker.publish(topic, batch)
        # publish() above bumped the counters; restore the checkpointed view
        self.broker.restore_counters(
            int(extra.get("broker_bytes_published", 0)),
            int(extra.get("broker_publishes", 0)),
        )

    def spawn_config(self) -> Dict[str, Any]:
        return {"transport": self.transport.name}


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
