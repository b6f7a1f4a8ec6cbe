"""Multiprocess data plane — persistent worker processes + the ``multiproc``
ExecutionBackend; the port's copy of ``repro.runtime.worker``.

The paper's DSPS runs a merged dataflow's segments in worker *processes*
(Storm's workers). This module does the same with the port's data plane:

  * :func:`_worker_main` — the worker loop. Each worker owns a set of
    deployed segments, built and stepped on the worker's device (the card
    unless the coordinator asks for the CPU) with the same
    :func:`~repro_torch.runtime.segment.build_segment`, operators and
    kernels the in-process ``torch`` backend uses (:class:`_TorchSegmentRunner`;
    on the card each segment's step is captured and replayed as CUDA
    graphs), attaches to the shared stream transport from a picklable
    spec, and executes commands from a duplex pipe: ``deploy / kill /
    step / step_many / step_chain / pause / resume / states / ping /
    cache_stats / metrics / obs / shutdown``. Boundary inputs are fetched
    from the transport and outputs published back as numpy arrays.
  * :class:`MultiprocBackend` — the coordinator. It steps nothing itself
    and needs no CUDA context: it keeps :class:`RemoteSegment` proxies
    (spec, cost weights, active flags) and drives workers through blocking
    pipe RPCs. Segments are placed onto workers by the pluggable
    :class:`~repro_torch.runtime.scheduler.PlacementPolicy` machinery; a
    flagged straggler moves to another worker when the policy says so
    (its states travel over the pipe, encoded).

Worker planes: ``"torch"`` (the data plane above) and ``"dry"``
(:class:`_DrySegmentLite`, sink counters and zero batches over the real
transport). The reference's ``"jit"`` plane names ``"torch"`` here, so its
payloads restore.

Workers spawn with the ``spawn`` start method (a forked child of a
process holding a CUDA context cannot use the card), receive the
coordinator's device and intra-op thread count in their spawn arguments
(so CPU reductions split their work alike and digests stay bitwise those
of the in-process backend), and append structured log lines to
``<log_dir>/worker-<i>.log`` (default: ``$REPRO_WORKER_LOG_DIR`` or a temp
dir). On the card the coordinator builds the kernel library once before it
spawns (:func:`repro_torch.kernels.build.build`: a compile, no CUDA
context), so N cold workers do not each run ``nvcc``.

Task states never cross a process as tensors: the worker encodes them to
host numpy (:func:`~repro_torch.runtime.checkpoint.encode_pytree`) for
``states``, migrations, shadow snapshots and checkpoints.

Checkpoint/restore: the coordinator drains workers (steps are synchronous
RPCs, so between steps every worker is idle), pulls encoded task states
per segment, and dumps through the shared
:meth:`~repro_torch.runtime.backend.ExecutionBackend.dump_state`; restore
re-spawns fresh workers and re-places every segment through the placement
policy (``worker_of_at_checkpoint`` hints feed the ``sticky`` policy).
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple, Union

from repro_torch.cluster.events import (
    POOL_GROWN,
    POOL_SHRUNK,
    SEGMENT_REDEPLOYED,
    WORKER_DEAD,
    WORKER_RESPAWNED,
)
from repro_torch.core.graph import Dataflow, Task
from repro_torch.obs import merge_snapshots, process_metrics, process_tracer
from repro_torch.ops.costs import cost_weight_for_task

from .backend import ExecutionBackend, PyTree, SegmentSpec, StepReport
from .broker import topic_for
from .checkpoint import decode_pytree, encode_pytree
from .scheduler import PlacedBackendMixin, PlacementPolicy
from .transport import Transport, TransportError, connect_transport, resolve_transport

WORKER_PLANES = ("torch", "dry")
# the reference's name of the plane that steps real segments
_PLANE_ALIASES = {"jit": "torch"}


def resolve_worker_plane(name: str) -> str:
    """A worker plane's name in the port (the reference's ``"jit"`` is
    ``"torch"``); raises on an unknown one."""
    plane = _PLANE_ALIASES.get(name, name)
    if plane not in WORKER_PLANES:
        raise ValueError(f"worker_plane must be one of {WORKER_PLANES}, got {name!r}")
    return plane


# -- the worker process ----------------------------------------------------------


class _WorkerLog:
    def __init__(self, path: str, worker_id: int):
        self.path = path
        self.worker_id = worker_id
        self._f = open(path, "a", buffering=1)

    def write(self, event: str, **fields: Any) -> None:
        stamp = time.strftime("%H:%M:%S")
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        self._f.write(f"[{stamp}] w{self.worker_id} {event} {kv}\n")

    def close(self) -> None:
        self._f.close()


class _DrySegmentLite:
    """Transport-riding stand-in for a segment (``worker_plane="dry"``):
    fetches boundary inputs, advances sink counters, publishes zero
    batches — the full distributed machinery without operators or a device.
    Useful for scheduler/transport studies and fast CI sweeps."""

    def __init__(self, spec: SegmentSpec, dataflow: Dataflow):
        import numpy as np

        self.spec = spec
        self.np = np
        self.sink_ids = [t for t in spec.task_ids if dataflow.tasks[t].is_sink]
        self.active = {t: True for t in spec.task_ids}
        self.states: Dict[str, Any] = {
            t: ({"count": 0, "checksum": 0.0} if t in self.sink_ids else ())
            for t in spec.task_ids
        }
        in_segment = set(spec.task_ids)
        self.boundary_topics = []
        for tid in spec.task_ids:
            for p in spec.parents[tid]:
                topic = topic_for(p)
                if p not in in_segment and topic not in self.boundary_topics:
                    self.boundary_topics.append(topic)

    def load_states(self, states: Dict[str, Any]) -> None:
        for tid, value in states.items():
            if tid in self.sink_ids and isinstance(value, dict):
                self.states[tid] = {"count": int(value.get("count", 0)), "checksum": 0.0}

    def pause(self, task_ids: Set[str]) -> None:
        for tid in task_ids:
            if tid in self.active:
                self.active[tid] = False

    def resume(self, task_ids: Set[str]) -> None:
        for tid in task_ids:
            if tid in self.active:
                self.active[tid] = True

    def step(self, transport: Transport, forward: List[str],
             targets: Optional[Dict[str, int]],
             local: Optional[Dict[str, Any]] = None) -> None:
        for topic in self.boundary_topics:
            if local is not None and topic in local:
                continue  # produced earlier in this worker's chain
            if targets and topic in targets:
                transport.fetch_synced(topic, targets[topic])
            else:
                try:
                    transport.fetch(topic)
                except KeyError:
                    pass  # producer not restored yet — dry plane tolerates
        for tid in self.sink_ids:
            if self.active[tid]:
                st = self.states[tid]
                self.states[tid] = {"count": st["count"] + 1, "checksum": 0.0}
        np = self.np
        for tid in forward:
            if tid in self.active and tid not in self.sink_ids:
                batch = np.zeros((self.spec.batch_of[tid], 8), np.float32)
                if local is not None:
                    local[topic_for(tid)] = batch
                transport.publish(topic_for(tid), batch)


class _TorchSegmentRunner:
    """Owns one segment inside a worker process, stepped on the worker's
    device with the port's own segment builder, operators and kernels.

    On the card it steps through CUDA graphs after its first, eager step,
    as :class:`~repro_torch.runtime.executor.TorchBackend` does
    (:mod:`repro_torch.runtime.graphs`): a captured step reads its
    boundary inputs from static buffers, into which each step copies the
    fetched batches. Boundary batches arrive as numpy arrays from the
    transport and leave as numpy arrays through the segment's
    :class:`~repro_torch.runtime.staging.HostStaging`: on the card each
    input goes through a pinned host staging buffer to the device, each
    forwarded output back through a pinned buffer, with one synchronize
    before the publishes. No tensor of the card crosses the process
    boundary."""

    def __init__(self, spec: SegmentSpec, dataflow: Dataflow,
                 init_states: Optional[Dict[str, Any]], device: Any,
                 capture: Any):
        from repro_torch.ops import operator_for_task

        from .compile_cache import process_compile_cache
        from .executor import _conform_state
        from .segment import build_segment
        from .staging import HostStaging

        self.device = device
        if init_states:
            # conform restored/migrated states onto the operator templates —
            # the same cross-backend coercion the in-process torch backend
            # applies (dry checkpoints seed sink counts, mismatched leaves
            # re-init)
            init_states = {
                tid: _conform_state(
                    value,
                    operator_for_task(
                        dataflow.tasks[tid], batch=spec.batch_of[tid], device=device
                    ).init_state(spec.batch_of[tid]),
                    [0],  # the count of leaves reset to the template
                )
                for tid, value in init_states.items()
            }
        # process-local step reuse: structurally identical segments deployed
        # to this worker share one canonical step and its operators
        self.seg = build_segment(
            spec, dataflow, init_states=init_states,
            cache=process_compile_cache(device), device=device,
        )
        if capture is not None:
            self.seg.graphs = capture()
        self.spec = spec
        self._staging = HostStaging(device)

    @property
    def boundary_topics(self) -> List[str]:
        return self.seg.boundary_topics

    def pause(self, task_ids: Set[str]) -> None:
        self.seg.pause(task_ids)

    def resume(self, task_ids: Set[str]) -> None:
        self.seg.resume(task_ids)

    @property
    def states(self) -> Dict[str, Any]:
        return self.seg.states

    def release(self) -> None:
        """Free the segment's graphs (it was killed)."""
        if self.seg.graphs is not None:
            self.seg.graphs.release()

    def step(self, transport: Transport, forward: List[str],
             targets: Optional[Dict[str, int]],
             local: Optional[Dict[str, Any]] = None) -> None:
        # with the worker's tracer armed, the step's phases as spans: its
        # fetches, its step (on the card: issued), the wait for the card
        # and the copies back, its publishes
        tracer = process_tracer()
        seg = self.seg
        inputs: Dict[str, Any] = {}
        with tracer.span("fetch", "transport", segment=seg.name):
            for topic in seg.boundary_topics:
                if local is not None and topic in local:
                    # produced earlier in this worker's chain — resolved
                    # locally (the producer's tensor), no transport round-trip
                    inputs[topic] = local[topic]
                else:
                    inputs[topic] = self._staging.fetch(
                        transport, topic, targets.get(topic) if targets else None)
        with tracer.span("step", "segment", segment=seg.name):
            if seg.graphs is not None:
                # copies the inputs into the graph's, replays; states in place
                outputs = seg.graphs.step(seg, inputs)
            else:
                new_states, outputs = seg.step_fn(seg.states, seg.active, inputs)
                seg.states = new_states
        out = [tid for tid in forward if tid in outputs]
        if self.device.type == "cuda":
            with tracer.span("wait", "segment", segment=seg.name):
                host = self._staging.to_host(outputs, out)
        else:
            host = self._staging.to_host(outputs, out)
        with tracer.span("publish", "transport", segment=seg.name):
            for tid in out:
                if local is not None:
                    local[topic_for(tid)] = outputs[tid]
                transport.publish(topic_for(tid), host[tid])
        seg.steps_run += 1


def _resolve_worker_device(options: Dict[str, Any]) -> Any:
    """The worker's device: the caller's, or the card. A worker asked for
    the card that finds none raises; it never steps on the CPU."""
    import torch

    device = torch.device(options.get("device") or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "this worker was asked for a CUDA device and none is available; "
                "pass device='cpu' to step on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


def _decode_spec(rec: Dict[str, Any]) -> SegmentSpec:
    return SegmentSpec(
        name=rec["name"],
        dag_name=rec["dag_name"],
        task_ids=list(rec["task_ids"]),
        parents={t: list(ps) for t, ps in rec["parents"].items()},
        publish=set(rec["publish"]),
        batch_of={t: int(b) for t, b in rec["batch_of"].items()},
        created_at=int(rec.get("created_at", 0)),
        fused=bool(rec.get("fused", False)),
    )


def _dataflow_from_tasks(dag_name: str, tasks: Dict[str, Dict[str, Any]]) -> Dataflow:
    df = Dataflow(dag_name)
    for tid, t in tasks.items():
        df.add_task(Task.make(tid, t["type"], t["config"]))
    return df


def _encode_states(runner: Any) -> Dict[str, Any]:
    """Encode a runner's post-step task states for the reply wire.

    These are the coordinator's *shadow snapshots*: committed atomically
    with the step reply, so a worker that dies mid-step leaves the shadow
    at the pre-step states and a deterministic re-step after respawn
    reproduces the uninterrupted trajectory exactly once."""
    return {tid: encode_pytree(runner.states[tid]) for tid in runner.spec.task_ids}


def _host_tree(x: Any) -> Any:
    """Tensors (on the card or not) -> host numpy, containers preserved —
    the cheap (no base64, no JSON tagging) state capture for spill
    snapshots."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_host_tree(v) for v in x)
    if isinstance(x, list):
        return [_host_tree(v) for v in x]
    import numpy as np

    if hasattr(x, "detach"):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def _spill_slots(path: str) -> Tuple[str, str]:
    """The two alternating slot files behind one logical spill path."""
    return f"{path}.a", f"{path}.b"


def _capture_states(runner: Any, ephemeral: Dict[str, tuple]) -> Dict[str, Any]:
    """Host-side copy of a segment's post-step states, minus ephemeral
    leaves (``repro_torch.ops.costs.ephemeral_state_keys``: keys every step
    overwrites wholesale, like a sink's retained batch — dropping them
    keeps the per-step spill tiny and recovery re-inits them from the
    operator template)."""
    out: Dict[str, Any] = {}
    for tid in runner.spec.task_ids:
        state = runner.states[tid]
        drop = ephemeral.get(tid)
        if drop and isinstance(state, dict):
            state = {k: v for k, v in state.items() if k not in drop}
        out[tid] = _host_tree(state)
    return out


class _SpillWriter:
    """Double-buffered combined spill writer: persists the post-step
    states of EVERY spill-armed segment a worker owns to one worker-local
    file, written once per step batch BEFORE the step reply is sent.

    Each entry carries a completed-step counter — what makes recovery
    exactly-once without per-step wire snapshots: a worker that dies
    *before* the write leaves the freshest entry one step behind the
    in-flight step (re-step it), one that dies *after* the write but
    before the reply leaves it one step ahead of what the coordinator
    confirmed (skip the re-step — the outputs were already published).
    One write per wave batch instead of one per segment matters because
    the cost is dominated by fixed per-write work, not payload bytes
    (ephemeral-filtered states are a few hundred bytes per segment).

    Two slot files are held open for the writer's lifetime and written
    alternately (seek/truncate/dump/flush), so the steady state pays no
    open/rename syscalls. A crash can tear at most the slot being
    written; the other slot is intact one write behind, and a torn pickle
    stream never loads (the STOP opcode is its last byte), so the
    coordinator-side reader merges both slots taking each segment's
    highest-step entry."""

    def __init__(self, path: str):
        self._writes = 0
        self._files = []
        for p in _spill_slots(path):
            # r+b, not wb: a respawned worker must not blank the slots the
            # coordinator may still need for a subsequent recovery
            self._files.append(open(p, "r+b" if os.path.exists(p) else "w+b"))

    def write(self, entries: Dict[str, Dict[str, Any]]) -> None:
        f = self._files[self._writes % 2]
        self._writes += 1
        f.seek(0)
        f.truncate()
        pickle.dump({"segments": entries}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()

    def close(self) -> None:
        for f in self._files:
            try:
                f.close()
            except OSError:  # pragma: no cover - close is best-effort
                pass


def _worker_main(conn, worker_id: int, transport_spec: Dict[str, Any],
                 plane: str, log_path: str,
                 options: Optional[Dict[str, Any]] = None) -> None:
    """The worker loop: blocking command RPCs against owned segments.

    ``options``: ``device`` (None: the card) and ``threads`` (torch's
    intra-op thread count, the coordinator's). On the card every segment
    steps through CUDA graphs after its first step."""
    options = dict(options or {})
    plane = resolve_worker_plane(plane)
    log = _WorkerLog(log_path, worker_id)
    log.write("start", pid=os.getpid(), plane=plane,
              transport=transport_spec.get("kind"), device=options.get("device"))
    if options.get("threads"):
        import torch

        torch.set_num_threads(int(options["threads"]))
    transport = connect_transport(transport_spec)
    # the torch plane's device, resolved at the first deploy (a worker asked
    # for the card without one raises there), and what the card holds
    runtime: Dict[str, Any] = {}
    device_memory: Dict[str, Any] = {}

    def _runtime() -> Dict[str, Any]:
        if not runtime:
            device = _resolve_worker_device(options)
            runtime["device"] = device
            runtime["capture"] = None
            if device.type == "cuda":
                import torch

                from .graphs import CapturedStep, CaptureStats

                free, total = torch.cuda.mem_get_info(device)
                device_memory.update(total=total, free_at_start=free)
                stream, stats = torch.cuda.Stream(device), CaptureStats()
                runtime["capture_stats"] = stats
                runtime["capture"] = lambda: CapturedStep(stream, stats)
        return runtime

    def _note_first_step() -> None:
        if "free_after_first_step" in device_memory or not device_memory:
            return
        import torch

        device = runtime["device"]
        device_memory["free_after_first_step"] = torch.cuda.mem_get_info(device)[0]
    # telemetry plane: the per-process registry/tracer the coordinator
    # pulls over the "metrics" op (tracer stays disabled until an "obs"
    # op arms it — spans are worker-side monotonic, so they line up with
    # coordinator spans in one merged Chrome trace)
    tracer = process_tracer()
    wm = process_metrics()
    w_seg_ms = wm.histogram(
        "repro_worker_segment_step_ms",
        "worker-measured per-segment step time (ms)",
    )
    w_steps = wm.counter(
        "repro_worker_segment_steps_total",
        "segment steps executed inside worker processes",
    )

    def _timed_step(name: str, runner: Any, forward: List[str],
                    targets: Optional[Dict[str, int]],
                    local: Optional[Dict[str, Any]] = None) -> float:
        t0 = time.perf_counter()
        if tracer.enabled:
            with tracer.span(name, "segment", worker=worker_id):
                runner.step(transport, forward, targets, local=local)
        else:
            runner.step(transport, forward, targets, local=local)
        ms = (time.perf_counter() - t0) * 1e3
        w_seg_ms.observe(ms)
        w_steps.inc()
        _note_first_step()
        return ms

    segments: Dict[str, Any] = {}
    spill_writer: Optional[_SpillWriter] = None  # one combined file per worker
    spill_entries: Dict[str, Dict[str, Any]] = {}  # segment -> {step, states}
    spill_step: Dict[str, int] = {}  # segment -> completed-step counter
    spill_ephem: Dict[str, Dict[str, tuple]] = {}  # segment -> tid -> keys
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            log.write("coordinator-gone")
            break
        op = msg.get("op")
        try:
            reply: Dict[str, Any] = {"ok": True}
            if op == "deploy":
                spec = _decode_spec(msg["spec"])
                df = _dataflow_from_tasks(spec.dag_name, msg["tasks"])
                init = (
                    {t: decode_pytree(enc) for t, enc in msg["states"].items()}
                    if msg.get("states")
                    else None
                )
                if plane == "torch":
                    rt = _runtime()
                    segments[spec.name] = _TorchSegmentRunner(
                        spec, df, init, rt["device"], rt["capture"])
                else:
                    runner = _DrySegmentLite(spec, df)
                    if init:
                        runner.load_states(init)
                    segments[spec.name] = runner
                spill_entries.pop(spec.name, None)  # redeploy resets history
                if msg.get("spill"):
                    from repro_torch.ops.costs import ephemeral_state_keys

                    spill_ephem[spec.name] = {
                        tid: keys
                        for tid in spec.task_ids
                        if (keys := ephemeral_state_keys(df.tasks[tid]))
                    }
                    spill_step[spec.name] = int(msg.get("step0", 0))
                    if spill_writer is None:
                        spill_writer = _SpillWriter(msg["spill"])
                else:
                    spill_step.pop(spec.name, None)
                    spill_ephem.pop(spec.name, None)
                log.write("deploy", segment=spec.name, tasks=len(spec.task_ids))
            elif op == "kill":
                runner = segments.pop(msg["segment"])
                for tid in runner.spec.task_ids:
                    transport.drop(topic_for(tid))
                if plane == "torch":
                    runner.release()
                spill_entries.pop(msg["segment"], None)
                spill_step.pop(msg["segment"], None)
                spill_ephem.pop(msg["segment"], None)
                log.write("kill", segment=msg["segment"])
            elif op == "step":
                name = msg["segment"]
                runner = segments[name]
                reply["ms"] = _timed_step(
                    name, runner, msg["forward"], msg.get("targets")
                )
                if name in spill_step:
                    spill_step[name] += 1
                    t1 = time.perf_counter()
                    spill_entries[name] = {
                        "step": spill_step[name],
                        "states": _capture_states(runner, spill_ephem[name]),
                    }
                    spill_writer.write(spill_entries)
                    reply["spill_ms"] = (time.perf_counter() - t1) * 1e3
                if msg.get("snap"):
                    reply["states"] = {name: _encode_states(runner)}
            elif op in ("step_many", "step_chain"):
                # wave-batched dispatch: step every named segment (for
                # "step_many", mutually independent members of one wave, in
                # launch order) under a single command round-trip —
                # per-segment Python dispatch runs inside this process, so
                # coordinator RPC overhead amortizes to one round-trip per
                # worker per wave instead of one per segment.
                #
                # "step_chain" goes further: the entries span *consecutive
                # waves* of one step, in global wave order, so a deep
                # same-worker chain costs one round-trip per worker per
                # STEP. Intra-chain boundary streams are resolved through
                # the ``local`` dict (publisher stores, consumer reads) —
                # no transport hop at all — while cross-worker reads still
                # ride the per-topic sequence targets (a blocked
                # fetch_synced waits on a producer in an earlier wave,
                # which its worker reaches by the same global order, so
                # chains never deadlock).
                local = {} if op == "step_chain" else None
                ms: Dict[str, float] = {}
                snaps: Dict[str, Dict[str, Any]] = {}
                spill_ms = 0.0
                spilled = False
                for entry in msg["segments"]:
                    name = entry["segment"]
                    runner = segments[name]
                    ms[name] = _timed_step(
                        name, runner, entry["forward"],
                        entry.get("targets"), local=local,
                    )
                    if name in spill_step:
                        spill_step[name] += 1
                        t1 = time.perf_counter()
                        spill_entries[name] = {
                            "step": spill_step[name],
                            "states": _capture_states(
                                runner, spill_ephem[name]
                            ),
                        }
                        spill_ms += (time.perf_counter() - t1) * 1e3
                        spilled = True
                    if msg.get("snap"):
                        snaps[name] = _encode_states(runner)
                if spilled:
                    # one combined durable write per batch: fixed per-write
                    # cost amortizes across every segment in the wave
                    t1 = time.perf_counter()
                    spill_writer.write(spill_entries)
                    spill_ms += (time.perf_counter() - t1) * 1e3
                reply["ms"] = ms
                if spill_ms:
                    reply["spill_ms"] = spill_ms
                if msg.get("snap"):
                    reply["states"] = snaps
            elif op == "pause":
                segments[msg["segment"]].pause(set(msg["tasks"]))
            elif op == "resume":
                segments[msg["segment"]].resume(set(msg["tasks"]))
            elif op == "states":
                runner = segments[msg["segment"]]
                reply["states"] = {
                    tid: encode_pytree(runner.states[tid])
                    for tid in runner.spec.task_ids
                }
            elif op == "ping":
                reply["pid"] = os.getpid()
                # what this process imported of the reference or of JAX (none)
                reply["foreign_modules"] = sorted(
                    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                )
            elif op == "cache_stats":
                if plane == "torch" and runtime:
                    from .compile_cache import process_compile_cache

                    reply["stats"] = process_compile_cache(runtime["device"]).stats()
                else:  # the dry plane builds no step; nothing deployed yet
                    reply["stats"] = {
                        "hits": 0, "misses": 0, "evictions": 0, "entries": 0,
                    }
            elif op == "metrics":
                # telemetry pull (same aggregation pattern as cache_stats):
                # the registry snapshot is cumulative and idempotent, the
                # span buffer drains destructively — the coordinator
                # buffers drained spans until its own drain_spans()
                reply["metrics"] = wm.snapshot()
                reply["spans"] = tracer.drain()
                # the port's kernel launches in this process (graph replays
                # included), which the coordinator sums over its workers
                from repro_torch.kernels import build

                reply["launches"] = build.launch_counts()
                if device_memory:
                    import torch

                    device = runtime["device"]
                    stats = runtime["capture_stats"]
                    reply["device"] = dict(
                        device_memory,
                        reserved=torch.cuda.memory_reserved(device),
                        max_reserved=torch.cuda.max_memory_reserved(device),
                        graphs=stats.graphs,
                        graph_pool_bytes=stats.pool_bytes,
                    )
            elif op == "obs":
                tracer.configure(
                    enabled=msg.get("trace"),
                    sample_stride=msg.get("sample_stride"),
                    capacity=msg.get("capacity"),
                )
            elif op == "shutdown":
                log.write("shutdown")
            else:
                raise ValueError(f"unknown worker op {op!r}")
        except BaseException as e:  # noqa: BLE001 - reported to coordinator
            log.write("error", op=op, error=repr(e))
            log._f.write(traceback.format_exc())
            reply = {"error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()}
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            break
        if op == "shutdown":
            break
    try:
        transport.close()
    except Exception:  # pragma: no cover - shutdown best-effort
        pass
    log.close()


# -- the coordinator backend ------------------------------------------------------


class WorkerError(RuntimeError):
    """A worker failed. ``worker``/``gen`` identify the process incarnation
    when the failure was fatal to it (pipe EOF, hang timeout) — the cluster
    plane's recovery hook uses them to respawn exactly that incarnation.
    Application-level errors reported by a *live* worker leave them ``None``
    (respawning would not fix a logic error)."""

    def __init__(self, message: str, worker: Optional[int] = None,
                 gen: Optional[int] = None):
        super().__init__(message)
        self.worker = worker
        self.gen = gen


@dataclass
class RemoteSegment:
    """Parent-side proxy of a segment deployed inside a worker process.

    Carries everything the shared accounting needs (spec, per-task cost
    weights, active flags as plain bools); task states are fetched from
    the worker on demand (checkpoint dumps, defrag carry-over) and cached
    per step."""

    spec: SegmentSpec
    backend: "MultiprocBackend"
    cost_of: Dict[str, float]
    active: Dict[str, bool]
    steps_run: int = 0
    # recovery found the segment's spill one step AHEAD of what the
    # coordinator confirmed (worker died after publish+spill but before
    # the reply): that many re-dispatches are no-ops, not re-steps
    _skip_steps: int = 0
    _states_cache: Optional[Dict[str, Any]] = field(default=None, repr=False)
    _states_step: int = -1

    @property
    def name(self) -> str:
        return self.spec.name

    def live_task_ids(self) -> List[str]:
        return [t for t in self.spec.task_ids if self.active[t]]

    def pause(self, task_ids: Set[str]) -> None:
        hit = [t for t in task_ids if t in self.active]
        if not hit:
            return
        for tid in hit:
            self.active[tid] = False
        self.backend._segment_call(self, {"op": "pause", "tasks": hit})
        self._states_cache = None

    def resume(self, task_ids: Set[str]) -> None:
        hit = [t for t in task_ids if t in self.active]
        if not hit:
            return
        for tid in hit:
            self.active[tid] = True
        self.backend._segment_call(self, {"op": "resume", "tasks": hit})
        self._states_cache = None

    @property
    def states(self) -> Dict[str, Any]:
        """Decoded task states, pulled from the worker (cached per step)."""
        step = self.backend.step_count
        if self._states_cache is None or self._states_step != step:
            reply = self.backend._segment_call(self, {"op": "states"})
            self._states_cache = {
                tid: decode_pytree(enc) for tid, enc in reply["states"].items()
            }
            self._states_step = step
        return self._states_cache


class MultiprocBackend(PlacedBackendMixin, ExecutionBackend):
    """Worker-process data plane behind the ExecutionBackend protocol.

    The coordinator (this class) steps nothing and needs no CUDA context;
    each of ``workers`` spawned processes builds and steps its segments
    with the in-process torch backend's machinery on ``device`` (the card
    by default; ``"cpu"`` on request) — ``worker_plane="torch"``, the
    reference's ``"jit"`` — or a lightweight transport-riding cost plane
    (``"dry"``). On the card the workers step each segment through CUDA
    graphs, as the torch backend does. Boundary streams cross processes on a
    :class:`~repro_torch.runtime.transport.Transport` that must support
    multi-process attachment — ``"shm"`` (default) or ``"tcp"``; the
    in-process broker is rejected with a clear error.

    Stepping composes with both pipeline modes: ``sync`` issues one
    blocking RPC per segment in launch order; ``concurrent`` lets the
    wave/ready-queue scheduler issue RPCs from its thread pool, where
    ``conn.recv`` releases the GIL — independent segments on different
    workers execute simultaneously, which is what lifts the threaded
    dispatch's GIL cap.
    """

    name = "multiproc"

    def __init__(
        self,
        workers: int = 2,
        transport: Any = "shm",
        transport_options: Optional[Dict[str, Any]] = None,
        placement: Union[str, PlacementPolicy] = "round_robin",
        worker_plane: str = "torch",
        log_dir: Optional[str] = None,
        ewma_decay: float = 0.6,
        step_mode: str = "sync",
        max_workers: Optional[int] = None,
        launcher: Any = "local",
        rpc_timeout: Optional[float] = None,
        chain_batching: bool = True,
        device: Optional[Any] = None,
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        worker_plane = resolve_worker_plane(worker_plane)
        super().__init__(
            step_mode=step_mode,
            # the dispatch pool must cover every worker or RPC overlap dies
            max_workers=max_workers if max_workers is not None else max(workers, 2),
        )
        import torch

        from repro_torch.cluster.launcher import resolve_launcher

        self.n_workers = workers
        self.worker_plane = worker_plane
        # the workers' device (as a string: the coordinator makes no CUDA
        # context) and torch's intra-op thread count, passed to each spawn
        self.device = str(device) if device is not None else "cuda"
        self._worker_options: Dict[str, Any] = {
            "device": self.device,
            "threads": torch.get_num_threads(),
        }
        # per worker: its last reported kernel launches and device memory
        self._worker_device: Dict[int, Dict[str, Any]] = {}
        # seconds from the pool's spawn to the end of the first step
        # (process start, imports, the device, each segment's first step)
        self._spawned_at: Optional[float] = None
        self.first_step_s: Optional[float] = None
        self.transport: Transport = resolve_transport(
            transport, **(transport_options or {})
        )
        # fail fast: the transport must be attachable from worker processes
        self._transport_spec = self.transport.connect_info()
        self.log_dir = (
            log_dir
            or os.environ.get("REPRO_WORKER_LOG_DIR")
            or tempfile.mkdtemp(prefix="repro-workers-")
        )
        os.makedirs(self.log_dir, exist_ok=True)
        self._init_placement(placement, ewma_decay=ewma_decay)
        self.launcher = resolve_launcher(launcher)
        self._procs: List[Any] = []  # WorkerHandles, indexed by worker slot
        # RLock, not Lock: recovery respawns a worker while holding its
        # conn lock and then redeploys through _call on the same thread
        self._conn_locks: List[threading.RLock] = []
        self._gen: List[int] = []  # incarnation counter per slot
        self._topic_target: Optional[Dict[str, int]] = None
        # Worker-local dependency batching (concurrent mode): flatten each
        # step's waves into one per-worker chain shipped as a single
        # "step_chain" RPC — one round-trip per worker per step, not per
        # wave, with intra-chain boundary streams resolved inside the
        # worker. Disabled automatically while rpc_timeout is armed: the
        # hang bound is calibrated for per-wave replies, and a chain reply
        # legitimately takes a whole step.
        self.chain_batching = bool(chain_batching)
        self._spawned = False
        # -- cluster plane state (recovery, snapshots, health) ----------------
        self.rpc_timeout = rpc_timeout  # hang bound on RPC replies (None = wait)
        self.self_heal = False  # supervisor attach flips this on
        self.shadow_states = False  # piggyback post-step states on replies
        self.snapshot_every = 1  # shadow refresh cadence (steps)
        # "spill": workers persist post-step states to worker-local files
        # (cheap: pickle, no wire traffic); "wire": states ride step replies
        # (works for launchers whose workers share no filesystem)
        self.snapshot_mode = "wire"
        self._spill_ewma: Optional[float] = None  # worker-reported spill ms/step
        self._spill_dir: Optional[str] = None
        self._shadow: Dict[str, Dict[str, Any]] = {}  # segment -> encoded states
        self._recover_lock = threading.Lock()
        self.respawns: List[Dict[str, Any]] = []
        # -- telemetry plane (repro_torch.obs) --------------------------------
        self._worker_spans: List[Dict[str, Any]] = []  # harvested, undrained
        self._obs_msg: Optional[Dict[str, Any]] = None  # replayed to (re)spawns
        self._last_ok: Dict[int, float] = {}  # worker -> monotonic of last good RPC
        # worker -> the incarnation that sent its last reply: a worker whose
        # current incarnation has not replied yet is still spawning
        self._replied_gen: Dict[int, int] = {}
        # worker_health(): a worker whose last good RPC is older than this
        # is marked stale (supervision surfaces it through serving status)
        self.stale_after_ms = 5000.0

    def _mint_instruments(self) -> None:
        super()._mint_instruments()
        self._m_rpcs = self.metrics.counter(
            "repro_worker_rpcs_total",
            "coordinator-to-worker command RPCs completed, by op",
        )
        self._m_respawns = self.metrics.counter(
            "repro_worker_respawns_total",
            "worker processes respawned by crash recovery",
        )

    # -- worker pool ------------------------------------------------------------
    def _spawn_worker(self, worker: int) -> Any:
        log_path = os.path.join(self.log_dir, f"worker-{worker}.log")
        return self.launcher.launch(
            worker, self._transport_spec, self.worker_plane, log_path,
            options=self._worker_options,
        )

    def _ensure_workers(self) -> None:
        if self._spawned:
            return
        if self.worker_plane == "torch" and self.device.startswith("cuda"):
            # compile the kernel library once, here (no CUDA context), so
            # the workers load it instead of each running nvcc; without a
            # compiler the workers report what they lack themselves
            from repro_torch.kernels import build

            try:
                build.find_nvcc()
            except build.KernelBuildError:
                pass
            else:
                build.build()
        self._spawned = True
        self._spawned_at = time.perf_counter()
        for i in range(self.n_workers):
            self._procs.append(self._spawn_worker(i))
            self._conn_locks.append(threading.RLock())
            self._gen.append(0)
        for i in range(self.n_workers):
            self._push_obs(i)

    def _push_obs(self, worker: int) -> None:
        """Replay the armed trace configuration to a (re)spawned worker."""
        if self._obs_msg is None:
            return
        try:
            self._call(worker, self._obs_msg)
        except WorkerError:
            pass  # tracing is best-effort; liveness checks catch real deaths

    def _roundtrip(self, conn: Any, msg: Dict[str, Any], worker: int,
                   gen: int) -> Dict[str, Any]:
        conn.send(msg)
        if self.rpc_timeout is not None and not conn.poll(self.rpc_timeout):
            # hang bound exceeded: the pipe is now out of sync, so
            # this incarnation is unusable — recovery is mandatory
            raise WorkerError(
                f"worker {worker} hung on {msg.get('op')!r} "
                f"(> {self.rpc_timeout}s)", worker=worker, gen=gen,
            )
        return conn.recv()

    def _call(self, worker: int, msg: Dict[str, Any]) -> Dict[str, Any]:
        """One blocking RPC to a worker; serialized per worker, overlapping
        across workers (recv releases the GIL)."""
        self._ensure_workers()
        gen = self._gen[worker]
        op = msg.get("op")
        with self._conn_locks[worker]:
            conn = self._procs[worker].conn
            try:
                if self.tracer.enabled:
                    with self.tracer.span(f"rpc:{op}", "rpc", worker=worker):
                        reply = self._roundtrip(conn, msg, worker, gen)
                else:
                    reply = self._roundtrip(conn, msg, worker, gen)
            except (EOFError, BrokenPipeError, OSError) as e:
                raise WorkerError(
                    f"worker {worker} died during {msg.get('op')!r} "
                    f"(log: {os.path.join(self.log_dir, f'worker-{worker}.log')})",
                    worker=worker, gen=gen,
                ) from e
        # a reply arrived — even an application error means the worker is
        # alive, so the health staleness clock resets here
        self._m_rpcs.inc(op=str(op))
        self._last_ok[worker] = time.monotonic()
        self._replied_gen[worker] = gen
        if "error" in reply:
            raise WorkerError(
                f"worker {worker} failed {msg.get('op')!r}: {reply['error']}\n"
                f"{reply.get('traceback', '')}"
            )
        return reply

    def worker_alive(self, worker: int) -> bool:
        """Cheap liveness: the launched process still exists (no pipe I/O)."""
        if not self._spawned or worker >= len(self._procs):
            return False
        return self._procs[worker].is_alive()

    def worker_ready(self, worker: int) -> bool:
        """The worker's current incarnation has answered an RPC: it has
        finished spawning (imported torch, and on its first deploy made
        its device context), so a slow reply from it means a hang."""
        return (worker < len(self._gen)
                and self._replied_gen.get(worker) == self._gen[worker])

    def ping_worker(self, worker: int, timeout: float = 5.0) -> bool:
        """Active liveness probe: a ``ping`` RPC bounded by ``timeout``.

        A ``False`` from a timeout poisons the command pipe (a late reply
        would desync framing), so callers must treat it as fatal and
        recover the worker — the supervisor does."""
        self._ensure_workers()
        with self._conn_locks[worker]:
            conn = self._procs[worker].conn
            try:
                conn.send({"op": "ping"})
                if not conn.poll(timeout):
                    return False
                reply = conn.recv()
            except (EOFError, BrokenPipeError, OSError):
                return False
        return "pid" in reply

    def _segment_call(self, seg: RemoteSegment, msg: Dict[str, Any]) -> Dict[str, Any]:
        msg = dict(msg)
        msg["segment"] = seg.spec.name
        return self._call(self.device_of[seg.spec.name], msg)

    # -- placement hooks (PlacedBackendMixin) -----------------------------------
    def _n_slots(self) -> int:
        return self.n_workers

    def _move_segment(self, seg: RemoteSegment, old: int, new: int) -> None:
        """Migrate a straggling segment to another worker: pull its encoded
        states, kill it on the old worker, redeploy on the new one."""
        reply = self._call(old, {"op": "states", "segment": seg.spec.name})
        self._call(old, {"op": "kill", "segment": seg.spec.name})
        self.device_of[seg.spec.name] = new  # before deploy RPC below
        self._deploy_rpc(new, seg.spec, states=reply["states"],
                         step0=seg.steps_run)
        self._reapply_pauses(new, seg)
        seg._states_cache = None

    # -- cluster plane: recovery and elasticity -----------------------------------
    def _spill_file(self, worker: int) -> str:
        if self._spill_dir is None:
            # prefer tmpfs: spill writes sit on every step's critical path,
            # and /tmp is often disk-backed (~7x slower per write)
            base = "/dev/shm" if os.path.isdir("/dev/shm") else None
            self._spill_dir = tempfile.mkdtemp(prefix="repro-spill-", dir=base)
        return os.path.join(self._spill_dir, f"worker-{worker}.pkl")

    def _read_spill(self, worker: int) -> Dict[str, Dict[str, Any]]:
        """Per-segment spill entries of one worker's combined file.

        Both alternating slots are read (a crash tears at most the slot
        being written) and merged per segment, highest step wins. Entries
        can be stale — a segment that migrated here and died before its
        first step leaves an old incarnation's entry — so callers must
        check the step counter against the coordinator's count."""
        merged: Dict[str, Dict[str, Any]] = {}
        if self._spill_dir is None:
            return merged
        for slot in _spill_slots(self._spill_file(worker)):
            try:
                with open(slot, "rb") as f:
                    payload = pickle.load(f)
            except (OSError, EOFError, pickle.UnpicklingError):
                continue  # slot never written, or torn by the crash
            for name, entry in payload.get("segments", {}).items():
                cur = merged.get(name)
                if cur is None or int(entry["step"]) > int(cur["step"]):
                    merged[name] = entry
        return merged

    def _recovery_states(self, seg: RemoteSegment,
                         spilled: Dict[str, Dict[str, Any]]):
        """Freshest redeploy states for a dead worker's segment.

        Returns ``(encoded_states, step0, skip)``. In spill mode the
        worker-local entry carries a completed-step counter: equal to the
        coordinator's count means the state is current (any in-flight step
        simply re-runs); one ahead means the lost step actually completed
        (outputs published, spill written, reply lost) — redeploy the
        advanced state and *skip* the re-dispatch. A counter outside that
        range is a stale entry from before a migration: fall back to the
        shadow snapshot, which the deploy RPC keeps at deploy-time states
        (always pre-step at death)."""
        entry = spilled.get(seg.spec.name)
        if entry is not None:
            k = int(entry["step"])
            if k in (seg.steps_run, seg.steps_run + 1):
                states = {
                    tid: encode_pytree(v)
                    for tid, v in entry["states"].items()
                }
                return states, k, k == seg.steps_run + 1
        return self._shadow.get(seg.spec.name), seg.steps_run, False

    def _reapply_pauses(self, worker: int, seg: RemoteSegment) -> None:
        paused = [t for t in seg.spec.task_ids if not seg.active[t]]
        if paused:
            self._call(worker, {"op": "pause", "segment": seg.spec.name,
                                "tasks": paused})

    def recover_worker(self, worker: int, expect_gen: Optional[int] = None) -> Dict[str, Any]:
        """Respawn a dead/hung worker in place and redeploy its segments.

        States come from the freshest source available — the worker-local
        spill file (``snapshot_mode="spill"``) or the shadow snapshot
        committed with the segment's last step reply (``"wire"``), falling
        back to deploy-time states; all encoded, so no tensor is touched in
        the coordinator (see :meth:`_recovery_states` for the exactly-once
        step accounting). ``expect_gen`` makes recovery idempotent under
        races: a heartbeat thread and a stepping thread that both observe
        the same death recover it exactly once (the second caller sees the
        bumped generation and returns without respawning)."""
        with self._recover_lock:
            if expect_gen is not None and self._gen[worker] != expect_gen:
                return {"worker": worker, "segments": [], "ms": 0.0,
                        "already_recovered": True}
            t0 = time.perf_counter()
            self._emit_worker_event(WORKER_DEAD, worker=worker,
                                    detail=f"gen={self._gen[worker]}")
            with self._conn_locks[worker]:
                old = self._procs[worker]
                try:
                    old.terminate()
                except Exception:
                    pass
                old.join(timeout=5)
                old.close()
                self._procs[worker] = self._spawn_worker(worker)
                self._gen[worker] += 1
                self._m_respawns.inc()
                self._emit_worker_event(WORKER_RESPAWNED, worker=worker,
                                        detail=f"gen={self._gen[worker]}")
                self._push_obs(worker)
                redeployed: List[str] = []
                spilled = (
                    self._read_spill(worker)
                    if self.snapshot_mode == "spill" else {}
                )
                for name in sorted(
                    n for n, w in self.device_of.items() if w == worker
                ):
                    seg = self.segments.get(name)
                    if seg is None:
                        continue
                    states, step0, skip = self._recovery_states(seg, spilled)
                    self._deploy_rpc(worker, seg.spec, states=states,
                                     step0=step0)
                    if skip:
                        seg._skip_steps += 1
                    self._reapply_pauses(worker, seg)
                    seg._states_cache = None
                    redeployed.append(name)
            ms = (time.perf_counter() - t0) * 1e3
            self._emit_worker_event(
                SEGMENT_REDEPLOYED, worker=worker, ms=ms,
                detail=f"{len(redeployed)} segment(s): {', '.join(redeployed)}",
            )
            record = {"worker": worker, "segments": redeployed, "ms": ms,
                      "step": self.step_count}
            self.respawns.append(record)
            return record

    def _step_recover(self, name: str, exc: BaseException) -> bool:
        """Self-healing hook for the stepping paths: recover the dead
        worker so the failed item can be re-dispatched instead of erroring
        the whole step. Only fatal worker failures qualify, and only once
        the supervisor has armed ``self_heal``."""
        if not self.self_heal or not isinstance(exc, WorkerError):
            return False
        if exc.worker is None or exc.worker >= self.n_workers:
            return False
        self.recover_worker(exc.worker, expect_gen=exc.gen)
        return True

    def resize_pool(self, n: int) -> None:
        """Grow or shrink the worker pool without stopping the system.

        Growing spawns fresh workers (new segments land there via the
        placement policy; straggler migration rebalances existing ones).
        Shrinking migrates every segment off the retiring workers to the
        least-pressured survivors, then shuts the retirees down."""
        if n < 1:
            raise ValueError(f"worker pool size must be >= 1, got {n}")
        self._ensure_workers()
        if n == self.n_workers:
            return
        t0 = time.perf_counter()
        if n > self.n_workers:
            for i in range(self.n_workers, n):
                self._procs.append(self._spawn_worker(i))
                self._conn_locks.append(threading.RLock())
                self._gen.append(0)
                self._push_obs(i)
            grown = n - self.n_workers
            self.n_workers = n
            self._emit_worker_event(
                POOL_GROWN, ms=(time.perf_counter() - t0) * 1e3,
                detail=f"+{grown} -> {n} workers",
            )
        else:
            ewma = self.device_ewma()
            load: Dict[int, int] = {i: 0 for i in range(n)}
            for name, w in self.device_of.items():
                if w < n:
                    load[w] += len(self.segments[name].spec.task_ids)
            moved = 0
            for name, w in sorted(self.device_of.items()):
                if w < n:
                    continue
                target = min(range(n),
                             key=lambda i: (ewma.get(i, 0.0), load[i], i))
                seg = self.segments[name]
                self._move_segment(seg, w, target)
                load[target] += len(seg.spec.task_ids)
                moved += 1
            for i in reversed(range(n, self.n_workers)):
                handle = self._procs.pop(i)
                try:
                    with self._conn_locks[i]:
                        handle.conn.send({"op": "shutdown"})
                        handle.conn.recv()
                except (EOFError, BrokenPipeError, OSError):
                    pass
                handle.close()
                handle.join(timeout=5)
                if handle.is_alive():  # pragma: no cover - stuck worker
                    handle.terminate()
                self._conn_locks.pop(i)
                self._gen.pop(i)
                self._replied_gen.pop(i, None)
                self._ewma_residual.pop(i, None)
            shrunk = self.n_workers - n
            self.n_workers = n
            self._emit_worker_event(
                POOL_SHRUNK, ms=(time.perf_counter() - t0) * 1e3,
                detail=f"-{shrunk} -> {n} workers ({moved} segments migrated)",
            )
        # the dispatch pool must keep covering every worker
        self._reset_pool()
        self.max_workers = max(self.n_workers, 2)

    def worker_health(self) -> Dict[str, Any]:
        """Cluster-plane health snapshot (serving surfaces this verbatim).

        ``last_ok_monotonic`` records each worker's most recent good RPC
        reply on the coordinator's monotonic clock (``now_monotonic`` is
        the same clock at snapshot time, so readers compute ages without
        wall-clock skew); ``stale`` marks workers whose last reply is
        older than ``stale_after_ms`` — ``None`` for a worker never yet
        called (no RPC issued, nothing to age)."""
        per_worker: Dict[int, int] = {i: 0 for i in range(self.n_workers)}
        for name, w in self.device_of.items():
            if name in self.segments and w in per_worker:
                per_worker[w] += 1
        now = time.monotonic()
        stale: Dict[str, Optional[bool]] = {}
        for i in range(self.n_workers):
            t = self._last_ok.get(i)
            stale[str(i)] = (
                None if t is None else (now - t) * 1e3 > self.stale_after_ms
            )
        return {
            "now_monotonic": now,
            "last_ok_monotonic": {
                str(i): self._last_ok.get(i) for i in range(self.n_workers)
            },
            "stale_after_ms": self.stale_after_ms,
            "stale": stale,
            "backend": self.name,
            "workers": self.n_workers,
            "alive": [h.is_alive() for h in self._procs],
            "generations": list(self._gen),
            "respawns": len(self.respawns),
            "segments_per_worker": {str(i): c for i, c in per_worker.items()},
            "supervised": self.self_heal,
            "snapshot_mode": self.snapshot_mode if (
                self.shadow_states or self._spill_dir is not None
            ) else None,
            "spill_ms_per_step": (
                round(self._spill_ewma, 4) if self._spill_ewma is not None else None
            ),
            "events": [e.to_dict() for e in self.worker_events[-20:]],
        }

    # -- ExecutionBackend hooks -------------------------------------------------
    def _encode_spec(self, spec: SegmentSpec) -> Dict[str, Any]:
        return {
            "name": spec.name,
            "dag_name": spec.dag_name,
            "task_ids": list(spec.task_ids),
            "parents": {t: list(ps) for t, ps in spec.parents.items()},
            "publish": sorted(spec.publish),
            "batch_of": {t: int(b) for t, b in spec.batch_of.items()},
            "created_at": int(spec.created_at),
            "fused": bool(spec.fused),
        }

    def _deploy_rpc(self, worker: int, spec: SegmentSpec,
                    states: Optional[Dict[str, Any]] = None,
                    step0: int = 0) -> None:
        msg = {
            "op": "deploy",
            "spec": self._encode_spec(spec),
            "tasks": {
                tid: {"type": self.task_defs[tid].type,
                      "config": self.task_defs[tid].config}
                for tid in spec.task_ids
            },
            "states": states,
        }
        if self.snapshot_mode == "spill":
            msg["spill"] = self._spill_file(worker)
            msg["step0"] = int(step0)
        self._call(worker, msg)
        if states is not None:
            self._shadow[spec.name] = states

    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
    ) -> RemoteSegment:
        seg = RemoteSegment(
            spec=spec,
            backend=self,
            cost_of={
                tid: cost_weight_for_task(dataflow.tasks[tid])
                for tid in spec.task_ids
            },
            active={tid: True for tid in spec.task_ids},
        )
        # deploy() records task_defs after _build returns; the RPC needs
        # them now, so register this segment's defs up front
        for tid in spec.task_ids:
            self.task_defs[tid] = dataflow.tasks[tid]
        worker = self._assign_slot(spec)
        self._deploy_rpc(
            worker,
            spec,
            states=(
                {tid: encode_pytree(v) for tid, v in init_states.items()}
                if init_states
                else None
            ),
        )
        return seg

    def _drop_streams(self, seg: RemoteSegment) -> None:
        """Kill the remote segment — the worker drops its topics on the
        shared transport (waking any in-flight synced fetches)."""
        worker = self.device_of.get(seg.spec.name)
        if worker is not None:
            self._call(worker, {"op": "kill", "segment": seg.spec.name})
        self._shadow.pop(seg.spec.name, None)
        # no spill cleanup: the worker prunes the segment's entry from its
        # combined file on the next write, and a lingering entry is inert
        # (recovery only consults segments still assigned to the worker)

    def _begin_concurrent_step(self) -> None:
        # same per-topic sequencing scheme as the in-process torch backend:
        # each forwarding task publishes exactly once per step, so this
        # step's boundary reads must observe seq+1 on their producer.
        # One sequences() snapshot instead of a seq() call per topic —
        # on the tcp transport each seq() is a socket round-trip.
        seqs = self.transport.sequences()
        self._topic_target = {
            topic_for(tid): seqs.get(topic_for(tid), 0) + 1
            for name, tids in self.forwarding.items()
            if name in self.segments
            for tid in tids
        }

    def _end_concurrent_step(self) -> None:
        self._topic_target = None

    def _step_entry(self, seg: RemoteSegment) -> Dict[str, Any]:
        targets = None
        if self._topic_target is not None:
            targets = {
                t: s for t, s in self._topic_target.items()
                if t in self._boundary_topics(seg)
            }
        return {
            "segment": seg.spec.name,
            "forward": sorted(self.forwarding[seg.spec.name]),
            "targets": targets,
        }

    def _snap_now(self) -> bool:
        return self.shadow_states and self.step_count % max(self.snapshot_every, 1) == 0

    def _harvest_snaps(self, reply: Dict[str, Any]) -> None:
        for name, states in (reply.get("states") or {}).items():
            self._shadow[name] = states
        if "spill_ms" in reply:
            # worker-measured durability cost of this batch's spill writes —
            # EWMA'd so worker_health can report supervision overhead live
            prev = self._spill_ewma
            val = float(reply["spill_ms"])
            self._spill_ewma = val if prev is None else 0.8 * prev + 0.2 * val

    def _consume_skip(self, seg: RemoteSegment) -> bool:
        """Recovery determined this step already completed inside the dead
        worker (outputs published, spill written): count it done."""
        if seg._skip_steps <= 0:
            return False
        seg._skip_steps -= 1
        seg.steps_run += 1
        seg._states_cache = None
        return True

    def step(self) -> StepReport:
        report = super().step()
        if self.first_step_s is None and self._spawned_at is not None:
            self.first_step_s = time.perf_counter() - self._spawned_at
        return report

    def _step_one(self, seg: RemoteSegment) -> Optional[float]:
        if self._consume_skip(seg):
            return 0.0
        # bounded retry: a fatal worker failure mid-step triggers in-place
        # recovery (redeploy from spill/shadow snapshots) and ONE
        # re-dispatch per attempt — deterministic re-steps keep sink
        # counts exact
        for attempt in range(3):
            try:
                reply = self._call(
                    self.device_of[seg.spec.name],
                    {"op": "step", "snap": self._snap_now(),
                     **self._step_entry(seg)},
                )
                break
            except WorkerError as e:
                if attempt == 2 or not self._step_recover(seg.spec.name, e):
                    raise
        self._harvest_snaps(reply)
        seg.steps_run += 1
        seg._states_cache = None
        return float(reply["ms"])  # worker-measured compute, not RPC wait

    def _step_wave_on_worker(
        self, worker: int, names: List[str], op: str = "step_many"
    ) -> Dict[str, float]:
        seg_ms: Dict[str, float] = {}
        todo: List[str] = []
        for n in names:
            if self._consume_skip(self.segments[n]):
                seg_ms[n] = 0.0
            else:
                todo.append(n)
        if not todo:
            return seg_ms
        entries = [self._step_entry(self.segments[n]) for n in todo]
        reply = self._call(
            worker,
            {"op": op, "segments": entries, "snap": self._snap_now()},
        )
        self._harvest_snaps(reply)
        for n in todo:
            seg = self.segments[n]
            seg.steps_run += 1
            seg._states_cache = None
        seg_ms.update({n: float(ms) for n, ms in reply["ms"].items()})
        return seg_ms

    def _use_chains(self) -> bool:
        # step_chain replies arrive once a worker's WHOLE chain is done, so
        # a per-wave-calibrated hang bound would misfire — fall back to
        # per-wave step_many while the supervisor's rpc_timeout is armed.
        return self.chain_batching and self.rpc_timeout is None

    def _worker_chains(self) -> Dict[int, List[str]]:
        """Each step's waves flattened into one per-worker chain, in global
        wave order (see :func:`~repro_torch.runtime.scheduler.compute_chains`)."""
        from .scheduler import compute_chains

        order = {n: s.spec.created_at for n, s in self.segments.items()}
        chains, _ = compute_chains(self.seg_deps, dict(self.device_of), order=order)
        return chains

    def _dispatch_chunks(
        self, by_worker: Dict[int, List[str]], op: str
    ) -> Dict[str, float]:
        """Dispatch one command per worker concurrently, with in-place
        recovery: a dead worker fails its whole chunk at once; with
        self-healing on, recover it and re-dispatch that chunk — the rest
        of the step keeps running meanwhile (deterministic re-steps and
        the spill skip counters keep sink counts exactly-once)."""
        from concurrent.futures import FIRST_COMPLETED, wait

        seg_ms: Dict[str, float] = {}
        futures = {
            self._pool.submit(self._step_wave_on_worker, w, names, op):
            (w, names, 0)
            for w, names in sorted(by_worker.items())
        }
        while futures:
            done, _ = wait(futures, return_when=FIRST_COMPLETED)
            for fut in done:
                w, names, tries = futures.pop(fut)
                try:
                    seg_ms.update(fut.result())
                except WorkerError as e:
                    if tries >= 2 or not self._step_recover(names[0], e):
                        raise
                    futures[self._pool.submit(
                        self._step_wave_on_worker, w, names, op
                    )] = (w, names, tries + 1)
        return seg_ms

    def _step_segments(self) -> Dict[str, float]:
        """Sync-mode stepping, chain-batched when enabled.

        PR 8 left ``step_chain`` concurrent-only; sync mode paid one
        blocking RPC per segment. With ``chain_batching`` on (and no
        ``rpc_timeout`` armed) sync mode now dispatches the same
        one-``step_chain``-per-worker commands, guarded by the same
        per-topic sequence targets — so sink digests are identical to the
        per-segment launch-order sweep. The per-worker chunks must be
        dispatched concurrently even in sync mode: an early entry of one
        worker's chain may wait on another worker's publish, so a serial
        worker-by-worker dispatch could deadlock on the sequence targets.
        Sync semantics are unchanged — the caller still sums (not maxes)
        the per-wave times, and this returns worker-measured compute ms
        per segment exactly like the base sweep.
        """
        if not self._use_chains() or not self.segments:
            return super()._step_segments()
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.max_workers, thread_name_prefix="repro-step"
            )
        self._begin_concurrent_step()
        try:
            return self._dispatch_chunks(self._worker_chains(), "step_chain")
        finally:
            self._end_concurrent_step()

    def compile_cache_stats(self) -> Dict[str, int]:
        """Aggregate the workers' process-local compiled-segment caches."""
        total = {"hits": 0, "misses": 0, "evictions": 0, "entries": 0}
        if not self._spawned:
            return total
        for w in range(self.n_workers):
            if not self.worker_alive(w):
                continue
            stats = self._call(w, {"op": "cache_stats"}).get("stats", {})
            for k in total:
                total[k] += int(stats.get(k, 0))
        return total

    # -- telemetry plane ----------------------------------------------------------
    def configure_obs(
        self,
        metrics: Optional[bool] = None,
        trace: Optional[bool] = None,
        sample_stride: Optional[int] = None,
        trace_capacity: Optional[int] = None,
    ) -> "MultiprocBackend":
        super().configure_obs(metrics=metrics, trace=trace,
                              sample_stride=sample_stride,
                              trace_capacity=trace_capacity)
        if trace is not None or sample_stride is not None or trace_capacity is not None:
            # remember the config so every future (re)spawn replays it,
            # then push it to the workers already running
            self._obs_msg = {"op": "obs", "trace": trace,
                             "sample_stride": sample_stride,
                             "capacity": trace_capacity}
            if self._spawned:
                for w in range(self.n_workers):
                    if self.worker_alive(w):
                        self._push_obs(w)
        return self

    def _harvest_worker_obs(self) -> List[Dict[str, Any]]:
        """Pull every live worker's registry snapshot over the ``metrics``
        RPC (same aggregation pattern as :meth:`compile_cache_stats`).
        Worker spans ride the same reply; since the worker-side drain is
        destructive they are buffered here until :meth:`drain_spans`."""
        snaps: List[Dict[str, Any]] = []
        if not self._spawned:
            return snaps
        for w in range(self.n_workers):
            if not self.worker_alive(w):
                continue
            try:
                reply = self._call(w, {"op": "metrics"})
            except WorkerError:
                continue  # a dying worker must never fail a scrape
            if reply.get("metrics"):
                snaps.append(reply["metrics"])
            self._worker_spans.extend(reply.get("spans") or ())
            if reply.get("device"):
                self._worker_device[w] = reply["device"]
        return snaps

    def launch_counts(self) -> Dict[str, int]:
        """The port's kernel launches summed over the live workers (each
        process counts its own since it started, graph replays included)."""
        total: Dict[str, int] = {}
        if not self._spawned:
            return total
        for w in range(self.n_workers):
            if not self.worker_alive(w):
                continue
            reply = self._call(w, {"op": "metrics"})
            self._worker_spans.extend(reply.get("spans") or ())
            if reply.get("device"):
                self._worker_device[w] = reply["device"]
            for name, n in (reply.get("launches") or {}).items():
                total[name] = total.get(name, 0) + int(n)
        return total

    def worker_memory(self) -> Dict[int, Dict[str, Any]]:
        """Per worker on the card: the device's total and free bytes as the
        worker started and after its first step, its caching allocator's
        reserved and peak reserved bytes, and its CUDA graphs and their
        pool bytes. Empty on the CPU."""
        self._harvest_worker_obs()
        return {w: dict(d) for w, d in sorted(self._worker_device.items())}

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Coordinator registry merged with the workers' process-local
        registries (counters/histograms add; worker families are
        ``repro_worker_segment_*`` so nothing double-counts)."""
        return merge_snapshots(
            [self.metrics.snapshot(), *self._harvest_worker_obs()]
        )

    def drain_spans(self) -> List[Dict[str, Any]]:
        self._harvest_worker_obs()
        out, self._worker_spans = self._worker_spans, []
        out.extend(self.tracer.drain())
        out.sort(key=lambda s: s.get("ts", 0))
        return out

    def _step_segments_concurrent(self) -> Dict[str, float]:
        """Wave- or chain-batched concurrent dispatch.

        The generic ready-queue issues one RPC per segment; across a pipe
        that round-trip is the dominant cost for small segments. Each
        dependency wave becomes ONE ``step_many`` command per worker
        (segments within a wave are mutually independent, so the worker
        may step its share back-to-back), dispatched to all workers
        concurrently from the thread pool — workers overlap, coordinator
        overhead is waves × workers round-trips per step instead of one
        per segment. Cross-worker boundary reads stay guarded by the
        per-topic sequence targets exactly as in per-segment dispatch.

        With ``chain_batching`` on (and no rpc_timeout armed) the waves
        are flattened further into one ``step_chain`` command per worker
        per STEP: the worker steps its segments in global wave order and
        resolves intra-chain boundary streams locally, so a deep
        same-worker chain pays one round-trip total and zero transport
        hops between its own segments.
        """
        if not self.segments:
            return {}
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.max_workers, thread_name_prefix="repro-step"
            )
        self._begin_concurrent_step()
        try:
            if self._use_chains():
                return self._dispatch_chunks(self._worker_chains(), "step_chain")
            seg_ms: Dict[str, float] = {}
            for wave in self.segment_waves():
                by_worker: Dict[int, List[str]] = {}
                for name in wave:
                    by_worker.setdefault(self.device_of[name], []).append(name)
                seg_ms.update(self._dispatch_chunks(by_worker, "step_many"))
            return seg_ms
        finally:
            self._end_concurrent_step()

    @staticmethod
    def _boundary_topics(seg: RemoteSegment) -> Set[str]:
        in_segment = set(seg.spec.task_ids)
        return {
            topic_for(p)
            for tid in seg.spec.task_ids
            for p in seg.spec.parents.get(tid, ())
            if p not in in_segment
        }

    # -- durability hooks ---------------------------------------------------------
    def _dump_extra(self) -> Dict[str, Any]:
        counters = self.transport.counters()
        return {
            "worker_of": {name: int(i) for name, i in self.device_of.items()},
            "n_workers": self.n_workers,
            "broker_bytes_published": int(counters["bytes_published"]),
            "broker_publishes": int(counters["publishes"]),
        }

    def _restore_extra(self, extra: Dict[str, Any]) -> None:
        self.device_of_at_checkpoint = {
            name: int(i) for name, i in extra.get("worker_of", {}).items()
        }
        if extra.get("n_workers") is not None:
            self._n_slots_at_checkpoint = int(extra["n_workers"])
        self.transport.restore_counters(
            int(extra.get("broker_bytes_published", 0)),
            int(extra.get("broker_publishes", 0)),
        )

    def spawn_config(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {
            "workers": self.n_workers,
            "transport": self.transport.name,
            "worker_plane": self.worker_plane,
        }
        if getattr(self.policy, "name", ""):
            cfg["placement"] = self.policy.name
        if getattr(self.launcher, "name", "local") != "local":
            cfg["launcher"] = self.launcher.name
        return cfg

    # -- lifecycle ---------------------------------------------------------------
    def close(self) -> None:
        """Shut down the dispatch pool, the worker pool and the transport.

        Unlike the single-process backends this releases the deployed
        segments' host processes — a closed multiproc backend is done
        stepping (restore from a checkpoint to resume)."""
        super().close()
        if self._spawned:
            for i, handle in enumerate(self._procs):
                try:
                    with self._conn_locks[i]:
                        handle.conn.send({"op": "shutdown"})
                        handle.conn.recv()
                except (EOFError, BrokenPipeError, OSError):
                    pass
                handle.close()
            for handle in self._procs:
                handle.join(timeout=10)
                if handle.is_alive():  # pragma: no cover - stuck worker
                    handle.terminate()
                    handle.join(timeout=5)
            self._procs.clear()
            self._conn_locks.clear()
            self._gen.clear()
            self._spawned = False
        if self._spill_dir is not None:
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            self._spill_dir = None
        self.transport.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
