"""A segment's step captured as CUDA graphs, with its states updated in place.

The reference compiles each segment's step into one XLA executable and
donates the pre-step states to it (``repro.runtime.segment``). The port's
counterpart on the card is a CUDA graph of the segment's step: one host
call launches every kernel of the step, where the eager step pays a host
launch for each of them.

A graph bakes in the addresses it reads and writes, so a
:class:`CapturedStep` belongs to one segment and owns that segment's
buffers:

  * the static input buffers, one per boundary topic, into which each step
    copies the batches fetched from the broker;
  * the static state buffers, which are ``seg.states``: inside the graph
    the step's new states are copied into them, so states are updated in
    place (the reference's donation). The copy also undoes the aliasing of
    the eager step: a paused task's state is its old state, and a sink's
    ``last`` is its input batch, another segment's buffer;
  * one ``torch.cuda.CUDAGraph`` per pattern of the ``active`` flags, each
    with its own private memory pool and its output tensors, so that a
    pause or resume picks or captures another graph and never replays
    stale flags.

A segment's first step runs eagerly: it builds and loads the kernels and
lazily created library state outside any capture, as the reference's first
call traces. From then on each pattern of flags is captured the first time
it steps and replayed after; a task that turns live without having run
eagerly in this segment gets one more eager step first. Warm-up and
capture run on the backend's capture stream, the replays on the current
stream: under concurrent stepping on the card, the stream the backend
issues the segment on (``TorchBackend._issue_waves``). Every warm-up,
capture and replay is issued from the stepping thread, so the capture
stream needs no lock, and ``pool_bytes``, the growth of
``memory_reserved`` during a capture, is the capture's own: no other
thread allocates on the card meanwhile (the background checkpoint writer
copies to the host only). A capture that fails raises
:class:`CaptureError` naming the segment and the task; nothing falls
back to the eager step.

Captures use ``capture_error_mode="thread_local"``: the background
checkpoint writer copies states to the host from another thread, which a
capture in progress must not fail.

Python's cyclic garbage collector is held off while a capture runs
(:func:`collector_held`). A ``torch.cuda.CUDAGraph`` left in a reference
cycle (a dropped system's segments hold theirs in one) is destroyed when
the collector gets to it, and its destructor's CUDA calls, made inside
another graph's capture, invalidate that capture: its next launch fails
with "operation failed due to a previous error during capture", in
whichever task it happens to be. The collector runs again after the
capture, outside it.

Each graph gets a cuBLAS workspace of its own. PyTorch keeps one
workspace per (cuBLAS handle, stream) and allocates it at the first
product issued on that pair, so every graph captured on the capture
stream would otherwise reuse one buffer, and two such graphs replayed at
once on two streams would race on it wherever cuBLAS reduces through its
workspace (split-K). A capture therefore drops PyTorch's workspaces
before it begins, so the first product inside it allocates a new one from
the graph's private pool, and again after it ends, so that no later
warm-up or capture issues into the buffer the graph holds.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.kernels import build


class CaptureError(RuntimeError):
    """Capturing a segment's step into a CUDA graph failed."""


@dataclass
class CaptureStats:
    """Cumulative counters of one backend's captured steps."""

    graphs: int = 0  # graphs captured
    capture_ms: List[float] = field(default_factory=list)  # host ms of each capture
    pool_bytes: int = 0  # bytes the captured graphs' private pools reserved
    replays: int = 0  # graph launches
    input_copies: int = 0  # boundary batches copied into static inputs
    eager_steps: int = 0  # warm-up steps


@dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph
    outputs: Dict[str, torch.Tensor]  # the step's output batches, rewritten by each replay
    launches: Dict[str, int]  # the port's kernel launches recorded in the capture
    pool_bytes: int  # bytes its private pool reserved during the capture


class CapturedStep:
    """One segment's step on the card: static buffers and CUDA graphs."""

    def __init__(self, stream: torch.cuda.Stream, stats: CaptureStats):
        self.stream = stream
        self.stats = stats
        self.inputs: Optional[Dict[str, torch.Tensor]] = None
        self.graphs: Dict[Tuple[bool, ...], _Graph] = {}
        self.warm: Set[str] = set()  # tasks that stepped eagerly while live

    def step(self, seg: Any, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Advance ``seg`` one step on the current stream; returns its
        output batches."""
        self._load(seg, inputs)
        key = tuple(seg.active[t] for t in seg.spec.task_ids)
        live = {t for t, on in zip(seg.spec.task_ids, key) if on}
        if not live and all(op.is_sink for op in seg.operators.values()):
            return {}  # paused sinks only: the step runs nothing (an empty graph)
        if not live <= self.warm:
            return self._eager(seg, live, commit=True)
        graph = self.graphs.get(key) or self._capture(seg, key)
        graph.graph.replay()
        build.add_launches(graph.launches)
        self.stats.replays += 1
        return graph.outputs

    def release(self) -> None:
        """Free the graphs and their pools (the segment was killed)."""
        for graph in self.graphs.values():
            graph.graph.reset()
        self.graphs.clear()
        self.inputs = None

    def memory(self, seg: Any, inputs: Dict[str, torch.Tensor]) -> Dict[str, int]:
        """Bytes of the graph of the current flags (captured here if it is
        not yet, after an uncommitted warm-up if one is due): the static
        arguments, the outputs, the pool beyond them, and the state bytes
        written in place. The states keep their values."""
        self._load(seg, inputs)
        key = tuple(seg.active[t] for t in seg.spec.task_ids)
        live = {t for t, on in zip(seg.spec.task_ids, key) if on}
        if not live <= self.warm:
            self._eager(seg, live, commit=False)
        graph = self.graphs.get(key) or self._capture(seg, key)
        state_bytes = _nbytes(seg.states)
        out_bytes = sum(t.nbytes for t in {t.data_ptr(): t for t in graph.outputs.values()}.values())
        return {
            "argument_size_in_bytes": state_bytes + _nbytes(self.inputs),
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": max(0, graph.pool_bytes - out_bytes),
            "alias_size_in_bytes": state_bytes,
        }

    # -- internals --------------------------------------------------------------
    def _load(self, seg: Any, inputs: Dict[str, torch.Tensor]) -> None:
        """Copy the boundary batches into the static inputs; on the first
        call, make the static buffers: the segment's own copies of its
        states and inputs. The caller keeps the states they replace until
        the current stream is done with them."""
        if self.inputs is None:
            seg.states = map_leaves(lambda t: t.clone(), seg.states)
            self.inputs = {topic: x.clone() for topic, x in inputs.items()}
        else:
            for topic, x in inputs.items():
                buf = self.inputs[topic]
                if buf.shape != x.shape or buf.dtype != x.dtype:
                    raise ValueError(
                        f"segment {seg.name!r}: topic {topic!r} carries {tuple(x.shape)} "
                        f"{x.dtype}, its captured step takes {tuple(buf.shape)} {buf.dtype}"
                    )
                buf.copy_(x)
        self.stats.input_copies += len(inputs)

    def _eager(self, seg: Any, live: Set[str], commit: bool) -> Dict[str, torch.Tensor]:
        """The warm-up: one eager step on the capture stream, its new states
        copied into the static buffers when ``commit``."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            new_states, outputs = seg.step_fn(seg.states, seg.active, self.inputs)
            if commit:
                _commit(seg.states, new_states)
        current.wait_stream(self.stream)
        self.warm |= live
        self.stats.eager_steps += 1
        return outputs

    def _capture(self, seg: Any, key: Tuple[bool, ...]) -> _Graph:
        device = self.stream.device
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        _fresh_blas_workspaces(self.stream)
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(device)
        failure: Optional[BaseException] = None
        t0 = time.perf_counter()
        with collector_held(), build.recording_launches() as launches, \
                torch.cuda.stream(self.stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                new_states, outputs = seg.step_fn(seg.states, seg.active, self.inputs)
                _commit(seg.states, new_states)
            except Exception as err:  # the capture is ended below, then reported
                failure = err
            try:
                graph.capture_end()
            except RuntimeError as err:
                failure = failure or err
        _fresh_blas_workspaces(self.stream)
        if failure is not None:
            raise CaptureError(_describe(seg, failure)) from failure
        ms = (time.perf_counter() - t0) * 1e3
        current.wait_stream(self.stream)
        captured = _Graph(graph, outputs, dict(launches),
                          torch.cuda.memory_reserved(device) - reserved)
        self.graphs[key] = captured
        self.stats.graphs += 1
        self.stats.capture_ms.append(ms)
        self.stats.pool_bytes += captured.pool_bytes
        return captured


_held_lock = threading.Lock()
_held = [0, False]  # holds open, and whether the collector was on before the first


@contextlib.contextmanager
def collector_held():
    """Python's cyclic garbage collector off inside the block, so that no
    CUDA graph it frees is destroyed inside a capture (see the module's
    notes). Holds nest and may overlap across threads: the collector is
    turned back on when the last one ends, if it was on when the first
    began. An explicit ``gc.collect()`` still runs."""
    with _held_lock:
        if _held[0] == 0:
            _held[1] = gc.isenabled()
            gc.disable()
        _held[0] += 1
    try:
        yield
    finally:
        with _held_lock:
            _held[0] -= 1
            if _held[0] == 0 and _held[1]:
                gc.enable()


def _fresh_blas_workspaces(stream: torch.cuda.Stream) -> None:
    """Make this thread's cuBLAS handle outside any capture (a capture
    forbids creating it), then drop every cuBLAS workspace PyTorch holds:
    the next product on a (handle, stream) pair allocates a new one, inside
    a capture from that graph's private pool. A dropped workspace goes back
    to the pool of the stream or graph that allocated it, which only that
    stream's or graph's later allocations reuse."""
    with torch.cuda.stream(stream):
        torch.cuda.current_blas_handle()
    torch._C._cuda_clearCublasWorkspaces()


def _describe(seg: Any, err: BaseException) -> str:
    index = getattr(err, "task_index", None)
    if index is None:
        where = "when the capture ended"
    else:
        tid = seg.spec.task_ids[index]
        where = f"in task {tid!r} (operator {seg.operators[tid].type!r})"
    return f"capturing the step of segment {seg.name!r} failed {where}: {type(err).__name__}: {err}"


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a state pytree (dicts, tuples, lists)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def _commit(static: Any, new: Any) -> None:
    """Copy a step's new states into the static state buffers, leaf by leaf."""
    if isinstance(static, dict):
        for k, v in static.items():
            _commit(v, new[k])
    elif isinstance(static, (tuple, list)):
        for v, w in zip(static, new):
            _commit(v, w)
    elif static is not new:
        static.copy_(new)


def _nbytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.nbytes
