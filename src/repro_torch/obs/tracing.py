"""Lightweight step-span tracing with a Chrome trace-event exporter.

A :class:`Tracer` records complete spans (``ph: "X"``) into a bounded
ring buffer. Design constraints, in order:

  1. **Cheap when off** — ``tracer.enabled`` is a plain attribute; hot
     paths guard with ``if tracer.enabled:`` so a disabled tracer costs
     one attribute load per site.
  2. **Monotonic clock** — timestamps are ``time.monotonic_ns()//1000``
     (µs). The monotonic clock is per-*boot*, not per-process, so spans
     recorded in multiproc worker processes line up with coordinator
     spans on the same host without any clock handshake — which is what
     makes the merged Chrome trace show real cross-worker overlap.
  3. **Bounded** — the ring buffer (``capacity`` spans) drops oldest;
     ``sample_stride=N`` records every Nth span per span name, the knob
     that keeps per-segment tracing affordable at high step rates.

Span dicts are already Chrome trace-event shaped (``name``/``cat``/
``ph``/``ts``/``dur``/``pid``/``tid``/``args``), so export is just
wrapping them in ``{"traceEvents": [...]}`` — load the file in
``chrome://tracing`` or https://ui.perfetto.dev. They are also plain
JSON, so workers ship them to the coordinator on the ``metrics`` RPC
unchanged. JAX-free, stdlib only.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Tracer",
    "chrome_trace_json",
    "process_tracer",
    "write_chrome_trace",
]

# Span categories used across the runtime (the README table's source):
#   step        whole-step + wave structure        (backend.step)
#   segment     per-segment step execution         (_step_named / workers)
#   transport   input fetch / output publish       (executor)
#   rpc         coordinator→worker command RPCs    (multiproc _call)
#   compile     compile-cache miss trace+jit       (compile_cache)
#   control     submit / remove / preview / fuse   (manager, system)
#   checkpoint  encode / fsync / save              (checkpoint store)


class Tracer:
    def __init__(
        self,
        enabled: bool = False,
        capacity: int = 65536,
        sample_stride: int = 1,
    ):
        self.enabled = bool(enabled)
        self.sample_stride = max(int(sample_stride), 1)
        self._buf: deque = deque(maxlen=max(int(capacity), 1))
        self._seen: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- configuration ------------------------------------------------------------
    def configure(
        self,
        enabled: Optional[bool] = None,
        sample_stride: Optional[int] = None,
        capacity: Optional[int] = None,
    ) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if sample_stride is not None:
                self.sample_stride = max(int(sample_stride), 1)
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = deque(self._buf, maxlen=max(int(capacity), 1))

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def _admit(self, name: str) -> bool:
        """Per-name stride sampling: True for every Nth span of ``name``."""
        if self.sample_stride <= 1:
            return True
        with self._lock:
            n = self._seen.get(name, 0)
            self._seen[name] = n + 1
        return n % self.sample_stride == 0

    # -- recording ----------------------------------------------------------------
    @contextmanager
    def span(self, name: str, cat: str = "step", **args: Any) -> Iterator[None]:
        """Record one complete span around the with-block. A no-op (beyond
        one branch) when disabled or sampled out; exceptions propagate and
        the span is still recorded with an ``error`` arg."""
        if not self.enabled or not self._admit(name):
            yield
            return
        t0 = time.monotonic_ns()
        try:
            yield
        except BaseException as e:
            args = dict(args, error=type(e).__name__)
            raise
        finally:
            t1 = time.monotonic_ns()
            self._buf.append(
                {
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": t0 // 1000,
                    "dur": max((t1 - t0) // 1000, 1),
                    "pid": self._pid,
                    "tid": threading.get_ident() & 0xFFFFFFFF,
                    "args": args,
                }
            )

    def instant(self, name: str, cat: str = "step", **args: Any) -> None:
        """Record a zero-duration instant event (``ph: "i"``)."""
        if not self.enabled:
            return
        self._buf.append(
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",
                "ts": time.monotonic_ns() // 1000,
                "pid": self._pid,
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "args": args,
            }
        )

    # -- export -------------------------------------------------------------------
    def drain(self) -> List[Dict[str, Any]]:
        """Pop and return all buffered spans (oldest first)."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def spans(self) -> List[Dict[str, Any]]:
        """Peek at buffered spans without draining."""
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


def chrome_trace_json(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Wrap span dicts as a Chrome trace-event file payload. Adds one
    process-name metadata event per pid so Perfetto labels worker rows."""
    events: List[Dict[str, Any]] = []
    for pid in sorted({s["pid"] for s in spans}):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"repro pid {pid}"},
            }
        )
    events.extend(sorted(spans, key=lambda s: s.get("ts", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: List[Dict[str, Any]]) -> str:
    """Write spans as a Chrome/Perfetto-loadable trace file; returns path."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace_json(spans), f)
    return path


# -- per-process singleton --------------------------------------------------------

_process_tracer: Optional[Tracer] = None
_process_lock = threading.Lock()


def process_tracer() -> Tracer:
    """The per-process tracer multiproc *workers* record into (disabled
    until the coordinator's ``trace`` RPC enables it); its spans ride the
    ``metrics`` RPC reply back to the coordinator."""
    global _process_tracer
    with _process_lock:
        if _process_tracer is None:
            _process_tracer = Tracer(enabled=False)
        return _process_tracer
