"""Pub-sub broker — the Enterprise-Service-Bus analogue of paper §4.3.

Storm topologies are immutable once launched; the paper therefore deploys a
merged dataflow as partial DAGs (segments) glued by broker topics. Here a
topic holds the latest event batch (a torch tensor, on the card when the
system runs there) published by an upstream task's segment; downstream
segments fetch it at the start of their step. Duplicate semantics
(fan-out) are free: every subscriber reads the same tensor, and operators
never write into their inputs.

The port's copy of the in-process broker of ``repro.runtime.broker``.
Every topic carries its own lock, **sequence number** (count of publishes
since creation) and condition variable, so boundary reads synchronize only
on their producers — never on a broker-wide barrier. This is what lets
concurrent stepping dispatch independent segments from different threads:

  * ``publish``/``fetch`` are thread-safe per topic;
  * ``fetch_synced(topic, min_seq)`` blocks until that topic's sequence
    reaches ``min_seq`` — the per-topic ordering guarantee the wave
    scheduler relies on for deterministic sink counts (each forwarding
    task publishes exactly once per step, so "producer stepped" ≡
    "sequence advanced by one");
  * ``drop`` is safe under in-flight dispatch: a dropped topic wakes any
    blocked ``fetch_synced`` with a ``KeyError`` instead of deadlocking.

The broker counts published bytes — the indirection overhead the paper
observes, which fusion removes — and fetches, which the telemetry plane
mirrors as ``repro_transport_fetches_total``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class TransportError(RuntimeError):
    """Base of every boundary-stream failure (broker or transport)."""


class TopicDropped(TransportError, KeyError):
    """The topic carries no data: never published, or dropped mid-wait.

    Subclasses ``KeyError`` so handlers written against the plain broker
    (``except KeyError``) keep working, and ``TransportError`` so a caller
    can classify any transport stall with one ``except TransportError``."""

    def __str__(self) -> str:
        return RuntimeError.__str__(self)


class TransportTimeout(TransportError, TimeoutError):
    """A bounded wait (``fetch_synced``) expired before its condition."""


def topic_for(task_id: str) -> str:
    """The derived-stream topic of a running task (paper: unique data topic)."""
    return f"stream/{task_id}"


class _Topic:
    """Per-topic state: latest buffer, publish sequence, waiter wake-up."""

    __slots__ = ("lock", "cond", "buffer", "seq", "dropped", "waiters")

    def __init__(self) -> None:
        # publish and fetch hold the plain lock; only a waiting fetch_synced
        # goes through the condition, which shares it
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.buffer: Any = None
        self.seq = 0  # publishes on this topic since creation
        self.dropped = False
        self.waiters = 0  # fetch_synced calls blocked on cond


class Broker:
    def __init__(self) -> None:
        self._topics: Dict[str, _Topic] = {}
        # Guards the topic registry and the counters; never held while
        # waiting — waits happen on the per-topic condition.
        self._lock = threading.Lock()
        self.bytes_published: int = 0
        self.publishes: int = 0
        # fetch-side twin of the publish counters; observability only
        # (never persisted)
        self.fetch_count: int = 0

    def _state(self, topic: str, create: bool = False) -> Optional[_Topic]:
        with self._lock:
            st = self._topics.get(topic)
            if st is None and create:
                st = self._topics[topic] = _Topic()
            return st

    def publish(self, topic: str, batch: Any) -> None:
        nbytes = batch.nbytes  # a torch tensor, or a numpy array behind a tcp broker
        with self._lock:
            st = self._topics.get(topic)
            if st is None:
                st = self._topics[topic] = _Topic()
            self.bytes_published += nbytes
            self.publishes += 1
        with st.lock:
            st.buffer = batch
            st.dropped = False
            st.seq += 1
            if st.waiters:  # a sync step never waits: it skips the wake-up
                st.cond.notify_all()

    def fetch(self, topic: str, copy: bool = False) -> Any:
        """The topic's latest batch, by reference (zero-copy fan-out);
        ``copy=True`` returns a private clone for callers that mutate."""
        with self._lock:
            self.fetch_count += 1
            st = self._topics.get(topic)
        if st is None:
            raise TopicDropped(f"no data published on topic {topic!r}")
        with st.lock:
            if st.buffer is None:
                raise TopicDropped(f"no data published on topic {topic!r}")
            return _private(st.buffer) if copy else st.buffer

    def fetch_synced(
        self, topic: str, min_seq: int, timeout: float = 60.0, copy: bool = False
    ) -> Any:
        """Fetch once the topic's sequence reaches ``min_seq``.

        The per-producer synchronization point of concurrent stepping: the
        consumer waits for *its* producer's publish of this step, not for a
        global barrier. Dropping the topic while a fetch is in flight wakes
        the waiter with a ``KeyError`` (kill/unmerge stay safe mid-step);
        the timeout guards against scheduler bugs turning into hangs.
        """
        self._count_fetch()
        st = self._state(topic, create=True)
        with st.cond:
            st.waiters += 1
            try:
                ok = st.cond.wait_for(lambda: st.dropped or st.seq >= min_seq, timeout)
            finally:
                st.waiters -= 1
            if st.dropped or st.buffer is None:
                raise TopicDropped(f"topic {topic!r} dropped while awaited")
            if not ok:  # pragma: no cover - defensive
                raise TransportTimeout(
                    f"topic {topic!r} never reached sequence {min_seq} "
                    f"(at {st.seq}) within {timeout}s"
                )
            return _private(st.buffer) if copy else st.buffer

    def _count_fetch(self) -> None:
        with self._lock:
            self.fetch_count += 1

    def seq(self, topic: str) -> int:
        """Publish count of ``topic`` (0 if it never existed)."""
        st = self._state(topic)
        return 0 if st is None else st.seq

    def sequences(self) -> Dict[str, int]:
        """Snapshot of every live topic's sequence number."""
        with self._lock:
            items = list(self._topics.items())
        return {t: st.seq for t, st in items if st.buffer is not None}

    def has(self, topic: str) -> bool:
        st = self._state(topic)
        return st is not None and st.buffer is not None

    def topics(self) -> Dict[str, Any]:
        """Snapshot view of the live topic buffers (checkpointing)."""
        with self._lock:
            items = list(self._topics.items())
        return {t: st.buffer for t, st in items if st.buffer is not None}

    def drop(self, topic: str) -> None:
        with self._lock:
            st = self._topics.pop(topic, None)
        if st is not None:
            with st.cond:
                st.dropped = True
                st.buffer = None
                st.cond.notify_all()

    def counters(self) -> Dict[str, int]:
        """Cumulative ``{"bytes_published", "publishes"}`` across all topics."""
        with self._lock:
            return {"bytes_published": self.bytes_published, "publishes": self.publishes}

    def restore_counters(self, bytes_published: int, publishes: int) -> None:
        """Set the cumulative counters (checkpoint restore)."""
        with self._lock:
            self.bytes_published = int(bytes_published)
            self.publishes = int(publishes)

    def reset_counters(self) -> None:
        with self._lock:
            self.bytes_published = 0
            self.publishes = 0

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for st in self._topics.values() if st.buffer is not None)


def _private(batch: Any) -> Any:
    """A private copy of a batch: ``clone`` for a torch tensor, ``copy`` for
    a numpy array."""
    return batch.clone() if hasattr(batch, "clone") else batch.copy()
