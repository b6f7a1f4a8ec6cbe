"""Pub-sub broker — the Enterprise-Service-Bus analogue of paper §4.3.

Storm topologies are immutable once launched; the paper therefore deploys a
merged dataflow as partial DAGs (segments) glued by broker topics. Here a
topic holds the latest event batch (a torch tensor, on the card when the
system runs there) published by an upstream task's segment; downstream
segments fetch it at the start of their step. Duplicate semantics
(fan-out) are free: every subscriber reads the same tensor, and operators
never write into their inputs.

The in-process broker of ``repro.runtime.broker``, without the per-topic
sequencing that concurrent stepping needs: the port steps segments one
after another in launch order. The broker counts published bytes — the
indirection overhead the paper observes, which fusion removes.
"""
from __future__ import annotations

import threading
from typing import Any, Dict


class TopicDropped(KeyError):
    """The topic carries no data: never published, or dropped."""

    def __str__(self) -> str:
        return RuntimeError.__str__(self)


def topic_for(task_id: str) -> str:
    """The derived-stream topic of a running task (paper: unique data topic)."""
    return f"stream/{task_id}"


class Broker:
    def __init__(self) -> None:
        self._topics: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.bytes_published: int = 0
        self.publishes: int = 0

    def publish(self, topic: str, batch: Any) -> None:
        with self._lock:
            self._topics[topic] = batch
            self.bytes_published += batch.numel() * batch.element_size()
            self.publishes += 1

    def fetch(self, topic: str, copy: bool = False) -> Any:
        """The topic's latest batch, by reference (zero-copy fan-out);
        ``copy=True`` returns a private clone for callers that mutate."""
        with self._lock:
            batch = self._topics.get(topic)
        if batch is None:
            raise TopicDropped(f"no data published on topic {topic!r}")
        return batch.clone() if copy else batch

    def drop(self, topic: str) -> None:
        with self._lock:
            self._topics.pop(topic, None)

    def topics(self) -> Dict[str, Any]:
        """Snapshot view of the live topic buffers (checkpointing)."""
        with self._lock:
            return dict(self._topics)

    def counters(self) -> Dict[str, int]:
        """Cumulative ``{"bytes_published", "publishes"}`` across all topics."""
        with self._lock:
            return {"bytes_published": self.bytes_published, "publishes": self.publishes}

    def restore_counters(self, bytes_published: int, publishes: int) -> None:
        """Set the cumulative counters (checkpoint restore)."""
        with self._lock:
            self.bytes_published = int(bytes_published)
            self.publishes = int(publishes)
