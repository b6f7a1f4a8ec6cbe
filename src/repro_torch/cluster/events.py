"""Worker-health events emitted by the cluster plane.

Every observable lifecycle transition in the supervised worker pool —
a missed heartbeat, a respawn, a segment redeploy, a pool resize — is
recorded as a :class:`WorkerEvent`. The multiproc backend keeps a bounded
ring of recent events (``backend.worker_events``) and forwards each one
to the user hook installed via ``StreamSystem(on_worker_event=...)``;
the serving front end surfaces the tail through ``status()``/``stats()``.

Kept dependency-free so the coordinator, the supervisor thread and the
serve layer can all import it without touching torch or the worker plane.
The port's copy of ``repro.cluster.events``; kinds and fields unchanged.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

# -- event kinds -----------------------------------------------------------------
HEARTBEAT_MISSED = "heartbeat-missed"  # liveness probe failed / process gone
WORKER_DEAD = "worker-dead"            # crash detected (pipe EOF or probe)
WORKER_HUNG = "worker-hung"            # RPC exceeded the hang timeout
WORKER_RESPAWNED = "worker-respawned"  # fresh process launched in its slot
SEGMENT_REDEPLOYED = "segment-redeployed"  # segment rebuilt from snapshot
POOL_GROWN = "pool-grown"              # resize_pool added workers
POOL_SHRUNK = "pool-shrunk"            # resize_pool retired workers
SCALE_UP = "scale-up"                  # autoscaler decided to grow
SCALE_DOWN = "scale-down"              # autoscaler decided to shrink

EVENT_KINDS = (
    HEARTBEAT_MISSED,
    WORKER_DEAD,
    WORKER_HUNG,
    WORKER_RESPAWNED,
    SEGMENT_REDEPLOYED,
    POOL_GROWN,
    POOL_SHRUNK,
    SCALE_UP,
    SCALE_DOWN,
)


@dataclass(frozen=True)
class WorkerEvent:
    """One cluster-plane health event.

    ``step`` is the coordinator's step counter when the event fired,
    ``worker`` the pool slot it concerns (``None`` for pool-wide events),
    ``ms`` how long the transition took where that is meaningful
    (recovery latency, resize latency)."""

    kind: str
    worker: Optional[int] = None
    step: int = 0
    detail: str = ""
    ms: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)
