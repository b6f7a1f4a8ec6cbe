"""Worker supervision: heartbeat-driven crash/hang detection + recovery.

The port's copy of ``repro.cluster.supervisor``, over the port's
:class:`~repro_torch.runtime.worker.MultiprocBackend`, whose workers step
their segments on the card.

The :class:`WorkerSupervisor` arms the multiproc backend's self-healing
machinery and watches the pool from a background thread:

  * **Crash while stepping** — the step RPC fails fast (pipe EOF), the
    backend's ``_step_recover`` hook respawns the worker and the failed
    wave items are re-queued in the dispatch loop; the supervisor merely
    observes the event stream. This is the *fast path*: detection latency
    is one failed RPC, not a heartbeat interval.
  * **Crash while idle** — the heartbeat thread notices the process is
    gone (``is_alive``) and triggers the same recovery, so the next step
    never sees the corpse.
  * **Hang** — ``rpc_timeout`` bounds every reply; an exceeded bound is
    treated as fatal to that incarnation (the pipe is out of sync either
    way) and recovery respawns it. :meth:`check` additionally probes idle
    workers with a bounded ``ping`` — only those that have answered an
    RPC since they were (re)spawned: a worker still importing torch or
    making its CUDA context is slow, not hung, and probing it would
    respawn healthy workers in a loop.

Recovery redeploys segments from the freshest snapshot available
(``snapshot_states``), in one of two modes:

  * **spill** (default for same-host launchers) — each worker pickles
    the post-step states of every segment it owns into one combined
    worker-local file (tmpfs when available), written once per step
    batch *before* the step reply, each entry tagged with a
    completed-step counter. Ephemeral state leaves (keys every step
    overwrites wholesale, e.g. a sink's retained last batch — see
    ``repro_torch.ops.costs.ephemeral_state_keys``) are excluded and re-init
    from the operator template on recovery, so the payload stays a few
    hundred bytes per segment regardless of batch size. No wire traffic,
    no base64: steady-state overhead is one small file write per worker
    per wave, off the coordinator's path. On recovery the counter
    disambiguates a death before the write (state is pre-step: the
    re-dispatch re-steps it, re-publishing idempotently) from one after
    it (the step completed and published: the re-dispatch is skipped) —
    exactly-once either way.
  * **wire** — encoded post-step states piggyback on every step reply,
    committed atomically with it; the only option when workers share no
    filesystem with the coordinator (ssh-shaped launchers). Costs one
    state encode + pipe transfer per step.

Both modes reproduce the uninterrupted trajectory exactly (the
conformance bar in ``tests/test_torch_cluster.py``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .events import HEARTBEAT_MISSED


class WorkerSupervisor:
    """Supervise a :class:`~repro_torch.runtime.worker.MultiprocBackend` pool.

    ``heartbeat_interval`` paces the liveness sweep; ``rpc_timeout``
    (optional) bounds every worker RPC so hangs surface as recoverable
    failures instead of blocking forever; ``snapshot_states`` arms the
    recovery state source, refreshed every ``snapshot_every`` steps (wire
    mode only — spill files are always per-step). ``snapshot_mode`` is
    ``"auto"`` (spill when the launcher's workers share this host's
    filesystem, wire otherwise), ``"spill"`` or ``"wire"``. ``on_event``
    is a convenience alias for the backend's ``on_worker_event`` hook.
    """

    def __init__(
        self,
        backend: Any,
        heartbeat_interval: float = 0.5,
        rpc_timeout: Optional[float] = None,
        snapshot_states: bool = True,
        snapshot_every: int = 1,
        snapshot_mode: str = "auto",
        on_event: Optional[Any] = None,
    ):
        if not hasattr(backend, "recover_worker"):
            raise ValueError(
                "supervision requires a worker-pool backend "
                f"(backend={getattr(backend, 'name', backend)!r} has no "
                "recover_worker); use backend='multiproc'"
            )
        if snapshot_mode not in ("auto", "spill", "wire"):
            raise ValueError(
                f"snapshot_mode must be auto|spill|wire, got {snapshot_mode!r}"
            )
        if snapshot_mode == "auto":
            snapshot_mode = (
                "spill"
                if getattr(backend.launcher, "supports_spill", False)
                else "wire"
            )
        self.backend = backend
        self.heartbeat_interval = heartbeat_interval
        backend.self_heal = True
        backend.snapshot_mode = snapshot_mode if snapshot_states else "wire"
        backend.shadow_states = snapshot_states and snapshot_mode == "wire"
        backend.snapshot_every = max(int(snapshot_every), 1)
        if rpc_timeout is not None:
            backend.rpc_timeout = rpc_timeout
        if on_event is not None:
            backend.on_worker_event = on_event
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------------
    def start(self) -> "WorkerSupervisor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="repro-supervisor", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.heartbeat_interval * 4 + 1.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- heartbeats -------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self._sweep(ping=False)
            except Exception:  # pragma: no cover - sweep must never die
                pass

    def _sweep(self, ping: bool) -> List[int]:
        """One liveness pass; returns the workers recovered."""
        be = self.backend
        if not be._spawned:
            return []
        recovered: List[int] = []
        for i in range(be.n_workers):
            if i >= len(be._procs):  # mid-resize snapshot; next sweep catches up
                break
            gen = be._gen[i]
            dead = not be.worker_alive(i)
            if not dead and ping and be.worker_ready(i):
                dead = not be.ping_worker(i)
            if dead and be._gen[i] == gen:
                be._emit_worker_event(HEARTBEAT_MISSED, worker=i,
                                      detail=f"gen={gen}")
                # fetched per-event (get-or-create is idempotent) so the
                # counter survives a configure_obs registry swap
                be.metrics.counter(
                    "repro_supervisor_recoveries_total",
                    "workers recovered by the supervisor liveness sweep",
                ).inc(source="ping" if ping else "heartbeat")
                with be.tracer.span("supervisor_recover", "control",
                                    worker=i, gen=gen):
                    be.recover_worker(i, expect_gen=gen)
                recovered.append(i)
        return recovered

    def check(self) -> List[int]:
        """Synchronous deep health check: ``is_alive`` plus a bounded ping
        per worker that has finished spawning. Recovers whatever it finds
        dead; returns their ids."""
        return self._sweep(ping=True)

    # -- reporting --------------------------------------------------------------
    @property
    def recoveries(self) -> List[Dict[str, Any]]:
        return list(self.backend.respawns)

    def health(self) -> Dict[str, Any]:
        health = dict(self.backend.worker_health() or {})
        health["heartbeat_interval"] = self.heartbeat_interval
        health["heartbeat_running"] = self.running
        return health

    def __enter__(self) -> "WorkerSupervisor":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
