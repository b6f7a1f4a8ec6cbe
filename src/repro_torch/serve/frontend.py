"""ServeFrontend — a long-running multi-tenant dataflow server.

The port's copy of ``repro.serve.frontend``: the admission, quota,
fair-share, billing and ledger logic and the wire verbs are the
reference's; the session behind it is the port's, so with
``backend="torch"`` its dataflows step on the card (``device="cpu"``
keeps them on the CPU).

The paper's pitch is that collaborative reuse multiplies effective
capacity: a submission that merges into already-running dataflows only
needs resources for its *new* segments. This module turns that into an
admission-control policy. The frontend wraps one
:class:`~repro_torch.api.ReuseSession` behind a bounded **slot pool** — one slot
per newly-created running task — so a fully-reused submission costs zero
slots and is always admissible, while a cold submission pays full freight.

Admission of ``submit(tenant, df)``:

1. ``session.preview(df)`` plans the merge without committing — a pure
   read of the running set, so the quoted cost (``plan.num_created``) is
   exactly what a real submit would charge *right now*.
2. cost > tenant ``max_slots`` or > the whole pool → ``REJECTED`` (it can
   never fit).
3. cost ≤ free slots and nothing is queued ahead → submit for real,
   charge ``receipt.num_created`` slots → ``ADMITTED``.
4. otherwise queue it if the tenant has pending headroom → ``QUEUED``;
   else → ``RETRY_AFTER`` with a resubmit hint.

Queued submissions drain in **weighted fair-share** order (stride
scheduling): each tenant accrues virtual time ``vtime += slots_charged /
weight`` as its work is admitted, and the pending submission of the
lowest-vtime tenant that *fits* goes first — a greedy tenant cannot starve
a light one, and zero-cost (fully reused) submissions never block.

Per-tenant ledgers track slots held, slots saved by reuse (the cost a
no-reuse plan would have charged), and cumulative core-equivalent cost
billed from the backend ``account`` verb (shared tasks split their cost
evenly among the submissions using them). Ledgers persist across
checkpoint/restore via a JSON sidecar written atomically next to the
session's checkpoints.

The frontend is also a socket server (``start()``), speaking the framed
JSON protocol in :mod:`repro_torch.serve.protocol` over the tcp transport's
wire machinery; :class:`repro_torch.serve.client.ServeClient` is the matching
blocking client. With ``backend="dryrun"`` nothing here touches a device.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core import DataflowError
from repro_torch.core.graph import Dataflow

from . import protocol

logger = logging.getLogger(__name__)

_LEDGER_FILE = "frontend-ledger.json"


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits.

    ``max_slots`` caps the slots a tenant may hold at once; ``max_pending``
    caps its admission queue; ``weight`` scales its fair share (a weight-2
    tenant accrues virtual time half as fast, so it drains twice as often
    under contention).
    """

    max_slots: int = 64
    max_pending: int = 16
    weight: float = 1.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "max_slots": self.max_slots,
            "max_pending": self.max_pending,
            "weight": self.weight,
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "TenantQuota":
        return cls(
            max_slots=int(obj["max_slots"]),
            max_pending=int(obj["max_pending"]),
            weight=float(obj["weight"]),
        )


@dataclass
class TenantLedger:
    """Cumulative per-tenant accounting, persisted across restore."""

    tenant: str
    slots_held: int = 0
    slots_saved: int = 0  # Σ (submission size - slots charged): reuse dividend
    submitted: int = 0  # submit() calls seen (any outcome)
    admitted: int = 0
    rejected: int = 0
    backpressured: int = 0  # RETRY_AFTER responses (not terminal rejections)
    removed: int = 0
    cost_total: float = 0.0  # core-equivalent·steps billed to this tenant
    vtime: float = 0.0  # fair-share virtual time (slots/weight)
    dataflows: Dict[str, int] = field(default_factory=dict)  # name -> slots charged

    def to_json(self) -> Dict[str, Any]:
        return {
            "tenant": self.tenant,
            "slots_held": self.slots_held,
            "slots_saved": self.slots_saved,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "backpressured": self.backpressured,
            "removed": self.removed,
            "cost_total": self.cost_total,
            "vtime": self.vtime,
            "dataflows": dict(self.dataflows),
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "TenantLedger":
        return cls(
            tenant=obj["tenant"],
            slots_held=int(obj["slots_held"]),
            slots_saved=int(obj["slots_saved"]),
            submitted=int(obj["submitted"]),
            admitted=int(obj["admitted"]),
            rejected=int(obj["rejected"]),
            backpressured=int(obj.get("backpressured", 0)),
            removed=int(obj["removed"]),
            cost_total=float(obj["cost_total"]),
            vtime=float(obj["vtime"]),
            dataflows={k: int(v) for k, v in obj["dataflows"].items()},
        )


@dataclass(frozen=True)
class AdmissionResult:
    """Outcome of one submit — mirrors the wire response."""

    status: str  # protocol.ADMITTED / QUEUED / RETRY_AFTER / REJECTED
    name: str
    tenant: str
    slots_charged: int = 0
    reused: int = 0
    created: int = 0
    reason: str = ""
    retry_after: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "ok": True,
            "status": self.status,
            "name": self.name,
            "tenant": self.tenant,
        }
        if self.status == protocol.ADMITTED:
            out.update(
                slots_charged=self.slots_charged,
                reused=self.reused,
                created=self.created,
            )
        if self.reason:
            out["reason"] = self.reason
        if self.status == protocol.RETRY_AFTER:
            out["retry_after"] = self.retry_after
        return out


@dataclass(frozen=True)
class _Pending:
    tenant: str
    df: Dataflow
    seq: int  # arrival order, the fair-share tie-break


class ServeFrontend:
    """Multi-tenant serving daemon over one :class:`ReuseSession`.

    Usable purely in-process (call :meth:`submit` / :meth:`remove` /
    :meth:`step` directly) or as a socket server (:meth:`start` +
    :meth:`serve_forever`). All session-touching entry points serialize on
    one reentrant lock, so wire handlers and in-process callers compose.
    """

    def __init__(
        self,
        *,
        slots: int = 256,
        strategy: str = "signature",
        backend: str = "dryrun",
        default_quota: Optional[TenantQuota] = None,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        retry_after: float = 0.5,
        host: str = "127.0.0.1",
        port: int = 0,
        conn_timeout: float = 5.0,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        defrag_every: Optional[int] = None,
        metrics_port: Optional[int] = None,
        session: Optional[Any] = None,
        **session_kwargs: Any,
    ):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if session is not None:
            self.session = session
        else:
            from repro_torch.api import ReuseSession

            self.session = ReuseSession(
                strategy=strategy,
                execute=True,
                backend=backend,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                **session_kwargs,
            )
        self.slots = slots
        self.default_quota = default_quota or TenantQuota()
        self.quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self.retry_after = retry_after
        self.defrag_every = defrag_every
        self.host = host
        self.port = port
        self.conn_timeout = conn_timeout

        self._lock = threading.RLock()
        self.ledgers: Dict[str, TenantLedger] = {}
        self.tenant_of: Dict[str, str] = {}  # admitted dataflow name -> tenant
        self.naive_of: Dict[str, int] = {}  # admitted name -> task count (no-reuse cost)
        self._pending: List[_Pending] = []
        self._seq = 0
        self.slots_used = 0
        self.naive_slots = 0  # what a reuse-disabled pool would be holding
        self.steps = 0
        self._removes_since_defrag = 0
        self.draining = False

        # telemetry plane: serve-level gauges ride the session backend's
        # registry via a scrape-time collector; metrics_port (not None)
        # additionally serves plain-HTTP GET /metrics for Prometheus
        # scrapers that don't speak the framed JSON protocol (0 = ephemeral)
        self.metrics_port = metrics_port
        self._obs_registry: Optional[Any] = None
        self._metrics_sock: Optional[socket.socket] = None
        self._metrics_thread: Optional[threading.Thread] = None
        self._wire_serve_obs()

        # socket plumbing
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._closed = False
        self._shutdown_event = threading.Event()
        # set by the conn loop once a SHUTDOWN reply is on the wire, so the
        # stop thread doesn't close the socket under the in-flight response
        self._stop_ack: Optional[threading.Event] = None
        # one stop() at a time: the SHUTDOWN helper's and a close() that
        # serve_forever()'s return set off
        self._stop_lock = threading.Lock()

    # -- quota / ledger helpers ------------------------------------------------
    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def ledger_for(self, tenant: str) -> TenantLedger:
        ledger = self.ledgers.get(tenant)
        if ledger is None:
            ledger = self.ledgers[tenant] = TenantLedger(tenant=tenant)
        return ledger

    @property
    def slots_free(self) -> int:
        return self.slots - self.slots_used

    def _pending_of(self, tenant: str) -> int:
        return sum(1 for p in self._pending if p.tenant == tenant)

    # -- admission -------------------------------------------------------------
    def submit(self, tenant: str, df: Union[Dataflow, Any]) -> AdmissionResult:
        """Admit, queue, backpressure or reject one submission (see module
        docstring for the decision ladder)."""
        from repro_torch.api.builder import as_dataflow

        df = as_dataflow(df)
        with self._lock:
            ledger = self.ledger_for(tenant)
            ledger.submitted += 1
            if self.draining:
                ledger.rejected += 1
                return AdmissionResult(
                    status=protocol.REJECTED,
                    name=df.name,
                    tenant=tenant,
                    reason="server is draining",
                )
            if df.name in self.tenant_of or any(
                p.df.name == df.name for p in self._pending
            ):
                ledger.rejected += 1
                return AdmissionResult(
                    status=protocol.REJECTED,
                    name=df.name,
                    tenant=tenant,
                    reason=f"dataflow {df.name!r} already submitted",
                )
            quota = self.quota_for(tenant)
            try:
                cost = self.session.preview(df).num_created
            except DataflowError as e:
                ledger.rejected += 1
                return AdmissionResult(
                    status=protocol.REJECTED,
                    name=df.name,
                    tenant=tenant,
                    reason=str(e),
                )
            if cost > self.slots:
                ledger.rejected += 1
                return AdmissionResult(
                    status=protocol.REJECTED,
                    name=df.name,
                    tenant=tenant,
                    reason=f"cost {cost} exceeds the slot pool ({self.slots})",
                )
            if ledger.slots_held + cost > quota.max_slots:
                ledger.rejected += 1
                return AdmissionResult(
                    status=protocol.REJECTED,
                    name=df.name,
                    tenant=tenant,
                    reason=(
                        f"cost {cost} would exceed tenant quota "
                        f"({ledger.slots_held}/{quota.max_slots} slots held)"
                    ),
                )
            # Admit immediately only when nothing is queued — otherwise a
            # late cheap submission would jump the fair-share queue.
            if not self._pending and cost <= self.slots_free:
                return self._admit(tenant, df)
            if self._pending_of(tenant) < quota.max_pending:
                self._pending.append(_Pending(tenant=tenant, df=df, seq=self._seq))
                self._seq += 1
                # A queued cheap submission may fit even while the head
                # blocks — but only via the fair-share pass, never LIFO.
                admitted = self._drain_pending()
                for result in admitted:
                    if result.name == df.name:
                        return result
                return AdmissionResult(
                    status=protocol.QUEUED, name=df.name, tenant=tenant
                )
            ledger.backpressured += 1
            return AdmissionResult(
                status=protocol.RETRY_AFTER,
                name=df.name,
                tenant=tenant,
                reason=(
                    f"slot pool saturated ({self.slots_used}/{self.slots}) and "
                    f"tenant queue full ({quota.max_pending} pending)"
                ),
                retry_after=self.retry_after,
            )

    def _admit(self, tenant: str, df: Dataflow) -> AdmissionResult:
        """Commit one submission and charge the tenant. Lock held."""
        receipt = self.session.submit(df)
        charged = receipt.num_created
        ledger = self.ledger_for(tenant)
        ledger.admitted += 1
        ledger.slots_held += charged
        ledger.slots_saved += receipt.num_reused
        ledger.vtime += charged / self.quota_for(tenant).weight
        ledger.dataflows[df.name] = charged
        self.tenant_of[df.name] = tenant
        self.slots_used += charged
        self.naive_of[df.name] = len(df.tasks)
        self.naive_slots += len(df.tasks)
        return AdmissionResult(
            status=protocol.ADMITTED,
            name=df.name,
            tenant=tenant,
            slots_charged=charged,
            reused=receipt.num_reused,
            created=charged,
        )

    def _drain_pending(self) -> List[AdmissionResult]:
        """Admit queued submissions in weighted fair-share order.

        Repeatedly picks the lowest-vtime tenant whose *oldest* pending
        submission fits the free slots (arrival seq breaks vtime ties), so
        slots freed by a removal flow to the tenant furthest below its
        fair share. Lock held.
        """
        admitted: List[AdmissionResult] = []
        while self._pending:
            head_of: Dict[str, _Pending] = {}
            for p in self._pending:
                if p.tenant not in head_of:  # list is in arrival order
                    head_of[p.tenant] = p
            candidates = [
                p
                for p in head_of.values()
                if self.session.preview(p.df).num_created <= self.slots_free
            ]
            if not candidates:
                break
            pick = min(
                candidates,
                key=lambda p: (self.ledger_for(p.tenant).vtime, p.seq),
            )
            self._pending.remove(pick)
            admitted.append(self._admit(pick.tenant, pick.df))
        return admitted

    # -- removal ---------------------------------------------------------------
    def remove(self, tenant: str, name: str) -> Dict[str, Any]:
        """Remove a tenant's dataflow, free its slots, and admit whatever
        queued work now fits (fair-share order)."""
        with self._lock:
            owner = self.tenant_of.get(name)
            if owner is None:
                # Also allow cancelling a queued (not yet admitted) submission.
                for p in self._pending:
                    if p.df.name == name and p.tenant == tenant:
                        self._pending.remove(p)
                        return {"ok": True, "name": name, "cancelled": True,
                                "slots_freed": 0, "admitted": []}
                raise DataflowError(f"dataflow {name!r} is not admitted")
            if owner != tenant:
                raise DataflowError(
                    f"dataflow {name!r} belongs to tenant {owner!r}, not {tenant!r}"
                )
            self.session.remove(name)
            ledger = self.ledger_for(tenant)
            freed = ledger.dataflows.pop(name, 0)
            ledger.slots_held -= freed
            ledger.removed += 1
            del self.tenant_of[name]
            self.slots_used -= freed
            self.naive_slots -= self.naive_of.pop(name, 0)
            self._removes_since_defrag += 1
            if (
                self.defrag_every
                and self._removes_since_defrag >= self.defrag_every
            ):
                self.session.defragment()
                self._removes_since_defrag = 0
            admitted = self._drain_pending()
            return {
                "ok": True,
                "name": name,
                "cancelled": False,
                "slots_freed": freed,
                "admitted": [r.to_json() for r in admitted],
            }

    # -- execution & billing -----------------------------------------------------
    def step(self, steps: int = 1) -> Dict[str, Any]:
        """Advance the data plane ``steps`` steps, billing each step's
        core-equivalent cost to tenants: a running task's weight splits
        evenly among the submissions mapped onto it (reuse halves your
        bill), and each submission bills its tenant."""
        with self._lock:
            last = None
            for _ in range(steps):
                last = self.session.step()
                self._bill(last.cost)
                self.steps += 1
            return {
                "ok": True,
                "steps": steps,
                "step": last.step if last else self.steps,
                "live_tasks": last.live_tasks if last else 0,
                "cost": last.cost if last else 0.0,
            }

    def _bill(self, step_cost: float) -> None:
        """Split one step's cost across tenants by shared-task usage."""
        mgr = self.session.manager
        users: Dict[str, List[str]] = {}
        for sub_name, task_map in mgr.task_maps.items():
            for tid in set(task_map.values()):
                users.setdefault(tid, []).append(sub_name)
        weight_of: Dict[str, float] = {}
        total = 0.0
        backend = self.session._system.backend
        from repro_torch.runtime.backend import PAUSE_EPSILON

        for seg in backend.segments.values():
            for tid in seg.spec.task_ids:
                w = seg.cost_of[tid] * seg.spec.batch_of[tid]
                if not bool(seg.active[tid]):
                    w *= PAUSE_EPSILON
                weight_of[tid] = weight_of.get(tid, 0.0) + w
                total += w
        if total <= 0.0:
            return
        scale = step_cost / total  # normalize model weights to billed cores
        for tid, subs in users.items():
            w = weight_of.get(tid)
            if not w:
                continue
            share = w * scale / len(subs)
            for sub_name in subs:
                tenant = self.tenant_of.get(sub_name)
                if tenant is not None:
                    self.ledger_for(tenant).cost_total += share

    # -- observability -----------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "ok": True,
                "slots": self.slots,
                "slots_used": self.slots_used,
                "slots_free": self.slots_free,
                "pending": len(self._pending),
                "tenants": sorted(self.ledgers),
                "dataflows": len(self.tenant_of),
                "steps": self.steps,
                "draining": self.draining,
                "strategy": self.session.strategy,
                "backend": self.session.backend_name,
                # cluster plane: worker liveness/respawns/autoscale for the
                # multiproc backend, null for in-process data planes
                "worker_health": self.session.worker_health(),
            }

    def stats(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Status plus per-tenant ledgers and the reuse dividend:
        ``effective_capacity`` is naive slots / slots actually used — how
        many pools' worth of work the one pool is carrying."""
        with self._lock:
            ledgers = (
                {tenant: self.ledger_for(tenant)}
                if tenant is not None
                else self.ledgers
            )
            out = self.status()
            out["naive_slots"] = self.naive_slots
            out["effective_capacity"] = (
                self.naive_slots / self.slots_used if self.slots_used else 1.0
            )
            out["ledgers"] = {t: l.to_json() for t, l in ledgers.items()}
            return out

    # -- telemetry plane ---------------------------------------------------------
    def _wire_serve_obs(self) -> None:
        """Register the serve-level collector on the session backend's
        metrics registry (idempotent per registry instance — re-run after
        ``configure_obs`` swaps the registry)."""
        system = getattr(self.session, "_system", None)
        if system is None:
            return
        registry = system.backend.metrics
        if registry is self._obs_registry:
            return
        registry.add_collector(self._collect_serve_obs)
        self._obs_registry = registry

    def _collect_serve_obs(self) -> None:
        """Mirror admission/ledger state into the registry at scrape time.

        Lock order matches the admission path (frontend lock, then
        registry lock), so a mid-churn scrape can never deadlock and
        always sees a consistent ledger snapshot.
        """
        m = self._obs_registry
        if m is None:
            return
        with self._lock:
            m.gauge("repro_serve_slots", "admission slot pool size").set(self.slots)
            m.gauge(
                "repro_serve_slots_used", "slots currently charged to tenants"
            ).set(self.slots_used)
            m.gauge(
                "repro_serve_pending", "submissions queued for fair-share admission"
            ).set(len(self._pending))
            m.gauge(
                "repro_serve_naive_slots",
                "slots a reuse-disabled pool would be holding for the same work",
            ).set(self.naive_slots)
            m.gauge(
                "repro_serve_effective_capacity",
                "naive slots over slots actually used — pools' worth of work "
                "the one pool is carrying thanks to reuse",
            ).set(self.naive_slots / self.slots_used if self.slots_used else 1.0)
            for tenant, ledger in self.ledgers.items():
                m.gauge(
                    "repro_serve_slots_held",
                    "slots currently held, by tenant",
                ).set(ledger.slots_held, tenant=tenant)
                m.gauge(
                    "repro_serve_slots_saved",
                    "cumulative slots not charged because the submission "
                    "reused running tasks, by tenant",
                ).set(ledger.slots_saved, tenant=tenant)
                m.gauge(
                    "repro_serve_cost_total",
                    "cumulative core-equivalent step cost billed, by tenant",
                ).set(ledger.cost_total, tenant=tenant)

    def metrics(self) -> Dict[str, Any]:
        """The merged telemetry snapshot, both machine forms: ``text`` is
        Prometheus exposition 0.0.4 (what the HTTP listener serves),
        ``snapshot`` the raw registry JSON."""
        from repro_torch.obs import render_prometheus

        self._wire_serve_obs()
        if getattr(self.session, "_system", None) is None:
            return {"ok": True, "text": "", "snapshot": {}}
        snapshot = self.session.metrics_snapshot()
        return {"ok": True, "text": render_prometheus(snapshot), "snapshot": snapshot}

    def start_metrics_http(self, port: Optional[int] = None) -> Tuple[str, int]:
        """Serve ``GET /metrics`` as plain-HTTP Prometheus text on a daemon
        thread; returns ``(host, port)``. Started automatically by
        :meth:`start` when the frontend was built with ``metrics_port=``;
        callable directly for in-process use (``port=0`` → ephemeral)."""
        if self._metrics_sock is not None:
            return self._metrics_sock.getsockname()[:2]
        bind_port = self.metrics_port if port is None else port
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, int(bind_port or 0)))
        sock.listen(16)
        self._metrics_sock = sock
        self._metrics_thread = threading.Thread(
            target=self._metrics_http_loop, name="serve-metrics-http", daemon=True
        )
        self._metrics_thread.start()
        return sock.getsockname()[:2]

    def stop_metrics_http(self) -> None:
        sock = self._metrics_sock
        if sock is None:
            return
        self._metrics_sock = None
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        if self._metrics_thread is not None:
            self._metrics_thread.join(timeout=5.0)
            self._metrics_thread = None

    def _metrics_http_loop(self) -> None:
        sock = self._metrics_sock
        while self._metrics_sock is sock:
            try:
                conn, _addr = sock.accept()
            except OSError:
                break
            try:
                conn.settimeout(2.0)
                data = b""
                while b"\r\n\r\n" not in data and len(data) < 65536:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                parts = data.split(b"\r\n", 1)[0].decode("latin-1", "replace").split()
                path = (parts[1] if len(parts) > 1 else "/").split("?")[0]
                if path in ("/metrics", "/"):
                    body = self.metrics()["text"].encode("utf-8")
                    head = (
                        "HTTP/1.1 200 OK\r\n"
                        "Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
                        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                    ).encode("latin-1")
                else:
                    body = b"not found\n"
                    head = (
                        "HTTP/1.1 404 Not Found\r\nContent-Type: text/plain\r\n"
                        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                    ).encode("latin-1")
                conn.sendall(head + body)
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    # -- durability ----------------------------------------------------------------
    def _ledger_payload(self) -> Dict[str, Any]:
        return {
            "version": 2,
            "slots": self.slots,
            "slots_used": self.slots_used,
            "naive_slots": self.naive_slots,
            "steps": self.steps,
            "tenant_of": dict(self.tenant_of),
            "naive_of": dict(self.naive_of),
            "ledgers": {t: l.to_json() for t, l in self.ledgers.items()},
            "quotas": {t: q.to_json() for t, q in self.quotas.items()},
            "default_quota": self.default_quota.to_json(),
            # the QUEUED admission queue, in arrival order — encoded
            # dataflows so a restart re-enqueues instead of dropping them
            "pending": [
                {"tenant": p.tenant, "seq": p.seq,
                 "dataflow": protocol.encode_dataflow(p.df)}
                for p in self._pending
            ],
            "pending_seq": self._seq,
        }

    def _load_ledger_payload(self, payload: Dict[str, Any]) -> None:
        self.slots = int(payload["slots"])
        self.slots_used = int(payload["slots_used"])
        self.naive_slots = int(payload["naive_slots"])
        self.steps = int(payload["steps"])
        self.tenant_of = dict(payload["tenant_of"])
        self.naive_of = {k: int(v) for k, v in payload["naive_of"].items()}
        self.ledgers = {
            t: TenantLedger.from_json(l) for t, l in payload["ledgers"].items()
        }
        self.quotas = {
            t: TenantQuota.from_json(q) for t, q in payload["quotas"].items()
        }
        self.default_quota = TenantQuota.from_json(payload["default_quota"])
        # version-1 sidecars have no pending queue — tolerate their absence
        self._pending = [
            _Pending(tenant=p["tenant"],
                     df=protocol.decode_dataflow(p["dataflow"]),
                     seq=int(p["seq"]))
            for p in payload.get("pending", [])
        ]
        self._seq = int(payload.get("pending_seq", self._seq))
        if self._pending:
            self._seq = max(self._seq, max(p.seq for p in self._pending) + 1)

    def checkpoint(self, checkpoint_dir: Optional[str] = None) -> str:
        """One durable checkpoint: session state via the checkpoint store,
        tenant ledgers as an atomic JSON sidecar in the same directory."""
        with self._lock:
            path = self.session.checkpoint(checkpoint_dir)
            root = checkpoint_dir or os.path.dirname(path)
            sidecar = os.path.join(root, _LEDGER_FILE)
            tmp = sidecar + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self._ledger_payload(), fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, sidecar)
            return path

    @classmethod
    def restore(cls, checkpoint_dir: str, **kwargs: Any) -> "ServeFrontend":
        """Rebuild frontend + session from ``checkpoint_dir``: the session
        restores from the newest valid checkpoint
        (:meth:`ReuseSession.restore`), the tenant ledgers — including the
        QUEUED admission queue — from the sidecar. Re-enqueued submissions
        go through one fair-share drain pass immediately, so whatever now
        fits is admitted before the first post-restore request arrives."""
        from repro_torch.api import ReuseSession

        session_kwargs = {
            k: kwargs.pop(k)
            for k in ("backend", "device", "step_mode", "max_workers", "supervise",
                      "autoscale", "on_worker_event", "transport", "workers",
                      "backend_options")
            if k in kwargs
        }
        session = ReuseSession.restore(checkpoint_dir, **session_kwargs)
        frontend = cls(session=session, checkpoint_dir=checkpoint_dir, **kwargs)
        sidecar = os.path.join(checkpoint_dir, _LEDGER_FILE)
        if os.path.exists(sidecar):
            with open(sidecar, "r", encoding="utf-8") as fh:
                frontend._load_ledger_payload(json.load(fh))
            with frontend._lock:
                frontend._drain_pending()
        return frontend

    # -- lifecycle ---------------------------------------------------------------
    def drain(self) -> Dict[str, Any]:
        """Stop accepting, run one final fair-share pass, reject the
        remainder, and quiesce the data plane."""
        with self._lock:
            self.draining = True
            admitted = self._drain_pending()
            shed = []
            for p in self._pending:
                self.ledger_for(p.tenant).rejected += 1
                shed.append({"tenant": p.tenant, "name": p.df.name})
            self._pending.clear()
            self.session.quiesce()
            return {
                "ok": True,
                "admitted": [r.to_json() for r in admitted],
                "shed": shed,
            }

    def close(self) -> None:
        """Stop the socket server (if running) and release the session."""
        self.stop()
        self.session.close()

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- socket server ------------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        if self._sock is None:
            raise RuntimeError("server not started")
        return self._sock.getsockname()[:2]

    def start(self) -> Tuple[str, int]:
        """Bind, listen and serve on a daemon thread; returns (host, port).
        SO_REUSEADDR + per-connection timeouts mean a restart rebinds the
        same port immediately even with stale client sockets around."""
        if self._sock is not None:
            raise RuntimeError("server already started")
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(64)
        self._sock = sock
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="serve-frontend-accept", daemon=True
        )
        self._accept_thread.start()
        host, port = self.address
        logger.info("serving on %s:%d", host, port)
        if self.metrics_port is not None and self._metrics_sock is None:
            mhost, mport = self.start_metrics_http()
            logger.info("metrics on http://%s:%d/metrics", mhost, mport)
        return host, port

    def serve_forever(self) -> None:
        """Block until a shutdown request (or :meth:`stop`) arrives.

        After a SHUTDOWN request this returns only once the reply is on the
        wire: a helper thread waits for the connection's thread to send it
        (at most 2 s), then runs :meth:`stop`, which sets the event this
        waits on. A caller's :meth:`close` after the return (the daemon's)
        waits for that :meth:`stop` and finds the server stopped."""
        if self._sock is None:
            self.start()
        self._shutdown_event.wait()

    def stop(self) -> None:
        """Close the listener and all live connections; joins the accept
        thread. Idempotent, and one caller at a time: a second caller
        waits for the first to finish."""
        with self._stop_lock:
            self._stop()

    def _stop(self) -> None:
        self.stop_metrics_http()
        if self._sock is None:
            return
        self._closed = True
        self._shutdown_event.set()
        # shutdown() before close(): close() alone doesn't wake a thread
        # blocked in accept(), which would keep the port bound.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        for t in self._conn_threads:
            t.join(timeout=5.0)
        self._conn_threads = []
        self._sock = None

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                break
            with self._conns_lock:
                if self._closed:
                    conn.close()
                    break
                self._conns.add(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(self.conn_timeout)
        try:
            while not self._closed:
                try:
                    request = protocol.recv_request_idle(conn)
                except (ConnectionError, OSError):
                    break
                if request is None:  # idle poll — re-check _closed
                    continue
                try:
                    response = self._handle(request)
                except DataflowError as e:
                    response = {"error": str(e)}
                except Exception as e:  # noqa: BLE001 — wire must answer
                    logger.exception("request failed: %r", request.get("op"))
                    response = {"error": f"{type(e).__name__}: {e}"}
                try:
                    protocol.send_response(conn, response)
                except (ConnectionError, OSError):
                    break
                if request.get("op") == protocol.SHUTDOWN:
                    ack = self._stop_ack
                    if ack is not None:
                        ack.set()
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, request: Dict[str, Any]) -> Dict[str, Any]:
        op = request.get("op")
        if op == protocol.PING:
            return {"ok": True}
        if op == protocol.SUBMIT:
            df = protocol.decode_dataflow(request["dataflow"])
            return self.submit(request["tenant"], df).to_json()
        if op == protocol.REMOVE:
            return self.remove(request["tenant"], request["name"])
        if op == protocol.STATUS:
            return self.status()
        if op == protocol.STATS:
            return self.stats(request.get("tenant"))
        if op == protocol.STEP:
            return self.step(int(request.get("steps", 1)))
        if op == protocol.METRICS:
            return self.metrics()
        if op == protocol.CHECKPOINT:
            return {"ok": True, "path": self.checkpoint()}
        if op == protocol.DRAIN:
            return self.drain()
        if op == protocol.SHUTDOWN:
            out: Dict[str, Any] = {"ok": True}
            with self._lock:
                self.draining = True
                if request.get("checkpoint", True) and (
                    self.session._system is not None
                    and self.session._system.checkpoint_store is not None
                ):
                    out["path"] = self.checkpoint()
            # Stop from a helper thread, but only after the conn loop has
            # flushed this response (it sets _stop_ack) — otherwise stop()
            # can close the socket under the reply and the client sees
            # ConnectionError instead of {"ok": true}. The shutdown event
            # is set by that stop(), not here: serve_forever() returning
            # early would let its caller's close() race the reply too.
            ack = threading.Event()
            self._stop_ack = ack

            def _stop_after_reply() -> None:
                ack.wait(timeout=2.0)
                self.stop()

            threading.Thread(target=_stop_after_reply, daemon=True).start()
            return out
        raise DataflowError(f"unknown op {op!r} (expected one of {sorted(protocol.VERBS)})")
