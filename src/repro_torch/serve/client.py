"""ServeClient — blocking client for the serving front end.

One persistent socket per client, one request/response exchange per call
(the protocol is strictly serial per connection). Read-only verbs
(``ping``/``status``/``stats``) reconnect-and-retry once on a broken
connection; mutating verbs never retry — a lost response to ``submit``
could otherwise double-submit. The port's copy of ``repro.serve.client``.

    with ServeClient(("127.0.0.1", 7421)) as client:
        result = client.submit("alice", df, wait=True)   # loops on RETRY_AFTER
        print(client.stats("alice")["ledgers"]["alice"]["slots_held"])
"""
from __future__ import annotations

import random
import socket
import time
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.core.graph import Dataflow

from . import protocol


class SubmitTimeout(TimeoutError):
    """``submit(wait=True)`` exhausted ``max_wait`` while the frontend kept
    answering RETRY_AFTER. Carries the last server response so callers can
    inspect the final backpressure hint instead of a silent non-admission."""

    def __init__(self, tenant: str, max_wait: float, last: Dict[str, Any]):
        self.tenant = tenant
        self.max_wait = max_wait
        self.last = last
        super().__init__(
            f"submit for tenant {tenant!r} still backpressured after "
            f"{max_wait:.1f}s (last status: {last.get('status')})"
        )


class ServeClient:
    def __init__(
        self,
        address: Tuple[str, int],
        timeout: float = 30.0,
    ):
        self.address = (address[0], int(address[1]))
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None

    # -- plumbing -----------------------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection(self.address, timeout=self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
        return self._sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, op: str, *, retry: bool = False, **fields: Any) -> Dict[str, Any]:
        attempts = 2 if retry else 1
        for attempt in range(attempts):
            sock = self._connect()
            try:
                protocol.send_request(sock, op, **fields)
                return protocol.recv_response(sock)
            except (ConnectionError, OSError, socket.timeout):
                self._drop()
                if attempt + 1 >= attempts:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- verbs --------------------------------------------------------------------
    def ping(self) -> bool:
        return bool(self._call(protocol.PING, retry=True).get("ok"))

    def submit(
        self,
        tenant: str,
        df: Union[Dataflow, Any],
        *,
        wait: bool = False,
        max_wait: float = 60.0,
    ) -> Dict[str, Any]:
        """Submit one dataflow for ``tenant``. With ``wait=True`` the client
        sleeps out RETRY_AFTER backpressure with jittered exponential
        backoff (base delay from the server's ``retry_after`` hint, capped
        at 5s) and resubmits; QUEUED and REJECTED return immediately either
        way. Raises :class:`SubmitTimeout` once ``max_wait`` elapses with
        the server still answering RETRY_AFTER — waiting callers never see
        a RETRY_AFTER result, and never hang past the deadline."""
        from repro_torch.api.builder import as_dataflow

        payload = protocol.encode_dataflow(as_dataflow(df))
        deadline = time.monotonic() + max_wait
        attempt = 0
        while True:
            result = self._call(protocol.SUBMIT, tenant=tenant, dataflow=payload)
            if not (wait and result.get("status") == protocol.RETRY_AFTER):
                return result
            now = time.monotonic()
            if now >= deadline:
                raise SubmitTimeout(tenant, max_wait, result)
            base = float(result.get("retry_after", 0.5))
            # full backoff doubles per attempt; jitter in [0.5, 1.0) spreads
            # synchronized waiters so they don't stampede the frontend
            delay = min(base * (2.0 ** attempt), 5.0)
            delay *= 0.5 + random.random() * 0.5
            time.sleep(min(delay, max(deadline - now, 0.0)))
            attempt += 1

    def remove(self, tenant: str, name: str) -> Dict[str, Any]:
        return self._call(protocol.REMOVE, tenant=tenant, name=name)

    def status(self) -> Dict[str, Any]:
        return self._call(protocol.STATUS, retry=True)

    def stats(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        fields = {"tenant": tenant} if tenant is not None else {}
        return self._call(protocol.STATS, retry=True, **fields)

    def step(self, steps: int = 1) -> Dict[str, Any]:
        return self._call(protocol.STEP, steps=steps)

    def metrics(self) -> Dict[str, Any]:
        """Telemetry scrape: ``{"text": <Prometheus 0.0.4>, "snapshot":
        <raw registry JSON>}``. Read-only, so it reconnect-retries."""
        return self._call(protocol.METRICS, retry=True)

    def checkpoint(self) -> str:
        return self._call(protocol.CHECKPOINT)["path"]

    def drain(self) -> Dict[str, Any]:
        return self._call(protocol.DRAIN)

    def shutdown(self, *, checkpoint: bool = True) -> Dict[str, Any]:
        out = self._call(protocol.SHUTDOWN, checkpoint=checkpoint)
        self._drop()
        return out

    # -- helpers ------------------------------------------------------------------
    @staticmethod
    def wait_ready(
        address: Tuple[str, int], timeout: float = 10.0, interval: float = 0.05
    ) -> "ServeClient":
        """Poll until a frontend answers ping at ``address``; returns a
        connected client. For scripts racing a freshly-started server."""
        deadline = time.monotonic() + timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            client = ServeClient(address, timeout=max(interval * 4, 1.0))
            try:
                if client.ping():
                    client.timeout = 30.0
                    if client._sock is not None:
                        client._sock.settimeout(client.timeout)
                    return client
            except (ConnectionError, OSError, socket.timeout) as e:
                last = e
                client.close()
            time.sleep(interval)
        raise ConnectionError(
            f"no serving frontend answered at {address[0]}:{address[1]} "
            f"within {timeout:.1f}s"
        ) from last
