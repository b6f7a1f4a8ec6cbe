"""Wire protocol for the multi-tenant serving front end.

Framing rides the ``tcp`` transport's length-prefixed socket machinery
verbatim (``u32 header length | JSON header | u32 payload length | raw
payload``) — requests and responses are header-only JSON messages, the
payload side of the frame stays empty. Dataflows travel inside the header
as their canonical :meth:`~repro_torch.core.graph.Dataflow.to_json` form.

Request verbs (``{"op": <verb>, ...}``):

  ========== ==========================================================
  verb       fields
  ========== ==========================================================
  submit     ``tenant``, ``dataflow`` (Dataflow JSON)
  remove     ``tenant``, ``name``
  status     —
  stats      optional ``tenant``
  step       optional ``steps`` (default 1)
  metrics    —
  checkpoint —
  drain      —
  shutdown   optional ``checkpoint`` (default true)
  ping       —
  ========== ==========================================================

Responses always carry ``"ok": true`` or ``"error": "<message>"``; submit
responses additionally carry an admission ``"status"``:

  * ``ADMITTED``    — running; ``slots_charged``/``reused``/``created``
    report the slot accounting (reused segments cost 0 slots).
  * ``QUEUED``      — accepted into the tenant's pending queue; admitted
    later in weighted fair-share order as slots free up.
  * ``RETRY_AFTER`` — backpressure: the slot pool is saturated AND the
    tenant's pending queue is full; ``retry_after`` is the resubmit hint
    in seconds.
  * ``REJECTED``    — can never be admitted under the current quota (cost
    exceeds the tenant's ``max_slots`` or the whole pool), or the server
    is draining, or the name is a duplicate.

This module imports no torch and is deliberately tiny: constants, the
dataflow codec, and the send/recv helpers shared by :class:`ServeFrontend`
and :class:`ServeClient`. It is the port's copy of
``repro.serve.protocol``, so either package's client speaks to either
package's server.
"""
from __future__ import annotations

import socket
from typing import Any, Dict, Optional

from repro_torch.core.graph import Dataflow
from repro_torch.runtime.transport import _recv_msg, _recv_msg_idle, _send_msg

# -- verbs ----------------------------------------------------------------------
SUBMIT = "submit"
REMOVE = "remove"
STATUS = "status"
STATS = "stats"
STEP = "step"
METRICS = "metrics"
CHECKPOINT = "checkpoint"
DRAIN = "drain"
SHUTDOWN = "shutdown"
PING = "ping"

VERBS = frozenset(
    {SUBMIT, REMOVE, STATUS, STATS, STEP, METRICS, CHECKPOINT, DRAIN, SHUTDOWN, PING}
)

# -- admission statuses ---------------------------------------------------------
ADMITTED = "ADMITTED"
QUEUED = "QUEUED"
RETRY_AFTER = "RETRY_AFTER"
REJECTED = "REJECTED"


class ServeProtocolError(RuntimeError):
    """The server reported an error for a request (bad verb, bad tenant…)."""


def encode_dataflow(df: Dataflow) -> Dict[str, Any]:
    return df.to_json()


def decode_dataflow(obj: Dict[str, Any]) -> Dataflow:
    return Dataflow.from_json(obj)


# -- socket helpers -------------------------------------------------------------


def send_request(sock: socket.socket, op: str, **fields: Any) -> None:
    _send_msg(sock, dict(fields, op=op))


def recv_request_idle(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Server side: one request header, or ``None`` on an idle poll timeout
    (see :func:`repro_torch.runtime.transport._recv_msg_idle`)."""
    msg = _recv_msg_idle(sock)
    return None if msg is None else msg[0]


def send_response(sock: socket.socket, response: Dict[str, Any]) -> None:
    _send_msg(sock, response)


def recv_response(sock: socket.socket) -> Dict[str, Any]:
    """Client side: one response header; raises on a server-side error."""
    header, _payload = _recv_msg(sock)
    if "error" in header:
        raise ServeProtocolError(header["error"])
    return header
