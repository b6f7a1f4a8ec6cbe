"""Worker launchers — how the multiproc coordinator gets a worker process.

The port's copy of ``repro.cluster.launcher``: a pluggable launcher seam,
so recovery respawns dead workers through the same code path that spawned
them, and so the pool can span hosts:

  * :class:`LocalProcessLauncher` — a ``spawn``-start :mod:`multiprocessing`
    child connected by a duplex pipe. Default.
  * :class:`SubprocessLauncher` — ssh-shaped remote launch. The worker is
    started as ``prefix + [python, -m, repro_torch.cluster.launcher,
    --connect host:port, --token t]`` and dials back to the coordinator;
    the worker command pipe then runs over that TCP socket using the same
    length-prefixed JSON framing as the ``tcp`` stream transport
    (:func:`~repro_torch.runtime.transport._send_msg`). With
    ``command_prefix=["ssh", "node7"]`` the process lands on another host
    — pair it with ``transport="tcp"`` so the data plane spans hosts too.

Both start the port's worker loop
(:func:`repro_torch.runtime.worker._worker_main`) and pass it the worker's
``options`` — its device and its intra-op thread count — beside the
transport spec, its plane and its log path. Both return a
:class:`WorkerHandle`: the command connection plus the process-lifecycle
surface (``is_alive`` / ``terminate`` / ``join``) that recovery needs.
"""
from __future__ import annotations

import os
import secrets
import select
import socket
import subprocess
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.runtime.transport import _recv_msg, _send_msg


class WorkerHandle:
    """Conn + lifecycle of one launched worker (duck-typed per launcher)."""

    conn: Any
    pid: Optional[int]

    def is_alive(self) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def terminate(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def join(self, timeout: Optional[float] = None) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        try:
            self.conn.close()
        except Exception:
            pass


class _MpHandle(WorkerHandle):
    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        self.pid = proc.pid

    def is_alive(self) -> bool:
        return self.proc.is_alive()

    def terminate(self) -> None:
        self.proc.kill()

    def join(self, timeout: Optional[float] = None) -> None:
        self.proc.join(timeout=timeout)


class _PopenHandle(WorkerHandle):
    def __init__(self, proc: subprocess.Popen, conn: "SocketPipe"):
        self.proc = proc
        self.conn = conn
        self.pid = proc.pid

    def is_alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self) -> None:
        self.proc.kill()

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass


class SocketPipe:
    """``multiprocessing.Connection``-shaped wrapper over a TCP socket.

    Messages are JSON dicts in the tcp transport's wire framing (u32
    header length + JSON), so the worker pipe protocol crosses hosts with
    the exact machinery the data plane already trusts. ``recv`` raises
    :class:`EOFError` on a closed peer — matching pipe semantics, so the
    coordinator's dead-worker detection works unchanged."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, obj: Dict[str, Any]) -> None:
        with self._send_lock:
            _send_msg(self._sock, obj)

    def recv(self) -> Dict[str, Any]:
        try:
            header, _ = _recv_msg(self._sock)
        except (ConnectionError, OSError) as e:
            raise EOFError(str(e)) from e
        return header

    def poll(self, timeout: float = 0.0) -> bool:
        try:
            ready, _, _ = select.select([self._sock], [], [], timeout)
        except OSError:
            return True  # closed socket: recv will raise EOFError promptly
        return bool(ready)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class LocalProcessLauncher:
    """Spawn workers as local ``multiprocessing`` children."""

    name = "local"
    # workers share the coordinator's filesystem -> spill snapshots work
    supports_spill = True

    def __init__(self):
        import multiprocessing as mp

        # spawn, not fork: a forked child of a process that holds a CUDA
        # context cannot use the card
        self._ctx = mp.get_context("spawn")

    def launch(self, worker_id: int, transport_spec: Dict[str, Any],
               plane: str, log_path: str,
               options: Optional[Dict[str, Any]] = None) -> WorkerHandle:
        from repro_torch.runtime.worker import _worker_main

        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, worker_id, transport_spec, plane, log_path, options),
            name=f"repro-worker-{worker_id}",
            daemon=True,
        )
        proc.start()
        child_conn.close()
        return _MpHandle(proc, parent_conn)


class SubprocessLauncher:
    """Launch workers as subprocesses that dial back over TCP (ssh-shaped).

    ``command_prefix`` is prepended to the worker command line — empty for
    a plain local subprocess, ``["ssh", "nodeN"]`` (or a container exec)
    to land the worker elsewhere. The remote side needs ``repro_torch`` on its
    ``PYTHONPATH`` (exported automatically for local subprocesses) and
    network reach back to ``connect_host``; the stream transport must be
    one that spans processes by address (``tcp``) when hosts differ.
    """

    name = "subprocess"

    def __init__(
        self,
        command_prefix: Sequence[str] = (),
        python: Optional[str] = None,
        connect_host: str = "127.0.0.1",
        accept_timeout: float = 30.0,
    ):
        # a plain subprocess shares this host's filesystem; an ssh/container
        # prefix lands the worker where coordinator-side spill reads fail
        self.supports_spill = not command_prefix
        self.command_prefix = list(command_prefix)
        self.python = python or sys.executable
        self.connect_host = connect_host
        self.accept_timeout = accept_timeout

    def launch(self, worker_id: int, transport_spec: Dict[str, Any],
               plane: str, log_path: str,
               options: Optional[Dict[str, Any]] = None) -> WorkerHandle:
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((self.connect_host if not self.command_prefix else "0.0.0.0", 0))
        server.listen(1)
        port = server.getsockname()[1]
        token = secrets.token_hex(16)
        cmd = self.command_prefix + [
            self.python, "-m", "repro_torch.cluster.launcher",
            "--connect", f"{self.connect_host}:{port}", "--token", token,
        ]
        env = dict(os.environ)
        if not self.command_prefix:
            # local subprocess: make sure the child finds this tree
            # (namespace package: __file__ is None, __path__ still points in)
            import repro_torch

            pkg_dir = (
                os.path.dirname(repro_torch.__file__)
                if getattr(repro_torch, "__file__", None)
                else next(iter(repro_torch.__path__))
            )
            src = os.path.dirname(os.path.abspath(pkg_dir))
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(cmd, env=env)
        server.settimeout(self.accept_timeout)
        try:
            sock, _ = server.accept()
        except socket.timeout:
            proc.kill()
            raise TimeoutError(
                f"worker {worker_id} did not dial back within "
                f"{self.accept_timeout}s (cmd: {' '.join(cmd)})"
            ) from None
        finally:
            server.close()
        pipe = SocketPipe(sock)
        hello = pipe.recv()
        if hello.get("token") != token:
            pipe.close()
            proc.kill()
            raise ConnectionError(f"worker {worker_id} dial-back token mismatch")
        pipe.send({
            "worker_id": worker_id,
            "transport_spec": transport_spec,
            "plane": plane,
            "log_path": log_path,
            "options": options,
        })
        return _PopenHandle(proc, pipe)


_LAUNCHERS = {
    "local": LocalProcessLauncher,
    "subprocess": SubprocessLauncher,
}


def resolve_launcher(launcher: Union[str, Any]) -> Any:
    """``"local"`` / ``"subprocess"`` / an instance with ``.launch(...)``."""
    if isinstance(launcher, str):
        try:
            return _LAUNCHERS[launcher]()
        except KeyError:
            raise ValueError(
                f"unknown launcher {launcher!r} (have: {sorted(_LAUNCHERS)})"
            ) from None
    if not hasattr(launcher, "launch"):
        raise TypeError(f"launcher must expose .launch(...), got {launcher!r}")
    return launcher


def main(argv: Optional[List[str]] = None) -> int:
    """Remote worker entry point: dial the coordinator, run the worker loop."""
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.cluster.launcher")
    ap.add_argument("--connect", required=True, help="coordinator host:port")
    ap.add_argument("--token", required=True, help="dial-back auth token")
    args = ap.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=30.0)
    sock.settimeout(None)
    pipe = SocketPipe(sock)
    pipe.send({"token": args.token})
    handshake = pipe.recv()

    from repro_torch.runtime.worker import _worker_main

    _worker_main(
        pipe,
        int(handshake["worker_id"]),
        handshake["transport_spec"],
        handshake["plane"],
        handshake["log_path"],
        handshake.get("options"),
    )
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
