"""Stream transports — the pluggable boundary-stream plane.

The port's copy of ``repro.runtime.transport``: the on-disk layout of a
shm topic, the tcp wire format and the registry names are the
reference's, so a batch one package publishes the other fetches.

The paper's merged dataflows run on a distributed DSPS: boundary streams
between partial DAGs cross worker (and host) boundaries through an
Enterprise Service Bus. The port's :class:`~repro_torch.runtime.broker.Broker`
is the in-process analogue; this module makes the *transport* a protocol so the
same data plane can ride a single process, a pool of worker processes, or
a TCP link between hosts. Transports plug in by name through a registry
mirroring ``MergeStrategy`` / ``ExecutionBackend`` / ``PlacementPolicy``:

  * ``"inproc"`` — :class:`InProcTransport`, the topic-granular broker
    (per-topic lock/sequence/condvar) on the protocol. Zero-copy (torch
    tensors by reference), single-process only.
  * ``"shm"`` — :class:`ShmTransport`, shared-memory ring buffers (one
    mmap-backed file per topic on ``/dev/shm``) with a per-topic sequence
    word and a seqlock read protocol, so worker *processes* publish and
    fetch without pickling through a pipe. This is the default transport
    of the ``multiproc`` backend.
  * ``"tcp"`` — :class:`TcpTransport`, a length-prefixed socket protocol
    against a :class:`TcpBrokerServer` (which wraps an in-process broker),
    so brokers can span hosts.

The protocol surface is exactly what the backends already use —

  ``publish / fetch / fetch_synced / drop / seq / sequences / has /
  topics / counters / reset_counters / __len__``

— which is what lets ``_fetch_inputs`` / ``_drop_streams`` ride any
transport untouched. Every transport keeps the broker's concurrency
contract: per-topic sequencing (``fetch_synced(topic, min_seq)`` blocks on
*its* producer only), and ``drop`` wakes in-flight synced fetches with a
``KeyError`` instead of deadlocking (kill/unmerge stay safe mid-step).

Cross-process attachment: transports that can span processes implement
:meth:`Transport.connect_info` (a picklable spec) and workers rebuild a
connected transport from it via :func:`connect_transport`.

Batches cross processes as numpy arrays, encoded as raw dtype/shape/bytes
(bit-exact for the float32 event tensors); this module imports no torch.

The seqlock's sequence word is written and read as one aligned 8-byte
store and load (:class:`_ShmTopic`), where the reference's ``struct``
packing writes it a byte at a time: a reader there can see a half-written
sequence number (0 on the way from 255 to 256: a spurious "no data"; a
smaller number than the true one: a read validated against a stale
sequence).
"""
from __future__ import annotations

import base64
import fcntl
import json
import mmap
import os
import random
import shutil
import socket
import struct
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple, Type, Union

import numpy as np

# The error taxonomy lives in broker.py (the transports wrap a Broker, so
# the in-process transport raises the same types for free) and is
# re-exported here: TransportError > TopicDropped (also a KeyError) >
# TransportTimeout (also a TimeoutError). Supervisor hang-detection can
# classify any transport stall with one `except TransportError`.
from .broker import Broker, TopicDropped, TransportError, TransportTimeout

__all__ = [
    "Transport",
    "TransportError",
    "TopicDropped",
    "TransportTimeout",
    "InProcTransport",
    "ShmTransport",
    "TcpTransport",
    "TcpBrokerServer",
    "register_transport",
    "available_transports",
    "resolve_transport",
    "connect_transport",
]


class Transport:
    """The boundary-stream protocol (see module docstring for the verbs).

    Concrete transports implement the full broker surface; the base class
    only pins down the contract and the cross-process attachment hooks.
    """

    name: str = ""
    # Process-local count of fetch/fetch_view/fetch_synced calls served.
    # Deliberately NOT part of counters() — that dict has an exact-equality
    # checkpoint contract — and not persisted; the obs layer mirrors it
    # into ``repro_transport_fetches`` at scrape time.
    fetch_count: int = 0

    # -- data path ------------------------------------------------------------
    def publish(self, topic: str, batch: Any) -> None:
        raise NotImplementedError

    def fetch(self, topic: str, copy: bool = False) -> Any:
        """Latest batch on ``topic``.

        Zero-copy by default: transports may return a **read-only view**
        into their own buffers (the shm ring, the wire receive buffer);
        such a view is bit-stable only until the producer laps the ring —
        callers that hold batches across steps, or mutate them, pass
        ``copy=True`` for a private writable array.
        """
        raise NotImplementedError

    def fetch_synced(
        self, topic: str, min_seq: int, timeout: float = 60.0, copy: bool = False
    ) -> Any:
        raise NotImplementedError

    def drop(self, topic: str) -> None:
        raise NotImplementedError

    # -- observability --------------------------------------------------------
    def seq(self, topic: str) -> int:
        raise NotImplementedError

    def sequences(self) -> Dict[str, int]:
        raise NotImplementedError

    def has(self, topic: str) -> bool:
        raise NotImplementedError

    def topics(self) -> Dict[str, Any]:
        raise NotImplementedError

    def counters(self) -> Dict[str, int]:
        """Cumulative ``{"bytes_published", "publishes"}`` across all topics."""
        raise NotImplementedError

    def reset_counters(self) -> None:
        raise NotImplementedError

    def restore_counters(self, bytes_published: int, publishes: int) -> None:
        """Set the cumulative counters (checkpoint restore)."""
        raise NotImplementedError

    def __len__(self) -> int:
        return sum(1 for _ in self.sequences())

    # -- lifecycle / attachment ----------------------------------------------
    def close(self) -> None:
        """Release transport resources (idempotent)."""

    def connect_info(self) -> Dict[str, Any]:
        """Picklable spec from which :func:`connect_transport` rebuilds a
        connected transport in another process. Transports that cannot
        span processes raise :class:`TransportError`."""
        raise TransportError(
            f"transport {self.name!r} cannot span processes "
            f"(pick 'shm' or 'tcp' for the multiproc backend)"
        )


# -- batch wire codec -----------------------------------------------------------


def _encode_batch(batch: Any) -> Tuple[Dict[str, Any], bytes]:
    """(header, payload bytes) for one event batch — bit-exact, JAX-free."""
    arr = np.asarray(batch, order="C")
    return {"dtype": arr.dtype.str, "shape": list(arr.shape)}, arr.tobytes()


def _decode_batch(
    header: Dict[str, Any], payload: Any, copy: bool = False
) -> np.ndarray:
    """Payload bytes → event batch.

    Zero-copy by default: the returned array is a **read-only**
    ``frombuffer`` view over ``payload`` (bytes, memoryview, or mmap
    slice); ``copy=True`` materializes a private writable array for the
    callers that mutate or outlive the buffer.
    """
    arr = np.frombuffer(payload, dtype=np.dtype(header["dtype"]))
    arr = arr.reshape(header["shape"])
    if copy:
        return arr.copy()
    if arr.flags.writeable:  # writable source buffer (e.g. an mmap slice)
        arr.flags.writeable = False
    return arr


# -- inproc ---------------------------------------------------------------------


class InProcTransport(Broker, Transport):
    """The topic-granular broker on the Transport protocol.

    Zero-copy (device buffers pass by reference) and thread-safe per
    topic, but confined to one process — the ``multiproc`` backend
    rejects it with a clear error. The broker's own ``counters`` and
    ``restore_counters`` serve the protocol.
    """

    name = "inproc"


# -- shm ------------------------------------------------------------------------

# Topic file layout (little-endian):
#   header (64 B):  magic u32 | version u32 | seq u64 | dropped u32 |
#                   nslots u32 | slot_bytes u64 | topic_bytes_published u64 |
#                   pad to 64
#   then nslots slots, each: slot header (64 B: dtype str16 | ndim u32 |
#   shape u64 x4 | nbytes u64 | pad) + slot_bytes payload capacity.
#
# Single-writer per topic (a running task has exactly one producing
# segment), so the header fields need no cross-process lock; readers use a
# seqlock: read seq, copy the slot, re-read seq — a publish that lapped the
# ring during the copy (seq advanced by >= nslots) forces a retry.
_SHM_MAGIC = 0x5250524F  # "RPRO"
_SHM_VERSION = 1
_HDR = struct.Struct("<IIQIIQQ")  # 40 bytes used, header padded to 64
_HDR_SIZE = 64
_SLOT_HDR = struct.Struct("<16sIIQQQQQ")  # dtype, ndim, pad, shape[4], nbytes
_SLOT_HDR_SIZE = 64
_SHM_NSLOTS = 4
_SHM_READ_RETRIES = 64


def _shm_root() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def _topic_filename(topic: str) -> str:
    return base64.urlsafe_b64encode(topic.encode("utf-8")).decode("ascii") + ".topic"


def _filename_topic(name: str) -> str:
    return base64.urlsafe_b64decode(name[: -len(".topic")].encode("ascii")).decode(
        "utf-8"
    )


# The header's words as native-endian views (the layout is little-endian;
# hosts that run this are): u64 index 1 is the sequence word (offset 8),
# index 4 the byte counter (offset 32); u32 index 4 the dropped flag
# (offset 16). Each is one aligned load or store.
_SEQ_WORD, _BYTES_WORD, _DROPPED_WORD = 1, 4, 4


class _ShmTopic:
    """One attached topic file: mmap + parsed geometry, and the header's
    words, read and written whole."""

    __slots__ = ("mm", "file", "nslots", "slot_bytes", "path", "ino", "u64", "u32")

    def __init__(self, path: str, file, mm: mmap.mmap, ino: int):
        self.path = path
        self.file = file
        self.mm = mm
        self.ino = ino
        magic, version, _seq, _dropped, nslots, slot_bytes, _tb = _HDR.unpack_from(
            mm, 0
        )
        if magic != _SHM_MAGIC or version != _SHM_VERSION:
            raise TransportError(f"shm topic file {path!r} has a bad header")
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        header = memoryview(mm)[:_HDR_SIZE]
        self.u64 = header.cast("Q")
        self.u32 = header.cast("I")

    def read_seq(self) -> int:
        return self.u64[_SEQ_WORD]

    def read_dropped(self) -> bool:
        return bool(self.u32[_DROPPED_WORD])

    def slot_offset(self, publish_no: int) -> int:
        idx = (publish_no - 1) % self.nslots
        return _HDR_SIZE + idx * (_SLOT_HDR_SIZE + self.slot_bytes)

    def close(self) -> None:
        self.u64.release()
        self.u32.release()
        try:
            self.mm.close()
        except BufferError:
            # A zero-copy fetch view still references this mapping; the OS
            # mapping is released when the last view is garbage-collected.
            pass
        finally:
            self.file.close()


class ShmTransport(Transport):
    """Shared-memory ring-buffer transport.

    Each topic is one fixed-capacity mmap-backed file under a session
    directory (on ``/dev/shm`` when available): a small ring of slots, a
    per-topic publish sequence word, and a per-topic byte counter. The
    directory doubles as the topic registry (one file per live topic), so
    any attached process can enumerate topics; the rare mutating ops
    (drop, counter reset) serialize on an ``flock`` while the publish /
    fetch hot path stays lock-free (single writer + seqlock readers).

    ``fetch_synced`` spins on the sequence word (with a micro-sleep), so a
    consumer process blocks on *its* producer's publish exactly like the
    in-process broker's condition variable — and a concurrent ``drop``
    wakes it with a ``KeyError`` via the dropped flag.

    ``slot_bytes`` bounds one batch's payload; topics size themselves from
    their first batch (with headroom) and raise a clear error if a later
    batch outgrows the ring.
    """

    name = "shm"

    def __init__(
        self,
        dir: Optional[str] = None,
        slot_bytes: Optional[int] = None,
        nslots: int = _SHM_NSLOTS,
    ):
        self._owner = dir is None
        if dir is None:
            dir = tempfile.mkdtemp(prefix=f"repro-shm-{uuid.uuid4().hex[:8]}-", dir=_shm_root())
        self.dir = dir
        self.slot_bytes = slot_bytes
        self.nslots = nslots
        self._attached: Dict[str, _ShmTopic] = {}
        self._lock = threading.Lock()  # guards the attach cache (thread side)
        # Dropped/stale incarnations are parked here instead of being
        # closed in place: a concurrent reader may still hold the mapping
        # (closing it mid-read would turn the contract KeyError into a
        # ValueError on a dead mmap). They are closed on close().
        self._retired: List[_ShmTopic] = []
        self._closed = False
        if self._owner:
            self._write_meta({"graveyard_bytes": 0, "graveyard_publishes": 0,
                              "base_bytes": 0, "base_publishes": 0})

    # -- registry / meta -------------------------------------------------------
    def _path(self, topic: str) -> str:
        return os.path.join(self.dir, _topic_filename(topic))

    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.json")

    def _flock(self):
        lock_path = os.path.join(self.dir, ".lock")
        f = open(lock_path, "a+")
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        return f

    def _read_meta(self) -> Dict[str, int]:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"graveyard_bytes": 0, "graveyard_publishes": 0,
                    "base_bytes": 0, "base_publishes": 0}

    def _write_meta(self, meta: Dict[str, int]) -> None:
        tmp = self._meta_path() + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())

    # -- attachment ------------------------------------------------------------
    def _attach(self, topic: str, create_bytes: Optional[int] = None) -> Optional[_ShmTopic]:
        """Attach (or create, when ``create_bytes`` is set) a topic file.

        The cache is invalidated when the on-disk incarnation changed
        (drop + re-publish creates a fresh file with a new inode)."""
        path = self._path(topic)
        with self._lock:
            cached = self._attached.get(topic)
            if cached is not None:
                try:
                    ino = os.stat(path).st_ino
                except FileNotFoundError:
                    ino = None
                if ino == cached.ino and not cached.read_dropped():
                    return cached
                self._retired.append(cached)  # maybe still mid-read elsewhere
                del self._attached[topic]
            if create_bytes is None:
                try:
                    f = open(path, "r+b")
                except FileNotFoundError:
                    return None
            else:
                slot_bytes = self.slot_bytes or max(4 * create_bytes, 1 << 16)
                size = _HDR_SIZE + self.nslots * (_SLOT_HDR_SIZE + slot_bytes)
                tmp = path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as tf:
                    tf.truncate(size)
                    buf = bytearray(_HDR_SIZE)
                    _HDR.pack_into(buf, 0, _SHM_MAGIC, _SHM_VERSION, 0, 0,
                                   self.nslots, slot_bytes, 0)
                    tf.seek(0)
                    tf.write(bytes(buf))
                os.replace(tmp, path)  # single writer — no create race
                f = open(path, "r+b")
            mm = mmap.mmap(f.fileno(), os.fstat(f.fileno()).st_size)
            st = _ShmTopic(path, f, mm, os.fstat(f.fileno()).st_ino)
            self._attached[topic] = st
            return st

    # -- data path -------------------------------------------------------------
    def publish(self, topic: str, batch: Any) -> None:
        header, payload = _encode_batch(batch)
        st = self._attach(topic)
        if st is None or st.read_dropped():
            st = self._attach(topic, create_bytes=len(payload))
        if len(payload) > st.slot_bytes:
            raise TransportError(
                f"batch of {len(payload)} B exceeds topic {topic!r} ring slot "
                f"capacity {st.slot_bytes} B — construct ShmTransport with a "
                f"larger slot_bytes"
            )
        seq = st.read_seq()
        off = st.slot_offset(seq + 1)
        shape = list(header["shape"])[:4] + [0] * max(0, 4 - len(header["shape"]))
        if len(header["shape"]) > 4:
            raise TransportError("shm transport carries batches of rank <= 4")
        _SLOT_HDR.pack_into(
            st.mm, off,
            header["dtype"].encode("ascii"), len(header["shape"]), 0,
            shape[0], shape[1], shape[2], shape[3], len(payload),
        )
        st.mm[off + _SLOT_HDR_SIZE: off + _SLOT_HDR_SIZE + len(payload)] = payload
        # publish point: bump the single-writer byte counter, then the
        # sequence word, last and in one store (a reader never sees it half
        # written)
        st.u64[_BYTES_WORD] += len(payload)
        st.u64[_SEQ_WORD] = seq + 1

    def _read_latest(
        self, st: _ShmTopic, topic: str, copy: bool = False
    ) -> Tuple[np.ndarray, int]:
        """Seqlock read of the latest slot → ``(batch, seq)``.

        Validity: the slot of publish #``seq`` is rewritten only while
        publish #``seq + nslots`` is in flight, during which the sequence
        word already reads ``seq + nslots - 1`` — so a slot image (copy
        *or* view) is consistent iff the post-read sequence is strictly
        below ``seq + nslots - 1``. An exactly-one-lap writer (post-read
        sequence ``== seq + nslots - 1``) may already be tearing the slot,
        hence the strict bound.

        Under a sustained fast writer every attempt can land inside the
        tear window; a tight retry loop then fails spuriously on a
        perfectly healthy topic. Retries therefore back off with a
        jittered micro-sleep (~1 µs doubling to ~1 ms) so the reader
        desynchronizes from the writer cadence and lands in a gap.
        """
        delay = 1e-6
        for attempt in range(_SHM_READ_RETRIES):
            if attempt:
                time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2.0, 1e-3)
            seq = st.read_seq()
            if st.read_dropped() or seq == 0:
                raise TopicDropped(f"no data published on topic {topic!r}")
            off = st.slot_offset(seq)
            dtype_b, ndim, _pad, s0, s1, s2, s3, nbytes = _SLOT_HDR.unpack_from(
                st.mm, off
            )
            start = off + _SLOT_HDR_SIZE
            payload: Any = (
                bytes(st.mm[start: start + nbytes]) if copy
                else memoryview(st.mm)[start: start + nbytes]
            )
            if st.read_seq() < seq + st.nslots - 1:
                shape = [s0, s1, s2, s3][:ndim]
                batch = _decode_batch(
                    {"dtype": dtype_b.rstrip(b"\x00").decode("ascii"),
                     "shape": shape},
                    payload,
                    copy=copy,
                )
                return batch, seq
        raise TransportError(
            f"topic {topic!r} ring lapped {_SHM_READ_RETRIES} reads in a row"
        )

    def fetch(self, topic: str, copy: bool = False) -> np.ndarray:
        """Latest batch; a **read-only view into the ring** unless
        ``copy=True``. A view stays bit-identical until the producer laps
        the ring (``nslots - 2`` further publishes with an in-flight
        writer; see :meth:`view_valid`)."""
        self.fetch_count += 1
        st = self._attach(topic)
        if st is None:
            raise TopicDropped(f"no data published on topic {topic!r}")
        return self._read_latest(st, topic, copy=copy)[0]

    def fetch_view(
        self, topic: str, min_seq: Optional[int] = None, timeout: float = 60.0
    ) -> Tuple[np.ndarray, int]:
        """Zero-copy fetch returning ``(view, seq)``.

        The sequence token feeds :meth:`view_valid`: a scheduler that
        consumed the view (e.g. fed it to a jitted step that may alias
        host buffers) revalidates after the fact and re-fetches with
        ``copy=True`` if the ring lapped mid-use. ``min_seq`` adds the
        :meth:`fetch_synced` producer wait before the read.
        """
        self.fetch_count += 1
        if min_seq is not None:
            st = self._await_seq(topic, min_seq, timeout)
        else:
            st = self._attach(topic)
            if st is None:
                raise TopicDropped(f"no data published on topic {topic!r}")
        return self._read_latest(st, topic, copy=False)

    def view_valid(self, topic: str, seq: int) -> bool:
        """Whether a view obtained at publish #``seq`` is still bit-valid
        (same strict one-lap bound as the seqlock read)."""
        st = self._attach(topic)
        if st is None or st.read_dropped():
            return False
        return st.read_seq() < seq + st.nslots - 1

    def _await_seq(self, topic: str, min_seq: int, timeout: float) -> _ShmTopic:
        """Spin (with backoff) until ``topic`` reaches ``min_seq``; returns
        the attached topic, ready for a seqlock read."""
        deadline = time.monotonic() + timeout
        delay = 0.0001
        seen = False
        while True:
            st = self._attach(topic)
            if st is not None:
                seen = True
                if st.read_dropped():
                    raise TopicDropped(f"topic {topic!r} dropped while awaited")
                if st.read_seq() >= min_seq:
                    return st
            elif seen:
                # the incarnation we were waiting on was dropped (file gone)
                raise TopicDropped(f"topic {topic!r} dropped while awaited")
            if time.monotonic() > deadline:  # pragma: no cover - defensive
                raise TransportTimeout(
                    f"topic {topic!r} never reached sequence {min_seq} within {timeout}s"
                )
            time.sleep(delay)
            delay = min(delay * 2, 0.002)

    def fetch_synced(
        self, topic: str, min_seq: int, timeout: float = 60.0, copy: bool = False
    ) -> np.ndarray:
        self.fetch_count += 1
        st = self._await_seq(topic, min_seq, timeout)
        return self._read_latest(st, topic, copy=copy)[0]

    def drop(self, topic: str) -> None:
        with self._flock() as lk:
            st = self._attach(topic)
            if st is None:
                return
            # fold the topic's cumulative totals into the graveyard, mark
            # dropped (wakes synced fetches in every attached process),
            # then unlink the incarnation
            meta = self._read_meta()
            meta["graveyard_bytes"] += int(st.u64[_BYTES_WORD])
            meta["graveyard_publishes"] += int(st.read_seq())
            self._write_meta(meta)
            st.u32[_DROPPED_WORD] = 1
            try:
                os.remove(st.path)
            except FileNotFoundError:  # pragma: no cover - concurrent drop
                pass
            with self._lock:
                if self._attached.get(topic) is st:
                    # park rather than close: blocked fetch_synced readers
                    # still hold this mapping and must observe the dropped
                    # flag (KeyError), not a closed-mmap ValueError
                    self._retired.append(st)
                    del self._attached[topic]

    # -- observability ---------------------------------------------------------
    def _live_topics(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        return [
            _filename_topic(n) for n in names
            if n.endswith(".topic") and ".tmp" not in n
        ]

    def seq(self, topic: str) -> int:
        st = self._attach(topic)
        return 0 if st is None or st.read_dropped() else st.read_seq()

    def sequences(self) -> Dict[str, int]:
        out = {}
        for topic in self._live_topics():
            s = self.seq(topic)
            if s > 0:
                out[topic] = s
        return out

    def has(self, topic: str) -> bool:
        return self.seq(topic) > 0

    def topics(self) -> Dict[str, Any]:
        out = {}
        for topic in self._live_topics():
            try:
                # private copies: checkpoint encoders may hold these past
                # further publishes (deferred background encode)
                out[topic] = self.fetch(topic, copy=True)
            except KeyError:
                continue
        return out

    def counters(self) -> Dict[str, int]:
        meta = self._read_meta()
        total_b = meta["graveyard_bytes"]
        total_p = meta["graveyard_publishes"]
        for topic in self._live_topics():
            st = self._attach(topic)
            if st is None:
                continue
            total_b += int(st.u64[_BYTES_WORD])
            total_p += int(st.read_seq())
        return {
            "bytes_published": total_b - meta["base_bytes"],
            "publishes": total_p - meta["base_publishes"],
        }

    @property
    def bytes_published(self) -> int:
        return self.counters()["bytes_published"]

    @property
    def publishes(self) -> int:
        return self.counters()["publishes"]

    def reset_counters(self) -> None:
        self.restore_counters(0, 0)

    def restore_counters(self, bytes_published: int, publishes: int) -> None:
        with self._flock() as lk:
            meta = self._read_meta()
            meta["base_bytes"] = 0
            meta["base_publishes"] = 0
            self._write_meta(meta)
            current = self.counters()
            meta["base_bytes"] = current["bytes_published"] - int(bytes_published)
            meta["base_publishes"] = current["publishes"] - int(publishes)
            self._write_meta(meta)

    def __len__(self) -> int:
        return len(self.sequences())

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            for st in self._attached.values():
                st.close()
            self._attached.clear()
            for st in self._retired:
                st.close()
            self._retired.clear()
        if self._owner:
            shutil.rmtree(self.dir, ignore_errors=True)

    def connect_info(self) -> Dict[str, Any]:
        return {
            "kind": "shm",
            "dir": self.dir,
            "slot_bytes": self.slot_bytes,
            "nslots": self.nslots,
        }

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


# -- tcp ------------------------------------------------------------------------

# Wire format (both directions): u32 header length | JSON header |
# u32 payload length | raw payload bytes. Batches travel as payload with
# dtype/shape in the header; everything else is header-only.
_U32 = struct.Struct("<I")


def _send_msg(sock: socket.socket, header: Dict[str, Any], payload: bytes = b"") -> None:
    hdr = json.dumps(header).encode("utf-8")
    sock.sendall(_U32.pack(len(hdr)) + hdr + _U32.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("transport peer closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> Tuple[Dict[str, Any], bytes]:
    hdr_len = _U32.unpack(_recv_exact(sock, 4))[0]
    header = json.loads(_recv_exact(sock, hdr_len).decode("utf-8"))
    payload_len = _U32.unpack(_recv_exact(sock, 4))[0]
    payload = _recv_exact(sock, payload_len) if payload_len else b""
    return header, payload


def _recv_msg_idle(sock: socket.socket) -> Optional[Tuple[Dict[str, Any], bytes]]:
    """Server-side :func:`_recv_msg` for sockets with a timeout set.

    Returns ``None`` on an *idle* timeout — no byte of a new message has
    arrived yet — so the handler loop can poll its shutdown flag instead of
    blocking in ``recv`` forever (the killed-client leak). A timeout once a
    message has started is a stalled/dead peer: framing sync is lost, so it
    raises :class:`ConnectionError` and the handler drops the connection.
    """
    try:
        first = sock.recv(1)
    except socket.timeout:
        return None
    if not first:
        raise ConnectionError("transport peer closed the connection")
    try:
        hdr_len = _U32.unpack(first + _recv_exact(sock, 3))[0]
        header = json.loads(_recv_exact(sock, hdr_len).decode("utf-8"))
        payload_len = _U32.unpack(_recv_exact(sock, 4))[0]
        payload = _recv_exact(sock, payload_len) if payload_len else b""
    except socket.timeout as e:
        raise ConnectionError("transport peer stalled mid-message") from e
    return header, payload


class TcpBrokerServer:
    """A broker reachable over TCP — one handler thread per connection,
    state in an inner :class:`~repro.runtime.broker.Broker` (so per-topic
    sequencing and drop-wake semantics are inherited verbatim).

    Shutdown hygiene: the listen socket is ``SO_REUSEADDR`` and every
    connection carries a ``conn_timeout`` idle poll, so a killed client
    cannot strand a handler thread in ``recv`` forever and a restarted
    server rebinds the same port immediately — ``close()`` also closes the
    tracked connections, which unblocks their handlers right away.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, conn_timeout: float = 5.0):
        self.broker = Broker()
        self.conn_timeout = conn_timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._closed = False
        self._conns: Set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="repro-tcp-broker", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._conns_lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.add(conn)
            # daemon handler threads reap themselves on disconnect — not
            # retained (a long-lived server would leak dead Thread objects)
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="repro-tcp-conn",
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(self.conn_timeout)
        try:
            while not self._closed:
                msg = _recv_msg_idle(conn)
                if msg is None:  # idle poll — re-check the shutdown flag
                    continue
                header, payload = msg
                try:
                    reply, out = self._handle(header, payload)
                except KeyError as e:
                    reply, out = {"key_error": str(e)}, b""
                except TimeoutError as e:  # pragma: no cover - defensive
                    reply, out = {"timeout_error": str(e)}, b""
                _send_msg(conn, reply, out)
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _handle(self, h: Dict[str, Any], payload: bytes) -> Tuple[Dict[str, Any], bytes]:
        op = h["op"]
        b = self.broker
        if op == "publish":
            b.publish(h["topic"], _decode_batch(h, payload))
            return {"ok": True}, b""
        if op in ("fetch", "fetch_synced"):
            batch = (
                b.fetch(h["topic"]) if op == "fetch"
                else b.fetch_synced(h["topic"], h["min_seq"], h.get("timeout", 60.0))
            )
            hdr, out = _encode_batch(batch)
            hdr["ok"] = True
            return hdr, out
        if op == "drop":
            b.drop(h["topic"])
            return {"ok": True}, b""
        if op == "seq":
            return {"value": b.seq(h["topic"])}, b""
        if op == "sequences":
            return {"value": b.sequences()}, b""
        if op == "has":
            return {"value": b.has(h["topic"])}, b""
        if op == "len":
            return {"value": len(b)}, b""
        if op == "topics":
            enc = {}
            for topic, batch in b.topics().items():
                hdr, out = _encode_batch(batch)
                hdr["data"] = base64.b64encode(out).decode("ascii")
                enc[topic] = hdr
            return {"value": enc}, b""
        if op == "counters":
            return {"value": {"bytes_published": b.bytes_published,
                              "publishes": b.publishes}}, b""
        if op == "reset_counters":
            b.reset_counters()
            return {"ok": True}, b""
        if op == "restore_counters":
            b.bytes_published = int(h["bytes_published"])
            b.publishes = int(h["publishes"])
            return {"ok": True}, b""
        if op == "ping":
            return {"ok": True}, b""
        raise ValueError(f"unknown transport op {op!r}")  # pragma: no cover

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # shutdown() before close(): close() alone doesn't wake a thread
        # blocked in accept() — the open file description (and the LISTEN
        # port) would survive until the next connection attempt.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
        # Actively close live connections so handler threads unblock now,
        # not one idle-timeout later.
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass
        # The port is only certainly rebindable once the accept thread has
        # let go of the listening file description.
        if self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=2.0)


class TcpTransport(Transport):
    """Length-prefixed socket transport against a :class:`TcpBrokerServer`.

    Connections are per-thread (``threading.local``): a blocked
    ``fetch_synced`` occupies only its own connection, so concurrent
    scheduler threads (and worker processes) never serialize on one
    socket. Constructing without an ``address`` starts an in-process
    server and connects to it — the single-host convenience mode; pass
    the address of a remote server to span hosts.
    """

    name = "tcp"

    def __init__(self, address: Optional[Tuple[str, int]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._server: Optional[TcpBrokerServer] = None
        if address is None:
            self._server = TcpBrokerServer(host=host, port=port)
            address = self._server.address
        self.address = (str(address[0]), int(address[1]))
        self._local = threading.local()
        self._closed = False

    def _conn(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.create_connection(self.address, timeout=120.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
        return sock

    def _call(self, header: Dict[str, Any], payload: bytes = b"",
              retry: bool = True) -> Tuple[Dict[str, Any], bytes]:
        sock = self._conn()
        try:
            _send_msg(sock, header, payload)
            reply, out = _recv_msg(sock)
        except (ConnectionError, OSError):
            self._local.sock = None
            if not retry:
                # non-idempotent ops (publish/drop/counter writes) must not
                # re-execute: the server may have applied the first attempt
                # before the connection died, and a double publish would
                # advance the topic sequence twice for one logical publish
                raise
            # one reconnect attempt (server restarts, idle timeouts)
            sock = self._conn()
            _send_msg(sock, header, payload)
            reply, out = _recv_msg(sock)
        if "key_error" in reply:
            raise TopicDropped(reply["key_error"])
        if "timeout_error" in reply:  # pragma: no cover - defensive
            raise TransportTimeout(reply["timeout_error"])
        return reply, out

    # -- data path -------------------------------------------------------------
    def publish(self, topic: str, batch: Any) -> None:
        header, payload = _encode_batch(batch)
        header.update(op="publish", topic=topic)
        self._call(header, payload, retry=False)

    def fetch(self, topic: str, copy: bool = False) -> np.ndarray:
        """Latest batch; a read-only ``frombuffer`` view over the receive
        buffer by default (the buffer is private to this call, so unlike
        shm views it can never go stale — ``copy=True`` only buys
        writability)."""
        self.fetch_count += 1
        reply, payload = self._call({"op": "fetch", "topic": topic})
        return _decode_batch(reply, payload, copy=copy)

    def fetch_synced(
        self, topic: str, min_seq: int, timeout: float = 60.0, copy: bool = False
    ) -> np.ndarray:
        self.fetch_count += 1
        reply, payload = self._call(
            {"op": "fetch_synced", "topic": topic, "min_seq": min_seq,
             "timeout": timeout}
        )
        return _decode_batch(reply, payload, copy=copy)

    def drop(self, topic: str) -> None:
        self._call({"op": "drop", "topic": topic}, retry=False)

    # -- observability ---------------------------------------------------------
    def seq(self, topic: str) -> int:
        return int(self._call({"op": "seq", "topic": topic})[0]["value"])

    def sequences(self) -> Dict[str, int]:
        return dict(self._call({"op": "sequences"})[0]["value"])

    def has(self, topic: str) -> bool:
        return bool(self._call({"op": "has", "topic": topic})[0]["value"])

    def topics(self) -> Dict[str, Any]:
        enc = self._call({"op": "topics"})[0]["value"]
        return {
            topic: _decode_batch(hdr, base64.b64decode(hdr["data"]))
            for topic, hdr in enc.items()
        }

    def counters(self) -> Dict[str, int]:
        return dict(self._call({"op": "counters"})[0]["value"])

    @property
    def bytes_published(self) -> int:
        return self.counters()["bytes_published"]

    @property
    def publishes(self) -> int:
        return self.counters()["publishes"]

    def reset_counters(self) -> None:
        self._call({"op": "reset_counters"}, retry=False)

    def restore_counters(self, bytes_published: int, publishes: int) -> None:
        self._call({"op": "restore_counters",
                    "bytes_published": int(bytes_published),
                    "publishes": int(publishes)}, retry=False)

    def __len__(self) -> int:
        return int(self._call({"op": "len"})[0]["value"])

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:  # pragma: no cover
                pass
        if self._server is not None:
            self._server.close()

    def connect_info(self) -> Dict[str, Any]:
        return {"kind": "tcp", "address": list(self.address)}


# -- registry -------------------------------------------------------------------

_TRANSPORTS: Dict[str, Type[Transport]] = {}


def register_transport(cls: Type[Transport]) -> Type[Transport]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"transport class {cls.__name__} has no name")
    if cls.name in _TRANSPORTS:
        raise ValueError(f"transport {cls.name!r} already registered")
    _TRANSPORTS[cls.name] = cls
    return cls


for _cls in (InProcTransport, ShmTransport, TcpTransport):
    register_transport(_cls)


def available_transports() -> List[str]:
    return sorted(_TRANSPORTS)


def resolve_transport(
    transport: Union[str, Transport, Type[Transport]], **kwargs: Any
) -> Transport:
    """Name / instance / class → transport instance (names hit the registry)."""
    if isinstance(transport, Transport):
        return transport
    if isinstance(transport, type) and issubclass(transport, Transport):
        return transport(**kwargs)
    if isinstance(transport, str):
        cls = _TRANSPORTS.get(transport)
        if cls is None:
            raise ValueError(
                f"unknown transport {transport!r} "
                f"(registered: {', '.join(available_transports())})"
            )
        return cls(**kwargs)
    raise TypeError(
        f"transport must be a name or Transport, got {type(transport).__name__}"
    )


def connect_transport(spec: Dict[str, Any]) -> Transport:
    """Rebuild a connected transport in another process from
    :meth:`Transport.connect_info` output."""
    kind = spec.get("kind")
    if kind == "shm":
        return ShmTransport(
            dir=spec["dir"], slot_bytes=spec.get("slot_bytes"),
            nslots=spec.get("nslots", _SHM_NSLOTS),
        )
    if kind == "tcp":
        return TcpTransport(address=tuple(spec["address"]))
    raise TransportError(f"cannot connect a transport from spec {spec!r}")
