"""Durable data-plane checkpoints — versioned, atomic, torn-write tolerant.

The port's copy of ``repro.runtime.checkpoint``, with the same envelope,
format version and payload layout, so a checkpoint that one package writes
loads in the other. The ReuseManager journal already makes the *control
plane* durable: replay reconstructs 𝔻/𝔻̄/Δ/Φ byte-identically. This module
adds the data plane half. A checkpoint is one JSON file holding

  * the control-plane operation journal (so restore can replay it), and
  * the backend's :meth:`~repro_torch.runtime.backend.ExecutionBackend.dump_state`
    payload — deployed segment specs, task ⟨type, config⟩ definitions,
    per-task state pytrees, forwarding/pause flags and broker buffers —

wrapped in an integrity envelope (format version, monotonic checkpoint id,
sha256 of the canonical payload). Crash consistency comes from three
mechanics:

  * **atomic write** — serialize to ``<file>.tmp`` in the same directory,
    fsync, then :func:`os.replace` onto the final name, so a checkpoint is
    either fully present or absent;
  * **monotonic ids** — files are named ``ckpt-<id>.json`` with ids that
    only grow (corrupt files still advance the counter, so a re-written
    checkpoint never reuses a torn file's id);
  * **torn-last tolerance** — :meth:`CheckpointStore.latest` walks ids
    newest-first and returns the first envelope that parses, carries a
    supported format version and matches its sha256, so a crash mid-write
    falls back to the previous durable checkpoint instead of failing.

Array leaves in task-state pytrees — numpy arrays and torch tensors, on the
card or not — are encoded as base64-packed bytes with dtype/shape, which
round-trips states bit-exactly. The device is not in the payload: a
checkpoint taken on the card restores on the CPU, and the other way round.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import queue
import re
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# Format history (see README "Crash recovery" for the compatibility table):
#   1 — initial format: envelope {checkpoint_format, checkpoint_id,
#       created_at, sha256, payload}; payload {backend, strategy, journal,
#       base_batch, seg_counter, task_batch, segments_of, checkpoint_every,
#       data:{step_count, launch_seq, paused, ewma_ms, redispatches,
#       segments:[...], extra:{...}}}.
CHECKPOINT_FORMAT_VERSION = 1
SUPPORTED_FORMATS = {1}

_CKPT_RE = re.compile(r"^ckpt-(\d{8})\.json$")


class CheckpointError(ValueError):
    """A checkpoint file is missing, torn, or of an unsupported format."""


class UnsupportedFormatError(CheckpointError):
    """A structurally intact checkpoint written in a format this binary
    does not speak (version skew). Restore skips it like any other
    CheckpointError, but retention must never reap it — a newer/older
    binary sharing the directory can still restore from it."""


# -- pytree codec ---------------------------------------------------------------


def encode_pytree(x: Any) -> Any:
    """JSON-safe encoding of a task-state pytree.

    Scalars pass through; dict/tuple/list nodes are tagged so decode can
    rebuild the exact container types; torch tensors (copied to the host)
    and other array-likes become base64 bytes + dtype + shape, which is
    bit-exact. A bfloat16 tensor has no numpy dtype and raises
    :class:`CheckpointError` rather than being cast.
    """
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {"__kind__": "dict", "items": {k: encode_pytree(v) for k, v in x.items()}}
    if isinstance(x, tuple):
        return {"__kind__": "tuple", "items": [encode_pytree(v) for v in x]}
    if isinstance(x, list):
        return {"__kind__": "list", "items": [encode_pytree(v) for v in x]}
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise CheckpointError("cannot checkpoint a bfloat16 tensor: numpy has no bfloat16")
        # card → host; contiguous() keeps a 0-d tensor 0-d
        x = x.detach().to("cpu").contiguous().numpy()
    if hasattr(x, "dtype") and hasattr(x, "shape"):
        # order="C" (not ascontiguousarray, which promotes 0-d scalars to
        # shape (1,)) for stable tobytes()
        arr = np.asarray(x, order="C")
        return {
            "__kind__": "ndarray",
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode("ascii"),
        }
    raise TypeError(f"cannot checkpoint state leaf of type {type(x).__name__}")


def decode_pytree(x: Any) -> Any:
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        kind = x.get("__kind__")
        if kind == "dict":
            return {k: decode_pytree(v) for k, v in x["items"].items()}
        if kind == "tuple":
            return tuple(decode_pytree(v) for v in x["items"])
        if kind == "list":
            return [decode_pytree(v) for v in x["items"]]
        if kind == "ndarray":
            arr = np.frombuffer(
                base64.b64decode(x["data"]), dtype=np.dtype(x["dtype"])
            ).reshape(x["shape"])
            return arr.copy()  # frombuffer views are read-only
        raise CheckpointError(f"unknown pytree node kind {kind!r}")
    raise CheckpointError(f"cannot decode state node of type {type(x).__name__}")


class DeferredState:
    """A state pytree captured but not yet encoded.

    The background checkpointer snapshots on the stepping thread by
    wrapping each segment's state values in this marker — a reference
    capture, safe because a backend either replaces its state pytrees
    wholesale every step or, where it writes them in place (the torch
    backend on the card), wraps a copy — and the writer thread later
    materializes them with :func:`encode_deferred`. ``ready`` (a CUDA
    event recorded on the stepping stream at capture, or ``None``) orders
    the writer's copy to the host after the step that produced the values.
    """

    __slots__ = ("value", "ready")

    def __init__(self, value: Any, ready: Any = None):
        self.value = value
        self.ready = ready


def deferred_encoder(value: Any, ready: Any = None) -> DeferredState:
    """State encoder for snapshot-only dumps (see ``dump_state``); a
    backend on the card binds ``ready`` to an event on its stepping stream."""
    return DeferredState(value, ready)


def encode_deferred(obj: Any) -> Any:
    """Materialize every :class:`DeferredState` marker in a payload —
    the writer-thread half of background checkpointing."""
    if isinstance(obj, DeferredState):
        if obj.ready is not None:
            obj.ready.synchronize()
        return encode_pytree(obj.value)
    if isinstance(obj, dict):
        return {k: encode_deferred(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [encode_deferred(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(encode_deferred(v) for v in obj)
    return obj


def _canonical_json(payload: Dict[str, Any]) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def payload_digest(payload: Dict[str, Any]) -> str:
    return hashlib.sha256(_canonical_json(payload).encode("utf-8")).hexdigest()


# -- the on-disk store ----------------------------------------------------------


class CheckpointStore:
    """A directory of versioned checkpoints with atomic, monotonic writes.

    ``keep_last=N`` turns on retention: after every :meth:`save` the store
    prunes down to the newest N *valid* checkpoints (the newest valid one
    is never pruned — N must be ≥ 1) and reaps torn/corrupt files, which
    can never be restored anyway. Intact checkpoints in an *unsupported
    format* (version skew) are never reaped — see :meth:`prune`. Without
    ``keep_last`` the store only ever appends (long-lived sessions should
    set it).
    """

    def __init__(self, root: str, keep_last: Optional[int] = None):
        if keep_last is not None and keep_last < 1:
            raise ValueError(
                f"keep_last must be >= 1 (the newest valid checkpoint "
                f"is never pruned), got {keep_last}"
            )
        self.root = str(root)
        self.keep_last = keep_last
        # ids whose files this instance already validated end-to-end —
        # checkpoint files are immutable once renamed into place, so prune
        # never has to re-read them (retention stays O(1) per save).
        self._validated_ids: set = set()
        # Telemetry plane (repro_torch.obs), wired by the owning
        # StreamSystem. Instrumentation lives in the store — not the
        # system — so the background writer thread's saves are traced and
        # counted identically to synchronous ones.
        self.tracer: Optional[Any] = None
        self.metrics: Optional[Any] = None

    def _span(self, name: str, **args: Any):
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            return tracer.span(name, "checkpoint", **args)
        return nullcontext()

    # -- naming ---------------------------------------------------------------
    @staticmethod
    def filename(checkpoint_id: int) -> str:
        return f"ckpt-{checkpoint_id:08d}.json"

    def path_of(self, checkpoint_id: int) -> str:
        return os.path.join(self.root, self.filename(checkpoint_id))

    def list_ids(self) -> List[int]:
        """All checkpoint ids present on disk (valid or torn), ascending."""
        if not os.path.isdir(self.root):
            return []
        ids = []
        for name in os.listdir(self.root):
            m = _CKPT_RE.match(name)
            if m:
                ids.append(int(m.group(1)))
        return sorted(ids)

    # -- write ----------------------------------------------------------------
    def save(self, payload: Dict[str, Any]) -> str:
        """Write the next checkpoint atomically; returns its path.

        The id is one past the highest id on disk — torn files included, so
        a checkpoint that failed mid-write is never overwritten in place.
        """
        t0 = time.perf_counter()
        os.makedirs(self.root, exist_ok=True)
        ids = self.list_ids()
        checkpoint_id = (ids[-1] + 1) if ids else 1
        # Serialize the payload exactly once: the canonical string is both
        # the digest input and the bytes written (load() re-canonicalizes
        # the parsed payload, which reproduces this string — sorted keys).
        with self._span("ckpt_encode", checkpoint_id=checkpoint_id):
            payload_json = _canonical_json(payload)
        header = json.dumps(
            {
                "checkpoint_format": CHECKPOINT_FORMAT_VERSION,
                "checkpoint_id": checkpoint_id,
                "created_at": time.time(),
                "sha256": hashlib.sha256(payload_json.encode("utf-8")).hexdigest(),
            }
        )
        final = self.path_of(checkpoint_id)
        tmp = final + ".tmp"
        with self._span("ckpt_fsync", checkpoint_id=checkpoint_id, bytes=len(payload_json)):
            with open(tmp, "w") as f:
                f.write(header[:-1] + ', "payload": ' + payload_json + "}")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        try:  # best-effort directory fsync so the rename itself is durable
            dirfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:  # pragma: no cover - platform-dependent
            pass
        self._validated_ids.add(checkpoint_id)  # valid by construction
        metrics = self.metrics
        if metrics is not None:
            metrics.counter("repro_checkpoints_total", "durable checkpoints written").inc()
            metrics.histogram(
                "repro_checkpoint_save_ms",
                "end-to-end checkpoint save time: encode + fsync + rename (ms)",
            ).observe((time.perf_counter() - t0) * 1e3)
        if self.keep_last is not None:
            self.prune()
        return final

    # -- retention ------------------------------------------------------------
    def prune(self, keep_last: Optional[int] = None) -> List[str]:
        """Apply the retention policy; returns the paths removed.

        Torn/corrupt files are always reaped (they can never be restored,
        and their ids were already consumed — a later save never reuses
        them while they exist). Unsupported-*format* files are left alone:
        they are intact checkpoints from a different software version, and
        a binary that speaks that format can still restore them. Valid
        checkpoints keep the newest ``keep_last`` (defaults to the store's
        policy; ``None`` with no store policy reaps torn files only). The
        newest valid checkpoint is never pruned.

        Checkpoint files are immutable once renamed into place, so each
        file is fully validated at most once per store instance — steady
        state is one validation per prune (the newly saved checkpoint),
        not a re-read of the whole directory.
        """
        keep = keep_last if keep_last is not None else self.keep_last
        if keep is not None and keep < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep}")
        valid: List[int] = []
        removed: List[str] = []
        for checkpoint_id in self.list_ids():
            if checkpoint_id in self._validated_ids:
                valid.append(checkpoint_id)
                continue
            try:
                self.load(checkpoint_id)
            except UnsupportedFormatError:
                continue  # version skew: not ours to restore, not ours to reap
            except CheckpointError:
                path = self.path_of(checkpoint_id)
                try:
                    os.remove(path)
                    removed.append(path)
                except OSError:  # pragma: no cover - concurrent reaper
                    pass
            else:
                self._validated_ids.add(checkpoint_id)
                valid.append(checkpoint_id)
        if keep is not None:
            for checkpoint_id in valid[:-keep]:
                path = self.path_of(checkpoint_id)
                try:
                    os.remove(path)
                except OSError:  # pragma: no cover - concurrent reaper
                    pass
                else:
                    removed.append(path)
                    self._validated_ids.discard(checkpoint_id)
        return removed

    # -- read -----------------------------------------------------------------
    def load(self, path_or_id: Any) -> Dict[str, Any]:
        """Load + validate one checkpoint envelope (raises CheckpointError)."""
        path = self.path_of(path_or_id) if isinstance(path_or_id, int) else str(path_or_id)
        try:
            with open(path) as f:
                envelope = json.load(f)
        except FileNotFoundError:
            raise CheckpointError(f"checkpoint {path!r} does not exist")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointError(f"checkpoint {path!r} is torn or not JSON: {e}")
        if not isinstance(envelope, dict) or "payload" not in envelope:
            raise CheckpointError(f"checkpoint {path!r} has no payload envelope")
        fmt = envelope.get("checkpoint_format")
        if fmt not in SUPPORTED_FORMATS:
            raise UnsupportedFormatError(
                f"checkpoint {path!r} has unsupported format {fmt!r} "
                f"(supported: {sorted(SUPPORTED_FORMATS)})"
            )
        digest = payload_digest(envelope["payload"])
        if digest != envelope.get("sha256"):
            raise CheckpointError(f"checkpoint {path!r} failed its sha256 integrity check")
        return envelope

    def latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Newest *valid* checkpoint as ``(id, envelope)``.

        Walks ids newest-first, skipping torn/corrupt/unsupported files —
        the crash-consistency contract: a crash mid-``save`` loses at most
        the checkpoint being written.
        """
        for checkpoint_id in reversed(self.list_ids()):
            try:
                return checkpoint_id, self.load(checkpoint_id)
            except CheckpointError:
                continue
        return None

    def latest_payload(self) -> Dict[str, Any]:
        found = self.latest()
        if found is None:
            raise CheckpointError(f"no valid checkpoint under {self.root!r}")
        return found[1]["payload"]


class BackgroundCheckpointWriter:
    """Single writer thread turning snapshot payloads into durable files.

    With ``checkpoint_every=1`` on the synchronous path every step pays
    the full encode + fsync + rename; this writer moves that off the
    stepping thread — the stepping side only captures references
    (:func:`deferred_encoder`), the writer encodes and saves in
    submission order through the same :meth:`CheckpointStore.save`, so
    atomicity / monotonic-id / torn-write semantics are unchanged. A
    crash loses at most the checkpoints still queued — exactly the
    window a slower synchronous cadence would never have written at all.

    Writer-thread failures surface on the next :meth:`submit` /
    :meth:`flush` (the stepping thread never blocks on them mid-step).
    """

    def __init__(self, store: CheckpointStore):
        self.store = store
        self._queue: "queue.Queue[Optional[Dict[str, Any]]]" = queue.Queue()
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="repro-ckpt-writer", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self.store.save(encode_deferred(item))
            except BaseException as e:  # noqa: BLE001 - reported on flush
                with self._lock:
                    self._errors.append(e)
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            if self._errors:
                err = self._errors[:]
                self._errors.clear()
                raise CheckpointError(
                    f"background checkpoint write failed: {err[0]!r}"
                ) from err[0]

    def submit(self, payload: Dict[str, Any]) -> None:
        """Queue one snapshot payload for durable write (non-blocking)."""
        if self._closed:
            raise CheckpointError("checkpoint writer is closed")
        self._raise_pending()
        self._ensure_thread()
        self._queue.put(payload)

    def flush(self) -> None:
        """Block until every queued checkpoint is durably on disk."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread is not None and self._thread.is_alive():
            self._queue.join()
            self._queue.put(None)
            self._thread.join(timeout=30)
        self._raise_pending()


def is_checkpoint_path(path: str) -> bool:
    """True if ``path`` names a checkpoint directory or a single checkpoint
    file — used by ``ReuseSession.restore`` to dispatch between full-system
    restore and the control-plane journal restore."""
    if os.path.isdir(path):
        return True
    if _CKPT_RE.match(os.path.basename(path)):
        return True
    if os.path.isfile(path):
        try:
            with open(path) as f:
                head = f.read(512).lstrip()
            return head.startswith("{") and '"checkpoint_format"' in head
        except OSError:
            return False
    return False
