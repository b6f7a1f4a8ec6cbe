"""Process-local metrics: counters, gauges, histograms — mergeable, no deps.

The telemetry model is deliberately small and Prometheus-shaped:

  * :class:`Counter` — monotonically increasing float (``inc``); resets
    only with the process.
  * :class:`Gauge` — last-written float (``set``/``inc``/``dec``).
  * :class:`Histogram` — fixed-bucket cumulative histogram (``observe``),
    the only shape that merges exactly across processes.

Every instrument supports labels (``counter.inc(1, op="step")``) with the
usual low-cardinality caveat. Instruments live in a
:class:`MetricsRegistry`; registries serialize to plain-JSON
:meth:`~MetricsRegistry.snapshot` dicts and merge with
:meth:`~MetricsRegistry.merge_snapshot` — which is how multiproc workers
ship their process-local registries to the coordinator over the
``metrics`` RPC (same pattern as ``cache_stats``) and the coordinator
aggregates them: counters and histograms add, gauges add too (worker
gauges are per-process quantities like queue depths, so the pool-wide
value is the sum).

``render_prometheus`` hand-rolls the text exposition format (no client
library), and ``parse_prometheus`` is the tiny inverse used by tests and
the CI scrape smoke. This module must stay free of JAX imports — the
dry-run coordinator and the serving front end are JAX-free.
"""
from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "DEFAULT_MS_BUCKETS",
    "merge_snapshots",
    "parse_prometheus",
    "process_metrics",
    "render_prometheus",
]

# Wall-time buckets in milliseconds — spans µs-scale dispatch overhead up
# to multi-second checkpoint fsyncs.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    if not labels:  # the hot path's instruments carry no labels
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared label-keyed storage; subclasses define the write verbs."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._values: Dict[_LabelKey, Any] = {}

    def labelsets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k) for k in self._values]

    def value(self, **labels: Any) -> float:
        """Current scalar for one labelset (0.0 when never written)."""
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def set_total(self, total: float, **labels: Any) -> None:
        """Mirror an externally-tracked monotonic total (e.g. transport
        ``counters()``); clamps to never decrease so restores/rebinds
        can't violate counter semantics."""
        key = _label_key(labels)
        with self._lock:
            self._values[key] = max(self._values.get(key, 0.0), float(total))


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        lock: threading.Lock,
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(name, help, lock)
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_MS_BUCKETS)))
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bounds  # upper bounds; +Inf bucket is implicit

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        value = float(value)
        with self._lock:
            cell = self._values.get(key)
            if cell is None:
                cell = self._values[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            # the first bucket whose bound is >= value, else (NaN too) +Inf
            i = bisect_left(self.buckets, value) if value == value else len(self.buckets)
            cell["counts"][i] += 1
            cell["sum"] += value
            cell["count"] += 1

    def value(self, **labels: Any) -> float:
        """Observation count for one labelset (histograms have no scalar)."""
        with self._lock:
            cell = self._values.get(_label_key(labels))
            return float(cell["count"]) if cell else 0.0


class MetricsRegistry:
    """A named family of instruments with get-or-create semantics.

    ``counter``/``gauge``/``histogram`` are idempotent: the first call
    mints the instrument, later calls return it (kind mismatches raise).
    ``add_collector`` registers a callback run at every
    :meth:`snapshot` — the hook that mirrors externally-owned values
    (transport byte counters, compile-cache stats, tenant ledgers) into
    gauges right before export, so scrapes are always coherent without
    putting bookkeeping on the hot path.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._collectors: List[Callable[[], None]] = []

    # -- minting ------------------------------------------------------------------
    def _get(self, cls, name: str, help: str, **kwargs: Any) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, self._lock, **kwargs)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    # -- export -------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Plain-JSON dump of every instrument (collectors run first)."""
        for fn in list(self._collectors):
            try:
                fn()
            except Exception:  # a dying collector must never kill a scrape
                pass
        out: Dict[str, Any] = {}
        with self._lock:
            for name, inst in sorted(self._instruments.items()):
                entry: Dict[str, Any] = {
                    "kind": inst.kind,
                    "help": inst.help,
                    "values": [
                        [dict(k), v if inst.kind != "histogram" else dict(
                            counts=list(v["counts"]), sum=v["sum"], count=v["count"])]
                        for k, v in inst._values.items()
                    ],
                }
                if inst.kind == "histogram":
                    entry["buckets"] = list(inst.buckets)
                out[name] = entry
        return out

    def merge_snapshot(self, snap: Dict[str, Any]) -> None:
        """Fold a foreign snapshot into this registry (counters/gauges/
        histogram cells add; histogram bucket layouts must match)."""
        for name, entry in snap.items():
            kind = entry.get("kind")
            if kind == "counter":
                inst: Any = self.counter(name, entry.get("help", ""))
            elif kind == "gauge":
                inst = self.gauge(name, entry.get("help", ""))
            elif kind == "histogram":
                inst = self.histogram(
                    name, entry.get("help", ""), buckets=entry.get("buckets")
                )
            else:
                continue
            for labels, value in entry.get("values", []):
                key = _label_key(labels)
                with self._lock:
                    if kind == "histogram":
                        cell = inst._values.get(key)
                        if cell is None:
                            cell = inst._values[key] = {
                                "counts": [0] * (len(inst.buckets) + 1),
                                "sum": 0.0,
                                "count": 0,
                            }
                        counts = value.get("counts", [])
                        if len(counts) == len(cell["counts"]):
                            cell["counts"] = [
                                a + b for a, b in zip(cell["counts"], counts)
                            ]
                        cell["sum"] += float(value.get("sum", 0.0))
                        cell["count"] += int(value.get("count", 0))
                    else:
                        inst._values[key] = inst._values.get(key, 0.0) + float(value)


def merge_snapshots(snaps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge snapshot dicts into one aggregated snapshot."""
    acc = MetricsRegistry()
    for snap in snaps:
        if snap:
            acc.merge_snapshot(snap)
    return acc.snapshot()


# -- no-op twin -------------------------------------------------------------------


class _NullInstrument:
    """Accepts every write verb and does nothing — the obs-off fast path."""

    def inc(self, *a: Any, **k: Any) -> None: ...
    def dec(self, *a: Any, **k: Any) -> None: ...
    def set(self, *a: Any, **k: Any) -> None: ...
    def set_total(self, *a: Any, **k: Any) -> None: ...
    def observe(self, *a: Any, **k: Any) -> None: ...
    def value(self, **labels: Any) -> float:
        return 0.0
    def labelsets(self) -> List[Dict[str, str]]:
        return []


class NullRegistry(MetricsRegistry):
    """Registry that mints no-op instruments; ``snapshot()`` is empty.

    Installed when a backend is built with ``obs=False`` so the overhead
    benchmark has an honest baseline."""

    _NULL = _NullInstrument()

    def counter(self, name: str, help: str = "") -> Any:  # type: ignore[override]
        return self._NULL

    def gauge(self, name: str, help: str = "") -> Any:  # type: ignore[override]
        return self._NULL

    def histogram(self, name: str, help: str = "", buckets: Any = None) -> Any:  # type: ignore[override]
        return self._NULL

    def add_collector(self, fn: Callable[[], None]) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {}


NULL_REGISTRY = NullRegistry()


# -- Prometheus text exposition ---------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = []
    for k, v in sorted(labels.items()):
        escaped = str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{_prom_name(k)}="{escaped}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _prom_num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(snapshot: Dict[str, Any]) -> str:
    """Prometheus text exposition (format version 0.0.4) of a snapshot."""
    lines: List[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        kind, pname = entry.get("kind", "untyped"), _prom_name(name)
        help_text = str(entry.get("help", "")).replace("\\", r"\\").replace("\n", r"\n")
        if help_text:
            lines.append(f"# HELP {pname} {help_text}")
        lines.append(f"# TYPE {pname} {kind}")
        for labels, value in entry.get("values", []):
            if kind == "histogram":
                acc = 0
                for bound, n in zip(
                    list(entry["buckets"]) + [float("inf")], value["counts"]
                ):
                    acc += n
                    le = _prom_labels(labels, f'le="{_prom_num(bound)}"')
                    lines.append(f"{pname}_bucket{le} {acc}")
                lines.append(f"{pname}_sum{_prom_labels(labels)} {_prom_num(value['sum'])}")
                lines.append(f"{pname}_count{_prom_labels(labels)} {value['count']}")
            else:
                lines.append(f"{pname}{_prom_labels(labels)} {_prom_num(value)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+\d+)?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Tiny inverse of :func:`render_prometheus` for tests and CI smokes.

    Returns ``{sample_name: [(labels, value), ...]}`` (histogram series
    appear under their ``_bucket``/``_sum``/``_count`` sample names).
    Raises ``ValueError`` on any line that is neither a comment nor a
    well-formed sample — which is what makes it a format validator.
    """
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line {lineno}: {line!r}")
        name, labelstr, raw = m.groups()
        labels = {
            k: v.replace(r"\"", '"').replace(r"\n", "\n").replace(r"\\", "\\")
            for k, v in _LABEL_RE.findall(labelstr or "")
        }
        try:
            value = float(raw.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(f"bad sample value on line {lineno}: {raw!r}") from None
        out.setdefault(name, []).append((labels, value))
    return out


# -- per-process singleton --------------------------------------------------------

_process_registry: Optional[MetricsRegistry] = None
_process_lock = threading.Lock()


def process_metrics() -> MetricsRegistry:
    """The per-process registry multiproc *workers* write into; the
    coordinator pulls it over the ``metrics`` RPC and merges. Coordinator-
    side components use their owner's registry instead, so tests running
    many systems in one process don't cross-contaminate."""
    global _process_registry
    with _process_lock:
        if _process_registry is None:
            _process_registry = MetricsRegistry()
        return _process_registry
