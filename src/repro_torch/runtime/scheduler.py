"""Wave scheduling + placement policies + straggler policy — the Storm
scheduler analogue; the port's copy of ``repro.runtime.scheduler``.

Three layers of scheduling live here:

  * the **wave / ready-queue scheduler** used by concurrent stepping —
    :func:`compute_waves` partitions the segment dependency DAG into
    topological levels (independent segments share a wave) and
    :func:`run_ready_queue` dispatches segments to a thread pool the
    moment their upstream segments finish, so independent segments step
    at once and a straggler only delays its own consumers. On the card
    the torch backend issues :func:`compute_waves`'s waves onto several
    CUDA streams from the stepping thread instead
    (:meth:`repro_torch.runtime.executor.TorchBackend._issue_waves`);
    :func:`compute_chains` flattens the waves into one chain per worker
    process, the multiproc backend's one-command-per-worker-per-step
    dispatch;
  * :class:`PlacementPolicy` — the pluggable segment→slot assignment API
    of the backends that pin each segment to one slot of a pool (the
    multiproc backend's worker processes, :class:`PlacedBackendMixin`).
    Policies register by name, mirroring the strategy/backend registries,
    and may consult the straggler tracker's per-segment EWMA step-times
    (the ``ewma_aware`` policy closes the measurement→placement feedback
    loop: a flagged straggler moves to a cooler worker);
  * :func:`place_round_robin` — the paper's setup: each node runs one
    Worker JVM per core (8/node), up to 8 tasks per Worker without
    interference, and a Worker hosts tasks from only one topology
    (segment). Storm places tasks round-robin. This model converts a set
    of deployed segments into the node count a real cluster would need.

This module imports neither torch nor the backends.
"""
from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    AbstractSet,
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Tuple,
    Type,
    Union,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .backend import SegmentSpec

WORKERS_PER_NODE = 8
TASKS_PER_WORKER = 8


# -- wave / ready-queue scheduling (concurrent stepping) ------------------------


@dataclass(frozen=True)
class WaveEvent:
    """One wave of a step, delivered to ``on_wave`` observers.

    ``wave_ms`` is the wave's contribution to the step makespan: the *max*
    segment time in concurrent mode (segments overlap), the *sum* in sync
    mode (segments serialize).
    """

    step: int
    index: int
    segments: Tuple[str, ...]
    wave_ms: float


def _ordered(names, order: Optional[Mapping[str, int]]) -> List[str]:
    key = (order or {}).get
    return sorted(names, key=lambda n: (key(n, 0), n))


def compute_waves(
    deps: Mapping[str, AbstractSet[str]],
    order: Optional[Mapping[str, int]] = None,
) -> List[List[str]]:
    """Partition the segment dependency DAG into topological levels.

    ``deps`` maps segment → upstream segments (boundary-input producers).
    Segments in the same wave are mutually independent and may step
    concurrently; wave *k+1* reads only topics published by waves ≤ *k*.
    Within a wave, segments sort by ``order`` (launch sequence) so sync
    and concurrent stepping enumerate segments identically.
    """
    remaining = {n: len(ds) for n, ds in deps.items()}
    dependents: Dict[str, List[str]] = {n: [] for n in deps}
    for n, ds in deps.items():
        for d in ds:
            dependents[d].append(n)
    wave = _ordered([n for n, r in remaining.items() if r == 0], order)
    waves: List[List[str]] = []
    seen = 0
    while wave:
        waves.append(wave)
        seen += len(wave)
        nxt = []
        for n in wave:
            for m in dependents[n]:
                remaining[m] -= 1
                if remaining[m] == 0:
                    nxt.append(m)
        wave = _ordered(nxt, order)
    if seen < len(deps):
        stuck = sorted(n for n, r in remaining.items() if r > 0)
        raise ValueError(f"cycle in segment dependency graph: {stuck}")
    return waves


def compute_chains(
    deps: Mapping[str, AbstractSet[str]],
    assignment: Mapping[str, Any],
    order: Optional[Mapping[str, int]] = None,
) -> Tuple[Dict[Any, List[str]], Dict[str, int]]:
    """Flatten the dependency waves into one chain per execution slot.

    ``assignment`` maps segment → slot (worker id, device). Returns
    ``(chains, wave_of)``: each chain lists its slot's segments in global
    wave order (wave index, then launch order) — the order a worker must
    execute them so every intra-chain dependency is already satisfied when
    reached, and every cross-slot dependency points at an *earlier* wave.

    That ordering is what makes one-command-per-worker-per-step dispatch
    deadlock-free: consider the earliest (by wave, then order) entry
    blocked on a cross-slot producer. The producer sits in a strictly
    earlier wave, so every entry its slot must execute first is earlier
    still — by minimality none of them is blocked, so the producer's slot
    makes progress and eventually publishes. Inductively, all chains
    drain.
    """
    waves = compute_waves(deps, order=order)
    chains: Dict[Any, List[str]] = {}
    wave_of: Dict[str, int] = {}
    for i, wave in enumerate(waves):
        for name in wave:
            wave_of[name] = i
            chains.setdefault(assignment.get(name), []).append(name)
    return chains, wave_of


def run_ready_queue(
    deps: Mapping[str, AbstractSet[str]],
    runner: Callable[[str], float],
    max_workers: Optional[int] = None,
    order: Optional[Mapping[str, int]] = None,
    pool: Optional[ThreadPoolExecutor] = None,
    recover: Optional[Callable[[str, BaseException], bool]] = None,
    max_retries: int = 2,
) -> Dict[str, float]:
    """Dependency-aware concurrent dispatch over a thread pool.

    Every segment whose upstream segments have completed is dispatched
    immediately (no wave barrier — item-level readiness), so a straggler
    in one branch never delays independent branches. Returns the
    per-segment ``runner`` results (step wall-times in ms). The first
    runner exception is re-raised after in-flight work drains; no new
    segments are dispatched past an error.

    ``recover`` is the cluster plane's self-healing seam: when an item
    fails, ``recover(name, exc)`` may repair the fault (respawn the dead
    worker, redeploy its segments) and return ``True`` — the item is then
    **re-queued** instead of recorded as an error, at most ``max_retries``
    times per item. A declined or failed recovery falls through to the
    normal drain-and-raise path.

    Callers on a hot path pass a persistent ``pool`` (backends keep one
    across steps — pool spin-up costs more than a small step); without
    one a throwaway pool of ``max_workers`` is created and torn down.
    """
    names = list(deps)
    if not names:
        return {}
    remaining = {n: len(deps[n]) for n in names}
    dependents: Dict[str, List[str]] = {n: [] for n in names}
    for n, ds in deps.items():
        for d in ds:
            dependents[d].append(n)
    results: Dict[str, float] = {}
    errors: List[BaseException] = []
    retries: Dict[str, int] = {}
    owned = pool is None
    if pool is None:
        pool = ThreadPoolExecutor(max_workers=max_workers)
    try:
        futures = {
            pool.submit(runner, n): n
            for n in _ordered([n for n in names if remaining[n] == 0], order)
        }
        while futures:
            done, _ = wait(futures, return_when=FIRST_COMPLETED)
            newly: List[str] = []
            requeue: List[str] = []
            for fut in done:
                n = futures.pop(fut)
                try:
                    results[n] = fut.result()
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    recovered = False
                    if recover is not None and retries.get(n, 0) < max_retries:
                        try:
                            recovered = bool(recover(n, e))
                        except BaseException as re:  # noqa: BLE001
                            errors.append(re)
                            continue
                    if recovered:
                        retries[n] = retries.get(n, 0) + 1
                        requeue.append(n)
                    else:
                        errors.append(e)
                    continue
                for m in dependents[n]:
                    remaining[m] -= 1
                    if remaining[m] == 0:
                        newly.append(m)
            if errors:
                continue  # drain in-flight work, dispatch nothing new
            for m in _ordered(requeue + newly, order):
                futures[pool.submit(runner, m)] = m
    finally:
        if owned:
            pool.shutdown(wait=True)
    if errors:
        raise errors[0]
    if len(results) < len(names):
        stuck = sorted(n for n in names if n not in results)
        raise RuntimeError(f"cycle in segment dependency graph: {stuck}")
    return results


# -- segment → slot placement (multiproc workers) -------------------------------


class PlacementPolicy:
    """Assign each newly deployed segment to one of ``n_devices`` slots
    (worker processes on the multiproc backend).

    ``load`` maps device index → number of tasks currently placed there;
    policies may ignore it (round-robin) or balance on it (least-loaded).
    ``ewma`` maps device index → aggregate EWMA step-time (ms) attributed
    to each device — the straggler tracker's view of how slow each device
    actually is (live segment EWMAs plus a time-decaying residual left by
    migrated-away segments, so a device that just shed its straggler cools
    gradually instead of instantly reading cold). Static policies ignore
    it; the ``ewma_aware`` policy balances on it and migrates segments off
    slow devices via :meth:`redispatch`. ``hints`` carries restore-time
    context (see :class:`StickyPlacement`): backends pass it only to
    policies whose ``assign`` declares the keyword, so older custom
    policies keep working unchanged.
    """

    name: str = ""

    def assign(
        self,
        spec: "SegmentSpec",
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
        hints: Optional[Dict[str, Any]] = None,
    ) -> int:
        raise NotImplementedError

    def redispatch(
        self,
        spec: "SegmentSpec",
        current: int,
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
    ) -> int:
        """Pick a new device for a straggling segment (default: stay put)."""
        return current

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} {self.name!r}>"


_PLACEMENTS: Dict[str, Type[PlacementPolicy]] = {}


def register_placement(cls: Type[PlacementPolicy]) -> Type[PlacementPolicy]:
    if not cls.name:
        raise ValueError(f"placement class {cls.__name__} has no name")
    if cls.name in _PLACEMENTS:
        raise ValueError(f"placement policy {cls.name!r} already registered")
    _PLACEMENTS[cls.name] = cls
    return cls


def available_placements() -> List[str]:
    return sorted(_PLACEMENTS)


def resolve_placement(policy: Union[str, PlacementPolicy, Type[PlacementPolicy]]) -> PlacementPolicy:
    if isinstance(policy, PlacementPolicy):
        return policy
    if isinstance(policy, type) and issubclass(policy, PlacementPolicy):
        return policy()
    if isinstance(policy, str):
        cls = _PLACEMENTS.get(policy)
        if cls is None:
            raise ValueError(
                f"unknown placement {policy!r} (registered: {', '.join(available_placements())})"
            )
        return cls()
    raise TypeError(f"placement must be a name or PlacementPolicy, got {type(policy).__name__}")


@register_placement
class RoundRobinPlacement(PlacementPolicy):
    """Storm's scheme, lifted to device slots: segments cycle through the pool."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def assign(
        self,
        spec: "SegmentSpec",
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
        hints: Optional[Dict[str, Any]] = None,
    ) -> int:
        idx = self._next % n_devices
        self._next += 1
        return idx


@register_placement
class LeastLoadedPlacement(PlacementPolicy):
    """Greedy balance on deployed task count (paused tasks still occupy slots)."""

    name = "least_loaded"

    def assign(
        self,
        spec: "SegmentSpec",
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
        hints: Optional[Dict[str, Any]] = None,
    ) -> int:
        return min(range(n_devices), key=lambda i: (load.get(i, 0), i))


@register_placement
class EwmaAwarePlacement(PlacementPolicy):
    """Feedback placement: balance on *measured* per-device step-time EWMAs.

    Static policies see specs and task counts; this one consumes the
    straggler tracker's per-segment EWMA step-times aggregated per device
    (ROADMAP: backend-aware placement). New segments land on the device
    with the least observed work, and :meth:`redispatch` migrates a
    flagged straggler to the lightest *other* device — hot segments move
    off slow devices instead of being re-queued in place — but only when
    that device is *substantially* cooler (``improvement`` fraction of the
    source's pressure). Paired with the time-decaying device aggregates
    (a device that just shed a straggler stays warm for a few steps), the
    threshold is what damps ping-pong migrations: right after a
    migration the old device still reads hot, so an immediately re-flagged
    segment stays put instead of bouncing straight back.
    """

    name = "ewma_aware"

    def __init__(self, improvement: float = 0.5):
        if not 0.0 < improvement <= 1.0:
            raise ValueError(f"improvement must be in (0, 1], got {improvement}")
        self.improvement = improvement

    @staticmethod
    def _pressure(i: int, load: Dict[int, int], ewma: Optional[Dict[int, float]]):
        e = ewma or {}
        return (e.get(i, 0.0), load.get(i, 0), i)

    def assign(
        self,
        spec: "SegmentSpec",
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
        hints: Optional[Dict[str, Any]] = None,
    ) -> int:
        return min(range(n_devices), key=lambda i: self._pressure(i, load, ewma))

    def redispatch(
        self,
        spec: "SegmentSpec",
        current: int,
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
    ) -> int:
        if n_devices < 2:
            return current
        best = min(
            (i for i in range(n_devices) if i != current),
            key=lambda i: self._pressure(i, load, ewma),
        )
        e = ewma or {}
        cur_p = e.get(current, 0.0)
        if cur_p > 0.0 and e.get(best, 0.0) >= self.improvement * cur_p:
            return current  # destination barely cooler — migration won't pay
        return best


@register_placement
class StickyPlacement(PlacementPolicy):
    """Restore-time placement hints (ROADMAP): re-place each restored
    segment on the device it occupied *at checkpoint time* whenever the
    device pool still matches, preserving cache locality across restarts.

    The checkpointed map arrives through ``hints`` —
    ``checkpoint_device_of`` (segment → device index) and
    ``checkpoint_n_devices`` — which sharded/multiproc backends populate
    from the restored payload. Segments without a hint (new deployments,
    or a pool-size mismatch meaning the indices no longer name the same
    hardware) fall back to :class:`EwmaAwarePlacement`, as does straggler
    redispatch — stickiness pins the *starting* placement, it never traps
    a straggler.
    """

    name = "sticky"

    def __init__(self) -> None:
        self._fallback = EwmaAwarePlacement()

    def assign(
        self,
        spec: "SegmentSpec",
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
        hints: Optional[Dict[str, Any]] = None,
    ) -> int:
        h = hints or {}
        pinned = (h.get("checkpoint_device_of") or {}).get(spec.name)
        if (
            pinned is not None
            and h.get("checkpoint_n_devices") == n_devices
            and 0 <= int(pinned) < n_devices
        ):
            return int(pinned)
        return self._fallback.assign(spec, n_devices, load, ewma=ewma)

    def redispatch(
        self,
        spec: "SegmentSpec",
        current: int,
        n_devices: int,
        load: Dict[int, int],
        ewma: Optional[Dict[int, float]] = None,
    ) -> int:
        return self._fallback.redispatch(spec, current, n_devices, load, ewma=ewma)


# -- shared placement bookkeeping (multiproc workers) -------------------------------


class PlacedBackendMixin:
    """Placement bookkeeping for backends that pin each segment to one slot
    of a pool — worker processes on the multiproc backend. Mixed into an
    ``ExecutionBackend`` subclass;
    the concrete backend implements :meth:`_n_slots` (pool size) and
    :meth:`_move_segment` (the actual state migration) and calls
    :meth:`_init_placement` from its constructor.

    Provides the EWMA feedback loop:

      * ``device_ewma()`` — per-slot aggregate of live segment EWMAs *plus*
        a residual left behind by migrated-away segments that decays by
        ``ewma_decay`` per step toward 0 (ROADMAP "EWMA decay on idle
        devices"): a slot that just shed its straggler stays warm for a few
        steps instead of instantly reading cold, which — combined with
        :class:`EwmaAwarePlacement`'s improvement threshold — prevents
        ping-pong migrations under bursty load;
      * ``redispatch()`` — consults the policy with the flagged segment's
        own EWMA re-attributed to its current slot (the base tracker resets
        it first), migrates via :meth:`_move_segment` when the policy picks
        a different slot, and only then logs the move in ``redispatches``
        and credits the residual;
      * restore-time hints — ``device_of_at_checkpoint`` and the
        checkpointed pool size flow to policies that accept ``hints``
        (:class:`StickyPlacement`).
    """

    def _init_placement(
        self,
        policy: Union[str, "PlacementPolicy"],
        ewma_decay: float = 0.6,
    ) -> None:
        import inspect

        self.policy = resolve_placement(policy)
        self.device_of: Dict[str, int] = {}  # segment name -> slot index
        # checkpoint-time placement of the backend we restored from (if
        # any); informational unless the policy is hint-aware (sticky).
        self.device_of_at_checkpoint: Dict[str, int] = {}
        self._n_slots_at_checkpoint: Optional[int] = None
        if not 0.0 <= ewma_decay < 1.0:
            raise ValueError(f"ewma_decay must be in [0, 1), got {ewma_decay}")
        self.ewma_decay = ewma_decay
        self._ewma_residual: Dict[int, float] = {}
        # one-shot placement pins: {segment name -> slot}. The fusion
        # optimizer migrates a chain's members to one slot and pins the
        # fused replacement there, overriding the policy for that deploy.
        self._pin_slot: Dict[str, int] = {}
        # pass hints only to policies that declare the keyword, so custom
        # pre-hints PlacementPolicy subclasses keep working unchanged
        self._policy_takes_hints = (
            "hints" in inspect.signature(self.policy.assign).parameters
        )

    def _n_slots(self) -> int:
        raise NotImplementedError

    def _move_segment(self, seg: Any, old: int, new: int) -> None:
        raise NotImplementedError

    # -- aggregates ------------------------------------------------------------
    def device_load(self) -> Dict[int, int]:
        """Slot index → deployed task count (paused tasks occupy slots)."""
        load: Dict[int, int] = {}
        for name, seg in self.segments.items():
            idx = self.device_of[name]
            load[idx] = load.get(idx, 0) + len(seg.spec.task_ids)
        return load

    def device_ewma(self) -> Dict[int, float]:
        """Slot index → live segment EWMA sum + decaying migration residual."""
        ewma: Dict[int, float] = {
            idx: r for idx, r in self._ewma_residual.items() if r > 0.0
        }
        for name, ms in self.ewma_ms.items():
            idx = self.device_of.get(name)
            if idx is not None:
                ewma[idx] = ewma.get(idx, 0.0) + ms
        return ewma

    def _update_stragglers(self, seg_ms: Dict[str, float]) -> List[str]:
        # decay first: residuals cool one notch per step, then migrations
        # triggered by *this* step's flags credit fresh (undecayed) heat
        self._ewma_residual = {
            idx: r * self.ewma_decay
            for idx, r in self._ewma_residual.items()
            if r * self.ewma_decay > 1e-9
        }
        return super()._update_stragglers(seg_ms)

    # -- policy calls ----------------------------------------------------------
    def _assign_slot(self, spec: "SegmentSpec") -> int:
        pinned = self._pin_slot.pop(spec.name, None)
        if pinned is not None and 0 <= pinned < self._n_slots():
            self.device_of[spec.name] = pinned
            return pinned
        kwargs: Dict[str, Any] = {"ewma": self.device_ewma()}
        if self._policy_takes_hints:
            kwargs["hints"] = {
                "checkpoint_device_of": self.device_of_at_checkpoint,
                "checkpoint_n_devices": self._n_slots_at_checkpoint,
            }
        idx = self.policy.assign(spec, self._n_slots(), self.device_load(), **kwargs)
        self.device_of[spec.name] = idx
        return idx

    def kill(self, segment_name: str) -> None:
        super().kill(segment_name)
        self.device_of.pop(segment_name, None)

    def _straggler(self, segment_name: str) -> None:
        """A flagged straggler (the base tracker's hook): redispatch it."""
        self.redispatch(segment_name)

    def redispatch(self, segment_name: str) -> None:
        """Straggler mitigation with teeth: consult the placement policy for
        a new slot and migrate the segment's states there; a move is logged
        in ``redispatches``. Static policies keep the stay-put behavior via
        the default ``redispatch`` hook (the EWMA is reset all the same)."""
        seg_ew = self.ewma_ms.pop(segment_name, 0.0)  # judged afresh
        seg = self.segments.get(segment_name)
        current = self.device_of.get(segment_name)
        if seg is None or current is None:
            return
        # the flagged segment's own EWMA was just reset — re-attribute it to
        # its current slot so the policy sees the pressure behind the flag
        ewma = self.device_ewma()
        ewma[current] = ewma.get(current, 0.0) + seg_ew
        new = self.policy.redispatch(
            seg.spec, current, self._n_slots(), self.device_load(), ewma=ewma
        )
        if new != current and 0 <= new < self._n_slots():
            # migrations are rare control-plane events — worth a span and a
            # counter (getattr-guarded: the mixin contract doesn't require
            # the host backend to carry the telemetry plane)
            tracer = getattr(self, "tracer", None)
            if tracer is not None and tracer.enabled:
                with tracer.span("migrate", "control", segment=segment_name,
                                 src=current, dst=new, ewma_ms=round(seg_ew, 3)):
                    self._move_segment(seg, current, new)
            else:
                self._move_segment(seg, current, new)
            self.device_of[segment_name] = new
            self.redispatches.append((self.step_count, segment_name))
            metrics = getattr(self, "metrics", None)
            if metrics is not None:
                metrics.counter(
                    "repro_straggler_migrations_total",
                    "straggling segments migrated to another slot",
                ).inc()
            self._ewma_residual[current] = (
                self._ewma_residual.get(current, 0.0) + seg_ew
            )


@dataclass
class Placement:
    # segment -> list of (node, worker) slots, one per task
    assignments: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    nodes_used: int = 0
    workers_used: int = 0


def place_round_robin(segment_tasks: Dict[str, int]) -> Placement:
    """Round-robin placement honoring one-segment-per-worker.

    ``segment_tasks``: segment name -> number of deployed tasks (paused
    tasks still occupy slots — the paper's pause overhead in worker slots).
    """
    placement = Placement()
    next_worker = 0
    for name in sorted(segment_tasks):
        n = segment_tasks[name]
        slots: List[Tuple[int, int]] = []
        remaining = n
        while remaining > 0:
            batch = min(remaining, TASKS_PER_WORKER)
            node, worker = divmod(next_worker, WORKERS_PER_NODE)
            slots.extend((node, worker) for _ in range(batch))
            next_worker += 1
            remaining -= batch
        placement.assignments[name] = slots
    placement.workers_used = next_worker
    placement.nodes_used = (next_worker + WORKERS_PER_NODE - 1) // WORKERS_PER_NODE
    return placement


@dataclass
class StragglerEvent:
    step: int
    segment: str
    ewma_ms: float
    median_ms: float


class StragglerPolicy:
    """k·median EWMA policy (pure, unit-testable).

    The Executor embeds the same logic; this standalone class is used by the
    scheduler tests and by the simulated 1000-node run in the benchmarks.
    """

    def __init__(self, factor: float = 3.0, alpha: float = 0.3):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, timings_ms: Dict[str, float]) -> List[str]:
        for name, ms in timings_ms.items():
            prev = self.ewma.get(name)
            self.ewma[name] = ms if prev is None else self.alpha * ms + (1 - self.alpha) * prev
        for name in list(self.ewma):
            if name not in timings_ms:
                del self.ewma[name]
        if len(self.ewma) < 2:
            return []
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        flagged = [
            name
            for name, ew in self.ewma.items()
            if median > 0 and ew > self.factor * median
        ]
        for name in flagged:
            self.events.append(StragglerEvent(step, name, self.ewma[name], median))
            # re-dispatch: relocated segment is judged afresh
            del self.ewma[name]
        return flagged
