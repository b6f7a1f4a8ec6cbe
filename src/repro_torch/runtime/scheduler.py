"""Wave scheduling — the part of ``repro.runtime.scheduler`` the port steps by.

The port's copy of the reference's wave / ready-queue scheduler, used by
concurrent stepping: :func:`compute_waves` partitions the segment
dependency DAG into topological levels (independent segments share a
wave) and :func:`run_ready_queue` dispatches segments to a thread pool the
moment their upstream segments finish, so independent segments step at
once and a straggler only delays its own consumers. On the card the
torch backend issues :func:`compute_waves`'s waves onto several CUDA
streams from the stepping thread instead
(:meth:`repro_torch.runtime.executor.TorchBackend._issue_waves`).

The reference's ``compute_chains`` and its placement policies belong to
the worker-process and sharded planes, which the port does not have yet.
"""
from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import AbstractSet, Callable, Dict, List, Mapping, Optional, Tuple


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
