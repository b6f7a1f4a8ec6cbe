"""EWMA-driven autoscaling of the multiproc worker pool.

The port's copy of ``repro.cluster.autoscaler``; the decisions are the
reference's.

The straggler tracker already aggregates per-worker EWMA step-times
(``device_ewma()``) to drive ``ewma_aware`` migration; the autoscaler
reads the *same* pressure signal to resize the pool itself. Pressure is
the mean per-worker aggregate EWMA — "milliseconds of segment compute
each worker carries per step". Sustained pressure above ``high_ms``
grows the pool, sustained idling below ``low_ms`` shrinks it, with
hysteresis (``patience`` consecutive observations) and a ``cooldown``
between actions so migration churn from one resize never triggers the
next.

:class:`AutoscalePolicy` is the pure decision function (unit-testable,
no backend); :class:`Autoscaler` binds it to a backend and feeds it one
observation per step (``StreamSystem`` calls :meth:`Autoscaler.observe`
after every ``step()`` when ``autoscale=`` is on).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .events import SCALE_DOWN, SCALE_UP


@dataclass
class AutoscalePolicy:
    """Hysteresis-banded threshold policy over per-worker pressure.

    ``decide`` returns the target pool size — equal to ``n_workers``
    when no action is warranted. Scaling steps by one worker at a time:
    resize migrates state, so conservative moves keep churn bounded and
    let the next observations confirm the trend before moving again."""

    min_workers: int = 1
    max_workers: int = 4
    high_ms: float = 50.0   # grow when mean per-worker pressure exceeds this
    low_ms: float = 5.0     # shrink when it stays below this
    patience: int = 3       # consecutive observations before acting
    cooldown: int = 5       # observations to ignore after an action
    _high_streak: int = field(default=0, repr=False)
    _low_streak: int = field(default=0, repr=False)
    _cooling: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if self.low_ms >= self.high_ms:
            raise ValueError("low_ms must be < high_ms (hysteresis band)")

    def decide(self, pressure_ms: float, n_workers: int) -> int:
        if self._cooling > 0:
            self._cooling -= 1
            return n_workers
        if pressure_ms > self.high_ms:
            self._high_streak += 1
            self._low_streak = 0
        elif pressure_ms < self.low_ms:
            self._low_streak += 1
            self._high_streak = 0
        else:
            self._high_streak = self._low_streak = 0
        if self._high_streak >= self.patience and n_workers < self.max_workers:
            self._high_streak = self._low_streak = 0
            self._cooling = self.cooldown
            return n_workers + 1
        if self._low_streak >= self.patience and n_workers > self.min_workers:
            self._high_streak = self._low_streak = 0
            self._cooling = self.cooldown
            return n_workers - 1
        return n_workers


class Autoscaler:
    """Bind an :class:`AutoscalePolicy` to a resizable worker backend."""

    def __init__(self, backend: Any, policy: Optional[AutoscalePolicy] = None,
                 **policy_kwargs: Any):
        if not hasattr(backend, "resize_pool"):
            raise ValueError(
                "autoscaling requires a resizable worker pool "
                f"(backend={getattr(backend, 'name', backend)!r} has no "
                "resize_pool); use backend='multiproc'"
            )
        if policy is not None and policy_kwargs:
            raise ValueError("pass either a policy instance or its kwargs, not both")
        self.backend = backend
        self.policy = policy or AutoscalePolicy(**policy_kwargs)
        self.actions: List[Dict[str, Any]] = []

    def pressure(self) -> float:
        """Mean per-worker aggregate EWMA step-time (ms) — the same signal
        that drives ``ewma_aware`` placement migration."""
        ewma = self.backend.device_ewma()
        n = max(self.backend.n_workers, 1)
        return sum(ewma.values()) / n

    def observe(self, report: Optional[Any] = None) -> Optional[int]:
        """One post-step observation; resizes the pool when the policy
        says so. Returns the new pool size, or ``None`` if unchanged."""
        pressure = self.pressure()
        n = self.backend.n_workers
        target = self.policy.decide(pressure, n)
        if target == n:
            return None
        kind = SCALE_UP if target > n else SCALE_DOWN
        self.backend._emit_worker_event(
            kind, detail=f"pressure={pressure:.3f}ms {n}->{target} workers"
        )
        self.backend.resize_pool(target)
        self.actions.append({
            "step": self.backend.step_count,
            "pressure_ms": pressure,
            "from": n,
            "to": target,
        })
        return target

    def state(self) -> Dict[str, Any]:
        return {
            "workers": self.backend.n_workers,
            "min_workers": self.policy.min_workers,
            "max_workers": self.policy.max_workers,
            "high_ms": self.policy.high_ms,
            "low_ms": self.policy.low_ms,
            "pressure_ms": self.pressure(),
            "actions": list(self.actions),
        }
