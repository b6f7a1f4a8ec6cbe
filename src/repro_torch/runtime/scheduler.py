"""Wave events — the part of ``repro.runtime.scheduler`` the port has.

The reference's scheduler partitions the segment dependency DAG into
waves and steps each wave's segments concurrently. The port steps
segments one after another in launch order and has no wave scheduler;
this module holds the event type that :mod:`repro_torch.api.events`
re-exports, so the session's event types are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
