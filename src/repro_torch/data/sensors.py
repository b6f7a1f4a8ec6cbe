"""Synthetic IoT sensor streams matching the paper's three sources
(Smart Power Grid, Urban Sensing, NY City Taxi) — §5.2: constant input
rate, event sizes 4–380 bytes, seeded deterministic generators.

Used by the DSPS data plane (repro.runtime) as the raw-stream sources the
merged dataflows share, and by the reuse-serving example as request
feature streams.

Port of ``repro/data/sensors.py``, as it stands: the seed adds
``hash(self.kind)``, which Python salts per process, so the two packages
give the same events within one process only, as the reference's own
streams do across processes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

SENSOR_TYPES = ("smart_grid", "urban_sensing", "taxi")

_CHANNELS = {"smart_grid": 3, "urban_sensing": 6, "taxi": 8}
_PERIOD = {"smart_grid": 96, "urban_sensing": 288, "taxi": 48}


@dataclass
class SensorStream:
    kind: str
    rate: int = 10  # events/sec (paper's constant input rate)
    seed: int = 0
    _t: int = field(default=0, init=False)

    def __post_init__(self):
        assert self.kind in SENSOR_TYPES, self.kind
        self._rng = np.random.default_rng(self.seed + hash(self.kind) % 2**31)

    @property
    def channels(self) -> int:
        return _CHANNELS[self.kind]

    def next_batch(self, n: int) -> np.ndarray:
        """(n, channels) float32 events: diurnal cycle + AR(1) noise + spikes."""
        c = self.channels
        t = self._t + np.arange(n)[:, None]
        self._t += n
        period = _PERIOD[self.kind]
        diurnal = np.sin(2 * np.pi * t / period + np.arange(c)[None, :])
        noise = self._rng.standard_normal((n, c)).astype(np.float32)
        spikes = (self._rng.random((n, c)) < 0.01) * self._rng.standard_normal((n, c)) * 8
        return (10 * diurnal + noise + spikes).astype(np.float32)
