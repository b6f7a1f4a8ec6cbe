"""Cluster plane of the port: worker events and pluggable worker launchers
over the multiproc data plane.

The port's copy of ``repro.cluster``. Its supervisor (heartbeats,
self-healing) and autoscaler are not ported yet; the recovery and
resize verbs they drive live on the multiproc backend
(:meth:`repro_torch.runtime.worker.MultiprocBackend.recover_worker`,
:meth:`~repro_torch.runtime.worker.MultiprocBackend.resize_pool`).

Imports resolve lazily (PEP 562) because :mod:`repro_torch.runtime.worker`
imports :mod:`repro_torch.cluster.events` at module load, and the
launcher imports the worker's entry point. :mod:`~repro_torch.cluster.events`
itself is dependency-free and safe to import from anywhere.
"""
from __future__ import annotations

import importlib
from typing import TYPE_CHECKING

from .events import EVENT_KINDS, WorkerEvent

# name -> (module, attribute); resolved on first access to avoid the
# worker.py <-> cluster import cycle and keep `import repro_torch.cluster` light.
_LAZY = {
    "WorkerHandle": ("repro_torch.cluster.launcher", "WorkerHandle"),
    "LocalProcessLauncher": ("repro_torch.cluster.launcher", "LocalProcessLauncher"),
    "SubprocessLauncher": ("repro_torch.cluster.launcher", "SubprocessLauncher"),
    "resolve_launcher": ("repro_torch.cluster.launcher", "resolve_launcher"),
}

if TYPE_CHECKING:  # pragma: no cover - static imports for type checkers
    from .launcher import (
        LocalProcessLauncher,
        SubprocessLauncher,
        WorkerHandle,
        resolve_launcher,
    )

__all__ = [
    "EVENT_KINDS",
    "LocalProcessLauncher",
    "SubprocessLauncher",
    "WorkerEvent",
    "WorkerHandle",
    "resolve_launcher",
]


def __getattr__(name: str):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value  # cache for subsequent lookups
    return value
