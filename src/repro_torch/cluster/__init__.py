"""Cluster plane: worker supervision, crash recovery, elastic autoscaling
and pluggable worker launchers over the multiproc data plane.

The port's copy of ``repro.cluster``.

Imports resolve lazily (PEP 562) because :mod:`repro_torch.runtime.worker`
imports :mod:`repro_torch.cluster.events` at module load — an eager
``from .supervisor import WorkerSupervisor`` here would close that loop.
:mod:`~repro_torch.cluster.events` itself is dependency-free and safe to import
from anywhere.
"""
from __future__ import annotations

import importlib
from typing import TYPE_CHECKING

from .events import EVENT_KINDS, WorkerEvent

# name -> (module, attribute); resolved on first access to avoid the
# worker.py <-> cluster import cycle and keep `import repro_torch.cluster` light.
_LAZY = {
    "WorkerSupervisor": ("repro_torch.cluster.supervisor", "WorkerSupervisor"),
    "Autoscaler": ("repro_torch.cluster.autoscaler", "Autoscaler"),
    "AutoscalePolicy": ("repro_torch.cluster.autoscaler", "AutoscalePolicy"),
    "WorkerHandle": ("repro_torch.cluster.launcher", "WorkerHandle"),
    "LocalProcessLauncher": ("repro_torch.cluster.launcher", "LocalProcessLauncher"),
    "SubprocessLauncher": ("repro_torch.cluster.launcher", "SubprocessLauncher"),
    "resolve_launcher": ("repro_torch.cluster.launcher", "resolve_launcher"),
}

if TYPE_CHECKING:  # pragma: no cover - static imports for type checkers
    from .autoscaler import Autoscaler, AutoscalePolicy
    from .launcher import (
        LocalProcessLauncher,
        SubprocessLauncher,
        WorkerHandle,
        resolve_launcher,
    )
    from .supervisor import WorkerSupervisor

__all__ = [
    "Autoscaler",
    "AutoscalePolicy",
    "EVENT_KINDS",
    "LocalProcessLauncher",
    "SubprocessLauncher",
    "WorkerEvent",
    "WorkerHandle",
    "WorkerSupervisor",
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
