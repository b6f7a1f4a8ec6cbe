"""Serving of the port: the multi-tenant dataflow front end (slot-based
admission over collaborative reuse), its wire protocol and client, and the
slot-based engine over the dense and hybrid families' prefill/decode path.

The front end, protocol and client are the reference's
(``repro.serve.{frontend,protocol,client}``). The engine resolves lazily
(PEP 562), so a front end over ``backend="dryrun"`` builds no model code.
"""
from __future__ import annotations

import importlib
from typing import TYPE_CHECKING

from . import protocol
from .client import ServeClient, SubmitTimeout
from .frontend import (
    AdmissionResult,
    ServeFrontend,
    TenantLedger,
    TenantQuota,
)

# name -> (module, attribute); resolved on first access
_LAZY = {
    "GenerationResult": ("repro_torch.serve.engine", "GenerationResult"),
    "Request": ("repro_torch.serve.engine", "Request"),
    "ServeEngine": ("repro_torch.serve.engine", "ServeEngine"),
}

if TYPE_CHECKING:  # pragma: no cover - static imports for type checkers
    from .engine import GenerationResult, Request, ServeEngine

__all__ = [
    "AdmissionResult",
    "GenerationResult",
    "Request",
    "ServeClient",
    "ServeEngine",
    "ServeFrontend",
    "SubmitTimeout",
    "TenantLedger",
    "TenantQuota",
    "protocol",
]


def __getattr__(name: str):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value  # cache for subsequent lookups
    return value
