"""Serving of the port: the multi-tenant dataflow front end (slot-based
admission over collaborative reuse), its wire protocol and client, the
slot-based engine over the model zoo's prefill/decode path, and the
library-level reuse-serving of LM pipelines (``ReuseServing``).

The front end, protocol and client are the reference's
(``repro.serve.{frontend,protocol,client}``). The engine and the
reuse-serving pipeline resolve lazily (PEP 562), so a front end over
``backend="dryrun"`` builds no model code.
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
    "ReuseServing": ("repro_torch.serve.reuse_serving", "ReuseServing"),
    "TenantPipeline": ("repro_torch.serve.reuse_serving", "TenantPipeline"),
    "backbone_pipeline": ("repro_torch.serve.reuse_serving", "backbone_pipeline"),
}

if TYPE_CHECKING:  # pragma: no cover - static imports for type checkers
    from .engine import GenerationResult, Request, ServeEngine
    from .reuse_serving import ReuseServing, TenantPipeline, backbone_pipeline

__all__ = [
    "AdmissionResult",
    "GenerationResult",
    "Request",
    "ReuseServing",
    "ServeClient",
    "ServeEngine",
    "ServeFrontend",
    "SubmitTimeout",
    "TenantLedger",
    "TenantPipeline",
    "TenantQuota",
    "backbone_pipeline",
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
