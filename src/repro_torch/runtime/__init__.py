"""The port's data plane: broker, segments, the torch backend and StreamSystem."""
from .backend import (
    ExecutionBackend,
    SegmentSpec,
    StepReport,
    available_backends,
    register_backend,
    resolve_backend,
)
from .system import StreamSystem

__all__ = [
    "ExecutionBackend",
    "SegmentSpec",
    "StepReport",
    "StreamSystem",
    "available_backends",
    "register_backend",
    "resolve_backend",
]
