"""The port's public surface: :func:`flow` builds validated de-dup DAGs and
:class:`ReuseSession` owns the control plane and, with ``execute=True``,
the data plane (the card unless ``device="cpu"``)."""
from .builder import DataflowBuilder, flow
from .events import (
    BatchSubmitReceipt,
    DefragEvent,
    MergeEvent,
    SessionStats,
    StepEvent,
    UnmergeEvent,
    WaveEvent,
)
from .session import ReuseSession

__all__ = [
    "BatchSubmitReceipt",
    "DataflowBuilder",
    "DefragEvent",
    "MergeEvent",
    "ReuseSession",
    "SessionStats",
    "StepEvent",
    "UnmergeEvent",
    "WaveEvent",
    "flow",
]
