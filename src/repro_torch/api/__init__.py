"""Dataflow construction for the port: :func:`flow` builds validated de-dup DAGs."""
from .builder import DataflowBuilder, flow

__all__ = ["DataflowBuilder", "flow"]
