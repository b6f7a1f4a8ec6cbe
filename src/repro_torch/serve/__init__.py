"""Serving of the port: the slot-based engine over the dense family's
prefill/decode path. The multi-tenant front end comes later (ROADMAP)."""
from .engine import GenerationResult, Request, ServeEngine

__all__ = ["GenerationResult", "Request", "ServeEngine"]
