"""Serving on one card: the fixed-slot engine with int8 KV caches."""
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

__all__ = ["EngineConfig", "Request", "ServeEngine"]
