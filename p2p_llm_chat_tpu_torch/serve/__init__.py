"""Serving stack of the port: backend protocol, continuous-batching
scheduler, engine, the Ollama-compatible HTTP front, and the replica
router (:mod:`.router`: N independent full-stack replicas behind one
backpressure-aware front)."""

from .router import ReplicaRouter

__all__ = ["ReplicaRouter"]
