"""Serving stack of the port: backend protocol, continuous-batching
scheduler, engine, and the Ollama-compatible HTTP front."""
