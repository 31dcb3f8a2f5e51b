"""Replica classes for disaggregated prefill/decode serving — the port's
copy of the class vocabulary of p2p_llm_chat_tpu/serve/disagg.py.

A replica declares a class (``SERVE_REPLICA_CLASS=prefill|decode|mixed``),
advertised on ``/readyz`` and as ``serve_replica_class`` on ``/metrics``.
A router sends a new conversation to a prefill-class replica, whose
``POST /admin/disagg/prefill`` prefills ``ids[:-1]`` and retains it as a
session (scheduler.prefill_park); a decode-class replica pulls the
session over ``/admin/session/import`` and wakes it, sampling the first
token there. The handoff choreography and the per-class autoscaler are
the router's (the reference's serve/disagg.py ``drive_handoff`` drives
the port's fronts as they are).
"""

from __future__ import annotations

from ..utils.env import env_or

REPLICA_CLASSES = ("prefill", "decode", "mixed")


def replica_class_from_env() -> str:
    """This replica's declared role; ``mixed`` (the default) takes any
    work."""
    cls = env_or("SERVE_REPLICA_CLASS", "mixed").strip().lower()
    if cls not in REPLICA_CLASSES:
        raise SystemExit(
            f"SERVE_REPLICA_CLASS must be one of {REPLICA_CLASSES}, "
            f"got {cls!r}")
    return cls
