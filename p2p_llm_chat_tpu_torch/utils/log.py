"""Logging setup shared by all services.

The reference logs with stdlib ``log`` plus emoji markers (go/cmd/node/main.go:171,
186, 280). We use Python logging with a compact single-line format; services call
``get_logger(name)`` and log at info for lifecycle events, debug for per-request
detail.
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger("p2pchat")
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"p2pchat.{name}")
