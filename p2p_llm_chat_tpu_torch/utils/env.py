"""Env-var-first configuration helpers.

The reference configures every process purely through environment variables
read via tiny helpers (``envOr`` at go/cmd/node/main.go:286-291, ``getenv`` at
go/cmd/directory/main.go:100-109). We keep that contract — the same variable
names keep working — and layer typed accessors on top.
"""

from __future__ import annotations

import os


def env_or(key: str, default: str) -> str:
    """Return ``os.environ[key]`` if set and non-empty, else ``default``.

    Mirrors ``envOr`` (go/cmd/node/main.go:286-291): empty string counts as
    unset.
    """
    v = os.environ.get(key, "")
    return v if v != "" else default


def env_int(key: str, default: int) -> int:
    v = os.environ.get(key, "")
    if v == "":
        return default
    return int(v)


def env_float(key: str, default: float) -> float:
    v = os.environ.get(key, "")
    if v == "":
        return default
    return float(v)


def env_opt(key: str, default: str) -> str:
    """Return ``os.environ[key]`` if SET — even when empty — else ``default``.

    The one sanctioned exception to ``env_or``'s empty-is-unset contract,
    for optional-feature flags whose documented OFF spelling is the empty
    string (``BENCH_QUANT=`` = plain bf16, ``BENCH_KV_QUANT=`` = bf16 KV
    pool). graftcheck's env-hygiene analyzer recognizes it alongside the
    typed helpers.
    """
    return os.environ.get(key, default)


def env_bool(key: str, default: bool = False) -> bool:
    v = os.environ.get(key, "").strip().lower()
    if v == "":
        return default
    return v in ("1", "true", "yes", "on")
