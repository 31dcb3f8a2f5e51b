"""Jittered exponential backoff + bounded retry helper — a copy of
p2p_llm_chat_tpu/utils/backoff.py (the port imports nothing of the
reference package).

The control plane's clients (directory register/lookup, DHT RPCs, the
node's re-register loop) all retry against services that fail together —
a restarted directory sees every node's retry at once. Bare fixed-delay
retries synchronize into thundering herds; this module is the one shared
implementation of the standard antidote (exponential growth, full
decorrelation jitter, a cap), so the retry policy cannot drift per
call site.

Every retry performed through :func:`with_retries` (or counted manually
via :func:`note_retry`) increments a process-global counter exported on
the serve front's ``/metrics`` as ``retry_attempts_total`` — an overload
or outage shows up as a retry-rate spike, not silence.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

_mu = threading.Lock()
_retries_total = 0                 # guarded-by: _mu


def note_retry(n: int = 1) -> None:
    global _retries_total
    with _mu:
        _retries_total += n


def retries_total() -> int:
    with _mu:
        return _retries_total


class Backoff:
    """Exponential delay sequence with full jitter.

    ``next()`` returns the next delay: uniformly sampled from
    [base * (1 - jitter), base] where base doubles (``factor``) per call
    up to ``max_s`` — the "full jitter" end of the AWS-architecture
    spectrum, which decorrelates a fleet retrying in lockstep.
    ``reset()`` returns to the initial delay after a success."""

    def __init__(self, base_s: float, max_s: float,
                 factor: float = 2.0, jitter: float = 0.5) -> None:
        if base_s <= 0 or max_s < base_s:
            raise ValueError(f"need 0 < base_s <= max_s, got "
                             f"{base_s=} {max_s=}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0,1], got {jitter}")
        self.base_s = base_s
        self.max_s = max_s
        self.factor = factor
        self.jitter = jitter
        self._cur = base_s

    def next(self) -> float:
        cur = self._cur
        self._cur = min(self._cur * self.factor, self.max_s)
        lo = cur * (1.0 - self.jitter)
        return random.uniform(lo, cur) if self.jitter else cur

    def peek(self) -> float:
        """The undithered current delay (what next() grows from)."""
        return self._cur

    def reset(self) -> None:
        self._cur = self.base_s


def with_retries(fn: Callable[[], T], *, attempts: int = 3,
                 base_s: float = 0.2, max_s: float = 2.0,
                 jitter: float = 0.5,
                 retry_on: tuple = (ConnectionError,),
                 budget_s: Optional[float] = None) -> T:
    """Call ``fn`` with up to ``attempts`` tries, jittered-exponential
    sleeps in between. Only ``retry_on`` exceptions retry (a 404 is an
    answer, not an outage); the last failure re-raises. ``budget_s``
    bounds total wall time: no retry starts once elapsed + the next
    delay would exceed it (the /send handler runs lookups inline — a
    dead black-hole directory must not hold the UI's request for
    attempts x timeout)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    bo = Backoff(base_s, max_s, jitter=jitter)
    t0 = time.monotonic()
    for i in range(attempts):
        try:
            return fn()
        except retry_on:
            if i + 1 >= attempts:
                raise
            delay = bo.next()
            if (budget_s is not None
                    and time.monotonic() - t0 + delay > budget_s):
                raise
            note_retry()
            time.sleep(delay)
    raise AssertionError("unreachable")
