"""Request tracing: the wire header and the bounded span store — a copy
of p2p_llm_chat_tpu/obs/trace.py's header grammar and store (the port
imports nothing of the reference package).

Design constraints, in order:

- **Cheap enough to leave on.** A span is two ``time.monotonic()``
  reads and one dict append under a short lock; an UNSAMPLED request
  pays one header parse and records nothing. `TRACE_SAMPLE` defaults
  to 1.0 because the loadgen acceptance gate holds the goodput delta
  under 2% at that rate — operators turn it *down* on pathological
  fan-in, not up.
- **Deterministic sampling.** The sample decision is a pure function
  of the trace id (:func:`sampled_for`), so every replica a request
  touches makes the SAME decision without coordination, and the
  router-side merge never sees half a timeline. The header may pin
  the decision explicitly (``;s=0|1``) — loadgen and the
  chat plane mint ids client-side and the origin's verdict wins.
- **Bounded.** The store keeps the most recent `TRACE_STORE` trace
  ids per process, FIFO-evicted. A trace is post-mortem state, not a
  database: the loadgen report fetches timelines right after the run.

Wire contract (docs/observability.md): ``X-Graft-Trace: <id>[;s=0|1]``
where ``<id>`` is 8–64 lowercase hex chars. Spans serialize with
wall-anchored ``t0_ms`` so timelines from different processes merge on
one axis (monotonic clocks share no epoch across processes).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from ..utils.env import env_float, env_int

HEADER = "X-Graft-Trace"
HEADER_LC = "x-graft-trace"     # utils.http lowercases inbound headers

_HEX = frozenset("0123456789abcdef")


def trace_sample_rate() -> float:
    """`TRACE_SAMPLE` — fraction of requests that record spans."""
    return env_float("TRACE_SAMPLE", 1.0)


def sampled_for(trace_id: str, rate: float) -> bool:
    """Deterministic per-id sample verdict: hash-free (the id is
    already uniform hex) and identical on every process that sees the
    id — the property the cross-replica merge depends on."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) / float(1 << 32) < rate


@dataclass(frozen=True)
class TraceContext:
    """The propagated identity: id + pinned sample verdict."""

    trace_id: str
    sampled: bool = True

    def header_value(self) -> str:
        """The wire form, sample verdict pinned (what a router forwards)."""
        return f"{self.trace_id};s={1 if self.sampled else 0}"


def mint(rate: Optional[float] = None) -> TraceContext:
    """New context at this process's sample rate (origin decides)."""
    tid = uuid.uuid4().hex
    r = trace_sample_rate() if rate is None else rate
    return TraceContext(tid, sampled_for(tid, r))


def parse_header(value: Optional[str]) -> Optional[TraceContext]:
    """``<id>[;s=0|1]`` -> context, else None. An explicit ``s=`` flag
    wins (the origin pinned it); a bare id re-derives the verdict —
    deterministic, so it matches whatever the origin derived."""
    if not value:
        return None
    parts = value.strip().split(";")
    tid = parts[0].strip().lower()
    if not (8 <= len(tid) <= 64) or not set(tid) <= _HEX:
        return None
    for p in parts[1:]:
        p = p.strip()
        if p == "s=1":
            return TraceContext(tid, True)
        if p == "s=0":
            return TraceContext(tid, False)
    return TraceContext(tid, sampled_for(tid, trace_sample_rate()))


class TraceStore:
    """Per-process bounded span store, keyed by trace id.

    Thread contract: every mutator runs under ``_mu`` (the HTTP
    threads, the scheduler loop, and the router's scrape thread all
    record spans). The metric objects bound by :meth:`bind_registry`
    are updated OUTSIDE the lock — they carry their own registry lock
    and nothing here may nest into it.
    """

    def __init__(self, replica: str = "",
                 max_traces: Optional[int] = None) -> None:
        self.replica = replica      # display tag; set before serving
        self._max = max(1, (env_int("TRACE_STORE", 256)
                            if max_traces is None else max_traces))
        self._mu = threading.Lock()
        # trace id -> [span dict, ...], insertion-ordered for FIFO
        # eviction of whole traces (evicting single spans would leave
        # half-timelines that read as missing phases).
        self._traces: "OrderedDict[str, list]" = OrderedDict()  # guarded-by: _mu
        self._entries = 0           # guarded-by: _mu (spans stored now)
        # Wall anchor: monotonic t0 -> epoch ms, so timelines from
        # different processes position comparably after the merge.
        self._anchor = time.time() - time.monotonic()
        self._m_spans = None
        self._m_entries = None

    def bind_registry(self, registry) -> None:
        """The single registration site for the trace series — every
        owner (serve replica, router) funnels through these literals."""
        self._m_spans = registry.counter("serve_trace_spans_total")
        self._m_entries = registry.gauge("serve_trace_entries")

    def add(self, trace_id: str, name: str, t0: float, dur_s: float,
            **meta) -> None:
        """Record one finished span (``t0`` on the monotonic clock)."""
        rec = {"name": name,
               "t0_ms": round((self._anchor + t0) * 1e3, 3),
               "dur_ms": round(dur_s * 1e3, 3)}
        if self.replica:
            rec["replica"] = self.replica
        if meta:
            rec["meta"] = meta
        with self._mu:
            spans = self._traces.get(trace_id)
            if spans is None:
                spans = self._traces[trace_id] = []
                while len(self._traces) > self._max:
                    _, old = self._traces.popitem(last=False)
                    self._entries -= len(old)
            spans.append(rec)
            self._entries += 1
            entries = self._entries
        if self._m_spans is not None:
            self._m_spans.inc()
            self._m_entries.set(entries)

    def ids(self) -> list:
        with self._mu:
            return list(self._traces.keys())

    def get(self, trace_id: str) -> list:
        """Spans for one trace (copies), ordered by recording time."""
        with self._mu:
            spans = self._traces.get(trace_id)
            return [dict(s) for s in spans] if spans else []

    def stats(self) -> dict:
        with self._mu:
            return {"traces": len(self._traces), "spans": self._entries,
                    "max_traces": self._max}
