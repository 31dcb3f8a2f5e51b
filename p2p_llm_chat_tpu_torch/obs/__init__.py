"""grafttrace: end-to-end request tracing + flight recorder — a copy of
p2p_llm_chat_tpu/obs (the port imports nothing of the reference
package), under the same header, span names and file format.

Two complementary observability planes:

- :mod:`.trace` — sampled per-request spans, propagated across the
  fleet via the ``X-Graft-Trace`` header and stored per process in a
  bounded :class:`~.trace.TraceStore` behind
  ``/admin/trace``. Answers "where did THIS request's time go"
  (queue wait vs prefill chunks vs handoff pull vs decode).
- :mod:`.flight` — an always-on fixed-size ring buffer of scheduler-
  loop events, dumped to a JSON file on watchdog stall / reset /
  demand. Answers "what was the loop doing when it hung" after the
  fact, with zero steady-state cost beyond a deque append.

docs/observability.md carries the span taxonomy, the header contract,
and the flight-recorder runbook.
"""

from .flight import FlightRecorder
from .trace import (HEADER, HEADER_LC, TraceContext, TraceStore,
                    mint, parse_header, sampled_for, trace_sample_rate)

__all__ = [
    "HEADER", "HEADER_LC", "TraceContext", "TraceStore", "FlightRecorder",
    "mint", "parse_header", "sampled_for", "trace_sample_rate",
]
