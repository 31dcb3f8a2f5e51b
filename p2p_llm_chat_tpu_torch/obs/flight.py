"""Scheduler flight recorder: an always-on bounded event ring.

The trace plane (obs/trace.py) answers per-request questions for
SAMPLED requests; the flight recorder answers the post-mortem one —
"what was the loop doing when it hung" — for which sampling is the
wrong tool: the interesting request is precisely the one nobody chose
to sample. So this is always on, and the steady-state cost is one
deque append under a short lock per scheduler-loop event (admissions,
chunk dispatches, park/wake, fuse-K flips, stall episodes).

The ring only becomes durable at a dump site: watchdog stall entry,
``_fail_all_and_reset``, or on demand (``POST /admin/trace/dump``).
Dumps serialize and write OUTSIDE the lock (the scheduler loop must
never wait on disk to append an event) to `TRACE_FLIGHT_PATH` (default
``$TMPDIR/graftflight-<pid>.json``), atomically via rename so a crash
mid-dump never leaves a torn file. Runbook: docs/observability.md.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Optional

from ..utils.env import env_int, env_opt


class FlightRecorder:
    """Fixed-size ring of ``{"kind", "it", "t_ms", ...}`` events.

    ``it`` is the scheduler's loop-iteration counter: the dump names
    the stalling event by the iteration it shares with the stall
    marker, which is what makes "iteration 812 dispatched K=4, then
    stalled 2100 ms" a one-line diagnosis.
    """

    def __init__(self, capacity: Optional[int] = None,
                 path: Optional[str] = None) -> None:
        cap = (env_int("TRACE_FLIGHT_N", 512)
               if capacity is None else capacity)
        self.capacity = max(8, cap)
        self.path = (path if path is not None
                     else (env_opt("TRACE_FLIGHT_PATH", "")
                           or os.path.join(
                               tempfile.gettempdir(),
                               f"graftflight-{os.getpid()}.json")))
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _mu
        self._dumps = 0             # guarded-by: _mu
        self._anchor = time.time() - time.monotonic()

    def note(self, kind: str, it: int = 0, **meta) -> None:
        """Append one event — the hot-path call, O(1), no allocation
        beyond the event dict itself."""
        ev = {"kind": kind, "it": it,
              "t_ms": round((self._anchor + time.monotonic()) * 1e3, 3)}
        if meta:
            ev.update(meta)
        with self._mu:
            self._ring.append(ev)

    def snapshot(self) -> list:
        """Oldest-first copy of the ring."""
        with self._mu:
            return list(self._ring)

    def dumps_total(self) -> int:
        with self._mu:
            return self._dumps

    def dump(self, reason: str, extra: Optional[dict] = None) -> str:
        """Write the ring to ``self.path`` and return the path.

        Snapshot under the lock; serialize + write outside it. Repeat
        dumps overwrite — the file is "the last interesting moment",
        and the first stall of an episode is the one that names the
        cause (later dumps of the same episode carry it too, the ring
        is larger than an episode)."""
        with self._mu:
            events = list(self._ring)
            self._dumps += 1
            n_dumps = self._dumps
        doc = {"reason": reason,
               "dumped_at": round(time.time(), 3),
               "dumps": n_dumps,
               "n_events": len(events),
               "events": events}
        if extra:
            doc.update(extra)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)
        os.replace(tmp, self.path)
        return self.path
