"""The live profiler server behind ``SERVE_PROFILE_PORT``.

The reference starts ``jax.profiler.start_server(port)``: a collection
server an xprof / TensorBoard client attaches to for live device traces
of the serving loop. No client of that protocol exists for PyTorch, so the
port serves its own small HTTP listener on the same port (utils/http.py),
beside the Ollama front:

- ``POST /profile`` with ``{"duration_ms": N}`` (1 <= N <= 30000) captures
  ``torch.profiler`` over the serving loop for N ms and answers with the
  Chrome trace (the JSON ``chrome://tracing`` and Perfetto read),
  gzip-compressed (``application/gzip``), and in ``X-Profile-Loop-Ms``
  the time the loop spent starting and stopping the profiler (it serves
  nothing meanwhile). The activities are the CPU and,
  on the card, CUDA: kernels by their ``__global__`` names, those replayed
  from CUDA graphs included. The scheduler's work shows as its
  ``sched.<op>`` ranges (serve/scheduler.BatchScheduler._dev).
- ``{"model": tag}`` names the engine under ``SERVE_MODELS`` (default:
  the first), under ``SERVE_TP`` too: that engine's loop on the leader.
- One capture at a time: another one meanwhile answers 409; a missing
  or out-of-range duration answers 400; an unknown model 404.

The profiler starts and stops ON the scheduler's loop thread (jobs the
loop runs between iterations, BatchScheduler.run_on_loop): a profiler
started on one thread records none of another thread's CPU ranges, and
a job never runs inside a CUDA-graph capture. Under ``SERVE_TP`` it
captures the leader's process only (the follower ranks run the same ops
on their shards).
"""

from __future__ import annotations

import gzip
import os
import tempfile
import threading
import time

import torch

from ..utils.http import HttpServer, Request, Response, Router
from ..utils.log import get_logger

log = get_logger("obs.profile_server")

MAX_DURATION_MS = 30000


def capture_trace(sched, duration_ms: float) -> tuple[bytes, float]:
    """``torch.profiler`` over ``sched``'s loop for ``duration_ms``: the
    Chrome trace's JSON bytes, and the ms the loop spent in the start and
    stop jobs (the stop turns every recorded event into the trace's, with
    the interpreter held: the loop serves nothing meanwhile)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if sched.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)

    def timed(fn):
        def run():
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        return run

    _, start_ms = sched.run_on_loop(timed(prof.start))
    try:
        time.sleep(duration_ms / 1e3)
    finally:
        _, stop_ms = sched.run_on_loop(timed(prof.stop))
    with tempfile.TemporaryDirectory(prefix="profile_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as f:
            return f.read(), start_ms + stop_ms


class ProfileServer:
    """The ``POST /profile`` listener on ``addr`` over ``targets`` (model
    tag -> scheduler; the first is the default)."""

    def __init__(self, targets: dict, addr: str) -> None:
        if not targets:
            raise ValueError("need at least one scheduler to profile")
        self.targets = dict(targets)
        self.default = next(iter(self.targets))
        self._busy = threading.Lock()
        router = Router()
        router.add("POST", "/profile", self._profile)
        self._server = HttpServer(router, addr)

    @property
    def url(self) -> str:
        return self._server.url

    def start(self) -> "ProfileServer":
        self._server.start()
        log.info("profiler server on %s (POST /profile {\"duration_ms\": "
                 "N}: a torch.profiler capture of the serving loop as a "
                 "gzip Chrome trace)", self._server.addr)
        return self

    def stop(self) -> None:
        self._server.stop()

    def _profile(self, req: Request) -> Response:
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "the body must be JSON"})
        dur = body.get("duration_ms") if isinstance(body, dict) else None
        if (isinstance(dur, bool) or not isinstance(dur, (int, float))
                or not 1 <= dur <= MAX_DURATION_MS):
            return Response(400, {"error": "duration_ms must be a number "
                                  f"from 1 to {MAX_DURATION_MS}"})
        tag = body.get("model") or self.default
        sched = self.targets.get(tag) if isinstance(tag, str) else None
        if sched is None:
            return Response(404, {"error": f"no model {tag!r} on this "
                                  "server"})
        if not self._busy.acquire(blocking=False):
            return Response(409, {"error": "a capture is already running"})
        try:
            t0 = time.monotonic()
            raw, loop_ms = capture_trace(sched, float(dur))
            data = gzip.compress(raw, compresslevel=1)
            log.info("profile of %s: %.0f ms captured, %d bytes of trace "
                     "(%d gzip) in %.2f s; the loop spent %.1f ms starting "
                     "and stopping it", tag, dur, len(raw), len(data),
                     time.monotonic() - t0, loop_ms)
        finally:
            self._busy.release()
        return Response(200, data, content_type="application/gzip",
                        headers={"X-Profile-Loop-Ms": f"{loop_ms:.3f}"})
