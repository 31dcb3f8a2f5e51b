"""In-process stub of every wire surface the load driver speaks.

One HTTP server standing in for serve front + node + UI at once, with
deterministic, counter-keyed misbehavior knobs — so the loadgen test
suite (tests/test_torch_loadgen.py) exercises classification, percentile
math, and the open-loop property with no chip, no launcher, and no
timing-dependent randomness:

- ``shed_every=k``: every k-th request answers an immediate
  ``503 + Retry-After`` (the well-formed shed the contract demands);
- ``error_every=k``: every k-th answers 500;
- ``truncate_every=k``: every k-th stream ends without a ``done``
  record (the front's "mid-stream failure looks truncated" contract);
- ``ttft_s`` / ``itl_s`` / ``deltas``: stream shape;
- ``stall_s``: added first-delta stall — the knob the open-loop test
  uses to prove a slow server inflates TTFT without slowing arrivals.

The stub also timestamps every accepted request (``request_times``) —
the arrival-side evidence for the open-loop property.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Iterator, Optional

from ..utils.http import HttpServer, Request, Response, Router


class StubServer:
    def __init__(self, ttft_s: float = 0.0, itl_s: float = 0.0,
                 deltas: int = 3, shed_every: int = 0,
                 error_every: int = 0, truncate_every: int = 0,
                 stall_s: float = 0.0) -> None:
        self.ttft_s = ttft_s
        self.itl_s = itl_s
        self.deltas = deltas
        self.shed_every = shed_every
        self.error_every = error_every
        self.truncate_every = truncate_every
        self.stall_s = stall_s
        self._mu = threading.Lock()
        self._count = 0                  # guarded-by: _mu
        self.request_times: list = []    # guarded-by: _mu
        self.router = Router()
        for p in ("/api/generate", "/api/chat"):
            self.router.add("POST", p, self._gen)
        self.router.add("POST", "/api/suggest/stream", self._suggest)
        self.router.add("POST", "/api/embed", self._embed)
        self.router.add("POST", "/send", self._send)
        self.router.add("GET", "/healthz",
                        lambda r: Response(200, {"status": "ok"}))
        self._server: Optional[HttpServer] = None

    # -- misbehavior schedule ----------------------------------------------

    def _admit(self) -> tuple:
        """Count the request; return (fault-response-or-None, admit
        number). The admit number rides into the stream generator so
        concurrent requests key their misbehavior on THEIR OWN slot,
        never the live counter (which another request may have bumped
        by stream time)."""
        with self._mu:
            self._count += 1
            n = self._count
            self.request_times.append(time.monotonic())
        if self.shed_every and n % self.shed_every == 0:
            return Response(503, {"error": "stub shed"},
                            headers={"Retry-After": "1"}), n
        if self.error_every and n % self.error_every == 0:
            return Response(500, {"error": "stub injected error"}), n
        return None, n

    def count(self) -> int:
        with self._mu:
            return self._count

    # -- handlers -----------------------------------------------------------

    def _stream(self, key: str, wrap, n: int) -> Iterator[bytes]:
        time.sleep(self.ttft_s + self.stall_s)
        truncate = bool(self.truncate_every
                        and n % self.truncate_every == 0)
        for i in range(self.deltas):
            if i:
                time.sleep(self.itl_s)
            yield (json.dumps({key: wrap(f"tok{i} "), "done": False})
                   + "\n").encode()
        if not truncate:
            yield (json.dumps({key: wrap(""), "done": True}) + "\n").encode()

    def _gen(self, req: Request) -> Response:
        fault, n = self._admit()
        if fault is not None:
            return fault
        body = req.json() or {}
        if "messages" in body:
            return Response(200, stream=self._stream(
                "message", lambda t: {"role": "assistant", "content": t},
                n), content_type="application/x-ndjson")
        if not body.get("stream", True):
            time.sleep(self.ttft_s + self.stall_s)
            return Response(200, {"response": "tok " * self.deltas,
                                  "done": True})
        return Response(200, stream=self._stream("response", lambda t: t,
                                                 n),
                        content_type="application/x-ndjson")

    def _suggest(self, req: Request) -> Response:
        fault, n = self._admit()
        if fault is not None:
            return fault
        return Response(200, stream=self._stream("delta", lambda t: t, n),
                        content_type="application/x-ndjson")

    def _embed(self, req: Request) -> Response:
        fault, _ = self._admit()
        if fault is not None:
            return fault
        body = req.json() or {}
        inp = body.get("input")
        texts = [inp] if isinstance(inp, str) else list(inp or [])
        time.sleep(self.ttft_s)
        return Response(200, {"embeddings": [[0.0] * 4 for _ in texts],
                              "prompt_eval_count": len(texts)})

    def _send(self, req: Request) -> Response:
        fault, _ = self._admit()
        if fault is not None:
            return fault
        return Response(200, {"status": "sent"})

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StubServer":
        self._server = HttpServer(self.router, "127.0.0.1:0").start()
        return self

    @property
    def url(self) -> str:
        assert self._server is not None
        return self._server.url

    def stop(self) -> None:
        if self._server:
            self._server.stop()
