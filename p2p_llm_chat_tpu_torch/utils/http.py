"""Tiny threaded HTTP framework + JSON client used by every service.

The reference builds its HTTP surfaces on gin (go/cmd/node/main.go:214,
go/cmd/directory/main.go:59). This module is our in-tree equivalent: a
route table on top of stdlib ``ThreadingHTTPServer`` (no framework
dependency, trivially embeddable in tests) and a matching ``http_json``
client helper with the same timeout discipline the reference uses
(5 s directory client timeout, go/cmd/node/main.go:175).
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator, Optional

from .log import get_logger

log = get_logger("http")


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int = 200
    body: Any = None           # JSON-serialisable, or bytes/str for raw
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)
    # When set, the response is sent with Transfer-Encoding: chunked, one
    # chunk per yielded bytes object (used for Ollama-style NDJSON streams).
    stream: Optional[Iterator[bytes]] = None

    def encode(self) -> bytes:
        if self.body is None:
            return b""
        if isinstance(self.body, bytes):
            return self.body
        if isinstance(self.body, str):
            return self.body.encode("utf-8")
        return json.dumps(self.body).encode("utf-8")


Handler = Callable[[Request], Response]


class Router:
    """Maps (METHOD, exact-path) -> handler. Query strings are parsed off."""

    def __init__(self) -> None:
        self._routes: dict[tuple[str, str], Handler] = {}
        self._fallback: Optional[Handler] = None

    def route(self, method: str, path: str) -> Callable[[Handler], Handler]:
        def deco(fn: Handler) -> Handler:
            self._routes[(method.upper(), path)] = fn
            return fn
        return deco

    def add(self, method: str, path: str, fn: Handler) -> None:
        self._routes[(method.upper(), path)] = fn

    def set_fallback(self, fn: Handler) -> None:
        """Handler consulted when no exact route matches (e.g. static files)."""
        self._fallback = fn

    def dispatch(self, req: Request) -> Response:
        fn = self._routes.get((req.method, req.path))
        if fn is None and self._fallback is not None:
            fn = self._fallback
        if fn is None:
            return Response(404, {"error": "not found"})
        try:
            return fn(req)
        except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
            log.exception("handler error on %s %s", req.method, req.path)
            return Response(500, {"error": str(e)})


class HttpServer:
    """Threaded HTTP server wrapping a Router; one thread per request."""

    def __init__(self, router: Router, addr: str = "127.0.0.1:0") -> None:
        if addr.startswith(":"):
            addr = "127.0.0.1" + addr
        host, _, port = addr.rpartition(":")
        host = host or "127.0.0.1"
        router_ref = router

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _handle(self) -> None:
                parsed = urllib.parse.urlsplit(self.path)
                query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                req = Request(
                    method=self.command,
                    path=parsed.path,
                    query=query,
                    headers={k.lower(): v for k, v in self.headers.items()},
                    body=body,
                )
                resp = router_ref.dispatch(req)
                if resp.stream is not None:
                    self.send_response(resp.status)
                    self.send_header("Content-Type", resp.content_type)
                    self.send_header("Transfer-Encoding", "chunked")
                    for k, v in resp.headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    # Terminate the chunked stream ONLY on clean completion:
                    # a mid-stream failure must look truncated to the client
                    # (dropped connection), not like a well-formed response.
                    # A client hanging up mid-stream (browser tab closed,
                    # loadgen driver done with the deltas it needed) is
                    # normal operation, not a server error — swallow the
                    # reset instead of letting socketserver print a
                    # traceback per disconnect (at 64-peer load that is
                    # a log storm).
                    try:
                        try:
                            for chunk in resp.stream:
                                if not chunk:
                                    continue
                                self.wfile.write(
                                    f"{len(chunk):x}\r\n".encode())
                                self.wfile.write(chunk)
                                self.wfile.write(b"\r\n")
                                self.wfile.flush()
                            self.wfile.write(b"0\r\n\r\n")
                        except (ConnectionResetError, BrokenPipeError):
                            log.debug(
                                "client disconnected mid-stream on %s %s",
                                self.command, parsed.path)
                            self.close_connection = True
                    finally:
                        # Run the generator's finally blocks NOW
                        # (inflight gauges, stats observers, upstream
                        # connections) rather than at some later GC — on
                        # EVERY exit path, not just the two reset types:
                        # a socket timeout or any other write error that
                        # propagates out of the chunk loop must settle
                        # the gauges too (a no-op when the generator ran
                        # to exhaustion).
                        try:
                            resp.stream.close()
                        except Exception:  # noqa: BLE001 — teardown only
                            pass
                    return
                payload = resp.encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                if payload and self.command != "HEAD":
                    self.wfile.write(payload)

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _handle

            def log_message(self, fmt: str, *args: Any) -> None:
                log.debug("%s %s", self.address_string(), fmt % args)

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # The socketserver default backlog (5) RESETS most of a
            # 32-peer simultaneous suggestion burst before accept() ever
            # sees it — observed as "(LLM unavailable: Connection reset
            # by peer)" at every UI when 8B decode holds connections open
            # for seconds. One co-pilot burst = one connection per peer,
            # so size the backlog to hundreds of peers.
            request_queue_size = 256

        self._httpd = _Server((host, int(port)), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        """Dialable base URL (wildcard binds rewritten to loopback)."""
        host, port = self._httpd.server_address[:2]
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"
        return f"http://{host}:{port}"

    def start(self) -> "HttpServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


class HttpError(Exception):
    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"HTTP {status}: {body[:200]}")
        self.status = status
        self.body = body


def http_json(
    method: str,
    url: str,
    body: Any = None,
    timeout: float = 5.0,
    raise_for_status: bool = True,
    headers: Optional[dict] = None,
) -> tuple[int, Any]:
    """Minimal JSON-over-HTTP client. Returns (status, parsed-json-or-None).
    ``headers`` merge under the computed Content-Type — the hook proxy
    hops use to forward X-Graft-Trace / X-Session-Id."""
    data = None
    hdrs = dict(headers or {})
    if body is not None:
        data = json.dumps(body).encode("utf-8")
        hdrs["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=hdrs, method=method.upper())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        raw = e.read()
        status = e.code
        if raise_for_status:
            raise HttpError(status, raw.decode("utf-8", "replace")) from None
    except (urllib.error.URLError, socket.timeout, ConnectionError, OSError) as e:
        raise ConnectionError(f"{method} {url}: {e}") from None
    parsed = json.loads(raw.decode("utf-8")) if raw else None
    return status, parsed
