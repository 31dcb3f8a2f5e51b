"""Directory service: username -> {peer_id, addrs, last} registry, + client.

The port's copy of ``p2p_llm_chat_tpu/directory.py``: the same wire bytes
and behaviour, so port and reference peers mix in one fleet; the port
imports nothing of the reference package.

Reference: go/cmd/directory/main.go (service; memStore at :36-55, /register
at :62-78, /lookup at :80-92) and the node-side DirectoryClient
(go/cmd/node/main.go:55-95). Contracts preserved exactly:

- ``POST /register`` body ``{"username": ..., "peer_id": ..., "addrs": [...]}``
  -> 200 ``{"status":"ok"}``; 400 on missing username/peer_id (directory
  main.go:72). Last-writer-wins on re-register.
- ``GET /lookup?username=U`` -> 200 record ``{"username","peer_id","addrs",
  "last"}`` or 404 ``{"error":"not found"}`` (directory main.go:80-92).
- ``Last`` timestamp recorded on register. The reference records it but never
  evicts (SURVEY.md §2 C5); we additionally support optional TTL-based
  liveness (``DIR_TTL_S``, off by default for contract parity), fixing the
  stale-entry gap the reference's README punts on: a sweep thread evicts
  records whose heartbeat (node re-register) lapsed past the TTL, and
  ``/lookup`` 404s expired entries it races ahead of the sweep. Evictions
  are counted (``directory_evictions_total`` on ``GET /metrics``) and carry
  the ``p2p.directory.evict`` failpoint so the chaos suite can stall the
  sweep. ``POST /deregister`` removes a record on graceful node shutdown
  (guarded by peer_id so a late deregister can't kill a successor's fresh
  registration).

Deliberate fix vs the reference: register bodies are built with a real JSON
encoder — the reference interpolates usernames into JSON via fmt.Sprintf
(go/cmd/node/main.go:56), which breaks on quotes; SURVEY.md §2 flags it as
an injection-prone quirk to fix.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from .proto import now_rfc3339, parse_ts
from .utils.backoff import with_retries
from .utils.env import env_float, env_or
from .utils.failpoints import failpoint, load_env as load_failpoints_env
from .utils.http import HttpServer, Request, Response, Router, http_json
from .utils.log import get_logger
from .utils.metrics import Registry

log = get_logger("directory")


@dataclass
class DirectoryRecord:
    username: str
    peer_id: str
    addrs: list[str] = field(default_factory=list)
    last: str = field(default_factory=now_rfc3339)

    def to_dict(self) -> dict:
        return {
            "username": self.username,
            "peer_id": self.peer_id,
            "addrs": self.addrs,
            "last": self.last,
        }


class MemStore:
    """RWMutex-guarded map (directory/main.go:36-55). Python's GIL + a single
    lock gives the same safety; reads copy records out."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._m: dict[str, DirectoryRecord] = {}

    def set(self, rec: DirectoryRecord) -> None:
        with self._mu:
            self._m[rec.username] = rec

    def get(self, username: str) -> Optional[DirectoryRecord]:
        with self._mu:
            rec = self._m.get(username)
            if rec is None:
                return None
            return DirectoryRecord(rec.username, rec.peer_id, list(rec.addrs), rec.last)

    def delete(self, username: str) -> None:
        with self._mu:
            self._m.pop(username, None)

    def delete_if_older(self, username: str, cutoff_s: float) -> bool:
        """Compare-and-delete for TTL eviction: re-read the record's
        heartbeat under the lock and delete only if it is STILL older
        than ``cutoff_s`` seconds — a node re-registering between a
        caller's age check and the delete keeps its fresh record
        instead of being evicted while live."""
        with self._mu:
            rec = self._m.get(username)
            if rec is None:
                return False
            if time.time() - parse_ts(rec.last).timestamp() <= cutoff_s:
                return False
            del self._m[username]
            return True

    def all(self) -> list[DirectoryRecord]:
        with self._mu:
            return [DirectoryRecord(r.username, r.peer_id, list(r.addrs), r.last)
                    for r in self._m.values()]


class DirectoryService:
    """The registry HTTP service. ``ADDR`` env configures the listen address
    (directory/main.go:58); ``DIR_TTL_S`` optionally enables heartbeat-driven
    liveness (0 = never evict, the reference behavior — the loadgen profile
    turns it on; docs/loadtest.md peer_churn)."""

    def __init__(self, addr: Optional[str] = None,
                 ttl_seconds: Optional[float] = None) -> None:
        # Eager FAIL_POINTS parse: malformed chaos config fails at boot.
        load_failpoints_env()
        self.addr_cfg = addr if addr is not None else env_or("ADDR", ":8080")
        if self.addr_cfg.startswith(":"):
            # The reference directory binds all interfaces for ":8080"
            # (directory/main.go:58); keep that, unlike the loopback default
            # the other services get.
            self.addr_cfg = "0.0.0.0" + self.addr_cfg
        self.ttl = (ttl_seconds if ttl_seconds is not None
                    else env_float("DIR_TTL_S", 0.0))
        self.store = MemStore()
        self.metrics = Registry()
        self._m_evictions = self.metrics.counter("directory_evictions_total")
        self._closed = threading.Event()
        self.router = Router()
        self.router.add("POST", "/register", self._register)
        self.router.add("POST", "/deregister", self._deregister)
        self.router.add("GET", "/lookup", self._lookup)
        self.router.add("GET", "/metrics", self._metrics)
        self.router.add("GET", "/healthz", lambda req: Response(200, {"status": "ok"}))
        self._server: Optional[HttpServer] = None

    # -- handlers ------------------------------------------------------------

    def _register(self, req: Request) -> Response:
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        username = str(body.get("username") or "")
        peer_id = str(body.get("peer_id") or "")
        addrs = body.get("addrs") or []
        if not username or not peer_id:
            # directory/main.go:72 — both fields required.
            return Response(400, {"error": "username and peer_id required"})
        if not isinstance(addrs, list) or not all(isinstance(a, str) for a in addrs):
            return Response(400, {"error": "addrs must be a list of strings"})
        self.store.set(DirectoryRecord(username, peer_id, addrs, now_rfc3339()))
        log.info("registered %s -> %s (%d addrs)", username, peer_id[:12], len(addrs))
        return Response(200, {"status": "ok"})

    def _deregister(self, req: Request) -> Response:
        """POST /deregister {username, peer_id}: graceful node shutdown
        (node.py stop()). Idempotent 200; the peer_id must match the
        live record, so a slow dying node can't delete the record a
        restarted successor just wrote (last-writer-wins parity with
        /register)."""
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        username = str(body.get("username") or "")
        peer_id = str(body.get("peer_id") or "")
        if not username or not peer_id:
            return Response(400, {"error": "username and peer_id required"})
        rec = self.store.get(username)
        if rec is not None and rec.peer_id == peer_id:
            self.store.delete(username)
            log.info("deregistered %s (%s)", username, peer_id[:12])
        return Response(200, {"status": "ok"})

    def _lookup(self, req: Request) -> Response:
        username = req.query.get("username", "")
        if not username:
            return Response(400, {"error": "username required"})
        rec = self.store.get(username)
        if rec is not None and self.ttl > 0:
            age = time.time() - parse_ts(rec.last).timestamp()
            if age > self.ttl:
                # Lookup racing ahead of the sweep: the expired record
                # must 404 NOW, not at the next sweep tick. An armed
                # p2p.directory.evict raise degrades to a skipped
                # eviction here, same as in the sweep — the handler
                # must answer the contracted 404/200, never a 500.
                try:
                    self._evict(username, age)
                except Exception as e:  # noqa: BLE001 — armed raise
                    log.debug("lookup-path evict %s failed: %s",
                              username, e)
                # Re-read after the compare-and-delete: a re-register
                # racing the age check keeps its fresh record and is
                # served; a stale record the failpoint left in place
                # still 404s (expired is expired, evicted or not).
                rec = self.store.get(username)
                if (rec is not None
                        and time.time() - parse_ts(rec.last).timestamp()
                        > self.ttl):
                    rec = None
        if rec is None:
            return Response(404, {"error": "not found"})
        return Response(200, rec.to_dict())

    def _metrics(self, req: Request) -> Response:
        """GET /metrics: eviction ledger (Prometheus text)."""
        return Response(200, self.metrics.render(),
                        content_type="text/plain; version=0.0.4")

    # -- liveness ------------------------------------------------------------

    def _evict(self, username: str, age: float) -> None:
        """Drop one expired record, counted. The ``p2p.directory.evict``
        failpoint stalls/fails the eviction (record survives until the
        next sweep or lookup — degradation contract in
        docs/robustness.md); every caller catches an armed raise, so it
        never breaks the service. The delete is compare-and-delete
        (MemStore.delete_if_older): callers compute ``age`` from a
        snapshot, so a node re-registering between that check and this
        delete must keep its fresh record — otherwise lookups would
        404 a live node until its next heartbeat."""
        act = failpoint("p2p.directory.evict")
        if act is not None:
            return            # drop/error: skip this eviction round
        if not self.store.delete_if_older(username, self.ttl):
            return            # re-registered since the age check: live
        self._m_evictions.inc()
        log.info("evicted %s (heartbeat lapsed %.1fs > ttl %.1fs)",
                 username, age, self.ttl)

    def _sweep_loop(self) -> None:
        """Heartbeat sweep: evict records older than the TTL. Node
        re-registers (node.py _reregister_loop) refresh ``last``, so a
        live node never expires; a killed one disappears within
        ttl + one sweep interval."""
        interval = max(0.05, min(self.ttl / 2.0, 5.0))
        while not self._closed.wait(interval):
            now = time.time()
            for rec in self.store.all():
                age = now - parse_ts(rec.last).timestamp()
                if age > self.ttl:
                    try:
                        self._evict(rec.username, age)
                    except Exception as e:  # noqa: BLE001 — armed raise
                        log.debug("evict %s failed: %s", rec.username, e)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "DirectoryService":
        self._server = HttpServer(self.router, self.addr_cfg).start()
        if self.ttl > 0:
            threading.Thread(target=self._sweep_loop, daemon=True,
                             name="dir-sweep").start()
        log.info("directory listening on %s (ttl=%.0fs)",
                 self._server.addr, self.ttl)
        return self

    @property
    def url(self) -> str:
        assert self._server is not None
        return self._server.url

    def serve_forever(self) -> None:
        self.start()
        threading.Event().wait()

    def stop(self) -> None:
        self._closed.set()
        if self._server:
            self._server.stop()


class DirectoryClient:
    """HTTP client for the directory (go/cmd/node/main.go:50-95).
    5 s per-attempt timeout matches the reference's client (main.go:175);
    on top of that one-shot contract, transient CONNECTION failures now
    retry with jittered exponential backoff (utils/backoff) inside a
    total wall budget — a directory mid-restart costs milliseconds of
    retry, not an outage, while HTTP-level answers (404 not-found) still
    return immediately. Each RPC carries a named failpoint so the chaos
    suite can fault-inject the whole directory rung."""

    def __init__(self, base_url: str, timeout: float = 5.0,
                 attempts: int = 3, retry_budget_s: float = 8.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.attempts = attempts
        self.retry_budget_s = retry_budget_s

    def _call(self, site: str, fn):
        def attempt():
            act = failpoint(site)
            if act is not None and act.kind in ("drop", "error"):
                raise ConnectionError(
                    act.msg or f"injected fault: {site}")
            return fn()
        return with_retries(attempt, attempts=self.attempts,
                            base_s=0.15, max_s=1.5,
                            retry_on=(ConnectionError,),
                            budget_s=self.retry_budget_s)

    def register(self, username: str, peer_id: str, addrs: list[str]) -> None:
        self._call("p2p.directory.register", lambda: http_json(
            "POST", f"{self.base_url}/register",
            {"username": username, "peer_id": peer_id, "addrs": addrs},
            timeout=self.timeout))

    def deregister(self, username: str, peer_id: str) -> None:
        """Graceful-shutdown removal (node.py stop()). Rides the
        registration-plane failpoint site: chaos that severs /register
        severs /deregister the same way."""
        self._call("p2p.directory.register", lambda: http_json(
            "POST", f"{self.base_url}/deregister",
            {"username": username, "peer_id": peer_id},
            timeout=self.timeout))

    def lookup(self, username: str) -> DirectoryRecord:
        import urllib.parse
        q = urllib.parse.urlencode({"username": username})
        status, body = self._call("p2p.directory.lookup", lambda: http_json(
            "GET", f"{self.base_url}/lookup?{q}", timeout=self.timeout))
        return DirectoryRecord(
            username=body.get("username", username),
            peer_id=body.get("peer_id", ""),
            addrs=list(body.get("addrs") or []),
            last=body.get("last", ""),
        )


def main() -> None:
    svc = DirectoryService()
    svc.serve_forever()


if __name__ == "__main__":
    main()
