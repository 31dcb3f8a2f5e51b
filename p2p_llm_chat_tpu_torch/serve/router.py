"""Replica-router serving: N full-stack engines behind one HTTP front — the
port's copy of p2p_llm_chat_tpu/serve/router.py (the port imports nothing
of the reference package; this module calls no torch).

The data-parallel architecture for a model that fits one card: each
replica is an independent engine (the port's serve entry, its kernels on
its own card) with paged KV, chunked prefill, fused-K decode,
speculation and the prefix cache, and this router load-balances
*distinct* requests across them. No broadcast protocol, no lockstep
invariant: throughput scales with replica count because replicas never
coordinate. The wire is the reference's — routes, JSON fields, headers,
metric names and labels, failpoint sites — so this router fronts the
reference's replicas and the reference's router fronts the port's.

Mode selection: replica-router when the model fits one host — run N
replicas, point the router at them (``SERVE_ROUTER_UPSTREAMS``); lockstep
SPMD (``SERVE_COORDINATOR``) or ``SERVE_TP`` only when a single model
instance must span cards.

Routing policy (backpressure-aware):

- **Eligibility**: a replica takes new work only when its ``/readyz``
  answered ready at the last scrape and it is not draining. A replica
  whose scrape fails goes not-alive until a scrape succeeds again.
- **Weighting**: among eligible replicas, pick the lowest load score =
  live queue depth (scraped from the replica's ``/metrics``
  ``serve_queue_depth``) + the router's own in-flight count toward that
  replica + a saturation penalty while the replica's
  ``requests_shed_total`` is still climbing between scrapes.
- **Retry**: a 503 (the replica's fast-fail shed) or a connection error
  moves the request to the next-best replica immediately — each retry
  is counted via utils/backoff.note_retry (the shared
  ``retry_attempts_total`` series). A fully-saturated fleet exhausts
  the candidate list without sleeping and answers 503 + Retry-After in
  milliseconds (the min Retry-After the replicas advertised) — the
  router never burns a client's deadline waiting out backpressure.
- **Session affinity**: a conversation id (explicit ``session`` field /
  ``X-Session-Id`` header, else derived from the chat history head or
  the /api/generate ``context`` ids) pins a session to its home
  replica, keeping its paged KV and prefix-cache hits local. A
  draining/unready home rehomes the session to the best eligible
  replica.
- **Draining = migration**: ``POST /admin/drain`` marks a replica
  draining — no new sessions route there, existing streams (proxied
  connections) finish — forwards the drain to the replica's own
  ``/admin/drain``, then LIVE-MIGRATES its open KV sessions: wait for
  in-flight streams to settle, ``park_all`` on the source, have the best
  eligible replica PULL each parked payload over ``/admin/session`` (KV
  bytes replica-to-replica; the router moves only control JSON), forget
  the source copy on the destination's ack, and flip session affinity
  atomically — so a graceful drain loses ZERO sessions. A failed
  export/import leaves the source copy intact (the forget only follows
  an ack) and the client never sees an error: worst case the next turn
  cold re-prefills. ``POST /admin/undrain`` reverses the drain flags
  (migrated sessions stay at their new home).
- **Replica death**: a replica that stops answering rehomes every
  session homed on it (the affinity entries drop, so follow-ups
  rebalance and cold re-prefill — a log line and the
  ``kv_sessions_lost_total`` ledger, never a client error; sessions
  migrated before the death are already counted in
  ``kv_sessions_migrated_total`` and keep their new home).
- **Autoscaling** (``SERVE_ROUTER_AUTOSCALE``): a queue-driven loop on
  the scrape thread spawns replicas when backpressure sustains (queue
  depth per eligible replica above the up-threshold, or any replica
  shedding) and retires them when the fleet idles — retirement goes
  through drain-as-migration, so scaling down is invisible to clients.
  The spawned replicas run the port's entry
  (``python -m p2p_llm_chat_tpu_torch.serve``; see
  :class:`ProcessReplicaSpawner`).
- **Disaggregated prefill/decode** (serve/disagg.py): replicas advertise
  a class (``SERVE_REPLICA_CLASS``) on ``/readyz``; the scrape loop
  re-resolves it on EVERY pass (a replica restarted on the same port
  with a new role is a different pool member). With both a prefill and
  a decode pool eligible, a NEW conversation first rides the handoff:
  the least-loaded prefill replica chunk-prefills it to a parked session
  (``/admin/disagg/prefill``), the least-loaded decode replica pulls the
  payload over ``/admin/session``, affinity flips with the ack, and the
  original request then streams from the decode replica — its
  verify-shaped wake samples the first token, byte-identical to a
  never-disaggregated run. Any failed handoff step degrades to
  finishing the request on the prefill replica (which wakes its own
  parked copy) — counted on ``disagg_handoff_failures_total``, never a
  client-visible error; an empty pool falls back to classic mixed
  routing.

``/metrics`` aggregates every replica's scrape — per-replica series get
a ``replica="i"`` label merged with the same brace-block discipline
serve/multi.py established for model labels (so model-labeled series
from a multi-model replica nest correctly), and unsuffixed fleet totals
are the sums over replicas — plus the router's own counters. Fleet
``/readyz`` is ready when ANY replica is eligible; ``/healthz`` is the
router process's own liveness.

Env surface (utils/env.py helpers; flag table in docs/serving.md):
``SERVE_ROUTER_UPSTREAMS`` (comma-separated replica base URLs — setting
it makes serve.api main() start this router instead of an engine),
``SERVE_ADDR`` (listen address, same flag as the single front),
``SERVE_ROUTER_SCRAPE_MS`` (readiness/metrics poll interval),
``SERVE_ROUTER_RETRIES`` (max distinct replicas tried per request; 0 =
every eligible replica), ``SERVE_ROUTER_PREFIX_SHARE`` (cross-replica
shared prefix tier: the scrape loop reconciles each replica's cached
prefixes by token hash and has missing replicas pull hot entries from
the replica that promoted them — serve/prefix.py; default on, replicas
without a store answer 501 once and are skipped),
``SERVE_ROUTER_AFFINITY`` (session affinity on/off),
``SERVE_ROUTER_TIMEOUT_S`` (per-proxied-request upstream timeout),
``SERVE_ROUTER_DRAIN_WAIT_S`` (how long a drain waits for the
replica's in-flight streams before migrating), and the autoscaler knobs
``SERVE_ROUTER_AUTOSCALE`` / ``_MIN`` / ``_MAX`` / ``_UP_Q`` /
``_DOWN_Q`` / ``_SUSTAIN`` / ``_PORT_BASE`` (docs/serving.md flag
table).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, Optional

from ..obs import trace as _trace
from ..utils import backoff as _backoff
from ..utils.env import env_bool, env_float, env_int, env_or
from ..utils.failpoints import failpoint
from ..utils.http import HttpServer, Request, Response, Router
from ..utils.log import get_logger
from ..utils.metrics import Registry
from . import disagg as _disagg
from .kv_tier import HEAD_GRAIN
from .kv_tier import head_key as _head_key

log = get_logger("serve.router")

# Saturation penalty: a replica still shedding between scrapes competes
# as if this many requests were queued — enough to lose to any healthy
# replica, finite so a fleet that is ALL shedding still gets a
# deterministic order.
_SHED_PENALTY = 1000.0

# Sentinel for "this scrape pass learned nothing about the replica's
# sessions" (unreachable, or a transient list failure) — distinct from
# None, which means "observed: no session tier".
_KEEP_SESSIONS = object()

# Gauges whose fleet-wide SUM is meaningful (capacity/occupancy/depth —
# additive across replicas). Everything else that is not a counter stays
# per-replica only: summing a p50 quantile sample or a config gauge like
# paged_flash_min_w would publish fabricated numbers under the real
# series names.
_ADDITIVE_GAUGES = frozenset((
    "serve_queue_depth", "serve_inflight_requests",
    "serve_batch_occupancy", "serve_batch_slots",
    "serve_kv_free_pages", "serve_kv_total_pages",
    # Multi-tier KV (serve/kv_tier.py): fleet totals of open/parked
    # sessions and host-pool bytes are capacity numbers an operator
    # sums (kv_wake_p50/p95_ms stay per-replica — quantiles never sum).
    "kv_resident_sessions", "kv_parked_sessions", "kv_open_sessions",
    "kv_host_bytes", "serve_prefix_entries", "prefix_bytes",
))


def _fleet_additive(series: str) -> bool:
    """May this series be summed into an unlabeled fleet total?
    Counters (``*_total``) and histogram ``_count``/``_sum`` components
    are additive by construction; gauges only from the allowlist;
    quantile samples never."""
    if '{quantile="' in series:
        return False
    base = series.split("{", 1)[0]
    if base.endswith(("_total", "_count", "_sum")):
        return True
    return base in _ADDITIVE_GAUGES


@dataclass
class _Replica:
    """One upstream engine's routing state.

    ``url``/``index`` are immutable; every mutable field is part of the
    router's replica-state table and is read/written only under the
    OWNING router's ``_mu`` (the scrape thread and request threads both
    touch it). The guard lives on another object, which the per-class
    ``# guarded-by:`` grammar cannot express — the router's own tables
    (``_sessions``, ``_rr``) carry the machine-checked annotations, and
    every access to these fields in router.py sits inside a
    ``with self._mu:`` block there."""

    url: str
    index: int
    alive: bool = False
    ready: bool = False
    draining: bool = False
    queue_depth: float = 0.0
    shed_total: float = -1.0
    shedding: bool = False
    inflight: int = 0
    routed: int = 0
    retried_to: int = 0
    last_scrape_s: float = 0.0
    # Disaggregated serving (serve/disagg.py): the replica's declared
    # class, re-resolved from /readyz on EVERY scrape pass — a replica
    # restarted on the same port with a new role must change pools.
    cls: str = "mixed"
    # Decode-pool pressure inputs (ClassAutoscaler): in-flight streams
    # and decode-slot occupancy, scraped alongside queue depth.
    inflight_streams: float = 0.0
    occupancy: float = 0.0
    # Ever answered a scrape: distinguishes a WARMING spawn (never
    # alive yet — counts toward autoscale capacity) from a DEAD replica
    # (was alive, stopped answering — must not block a replacement).
    ever_alive: bool = False
    # Last-known open-session keys from the replica's /admin/session
    # (None = no session tier / never observed): the death ledger
    # counts THESE — the sessions that actually existed — not the
    # router's LRU-bounded affinity entries, which under- and
    # over-count in different directions.
    sessions: Optional[tuple] = None

    def snapshot(self) -> dict:
        return {"url": self.url, "index": self.index, "alive": self.alive,
                "ready": self.ready, "draining": self.draining,
                "queue_depth": self.queue_depth,
                "inflight": self.inflight, "routed": self.routed,
                "retried_to": self.retried_to,
                "shedding": self.shedding, "class": self.cls}


class _Upstream:
    """One proxied upstream response: status/headers plus a body source
    that can be drained whole or streamed chunk-by-chunk."""

    def __init__(self, status: int, headers, resp) -> None:
        self.status = status
        self.headers = headers
        self._resp = resp

    def read_all(self) -> bytes:
        with self._resp:
            return self._resp.read()

    def iter_chunks(self, size: int = 16384) -> Iterator[bytes]:
        # http.client transparently de-chunks Transfer-Encoding: chunked;
        # re-chunking happens in utils/http's stream writer. read1(), NOT
        # read(): read(n) on a chunked response LOOPS across chunk
        # boundaries accumulating until n bytes or end-of-stream — for
        # any completion under n bytes that buffers the ENTIRE generation
        # and forwards nothing until it finishes, silently destroying
        # token-by-token streaming (TTFT through the router == total
        # time). read1 returns after at most one underlying chunk.
        # A mid-read upstream failure propagates and truncates the
        # client stream — the same "failure looks truncated, never
        # well-formed" contract HttpServer applies to local streams.
        with self._resp:
            read1 = getattr(self._resp, "read1", None)
            while True:
                chunk = read1(size) if read1 else self._resp.read(size)
                if not chunk:
                    return
                yield chunk


def parse_metrics_text(text: str) -> "OrderedDict[str, float]":
    """Prometheus exposition -> ordered {series: value}. Series keys keep
    their label block verbatim (``name{a="b"}``); comment/TYPE lines are
    skipped. Order is preserved so aggregated output groups stably."""
    out: "OrderedDict[str, float]" = OrderedDict()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # Split on the LAST space: label values may contain spaces.
        name, _, value = line.rpartition(" ")
        if not name:
            continue
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


def _merge_label(series: str, label: str) -> str:
    """Merge ``label`` (e.g. ``replica="0"``) into a series key, reusing
    an existing brace block — a second ``{}`` suffix would be malformed
    exposition and break the whole scrape (the serve/multi.py model-label
    discipline)."""
    if series.endswith("}"):
        return f"{series[:-1]},{label}}}"
    return f"{series}{{{label}}}"


class ReplicaRouter:
    """Backpressure-aware request router over N replica serve fronts."""

    def __init__(self, upstreams: list[str], addr: Optional[str] = None,
                 scrape_ms: Optional[float] = None,
                 retries: Optional[int] = None,
                 affinity: Optional[bool] = None,
                 timeout_s: Optional[float] = None,
                 registry: Optional[Registry] = None,
                 prefix_share: Optional[bool] = None) -> None:
        if not upstreams:
            raise ValueError("need at least one replica URL")
        self.addr_cfg = (addr if addr is not None
                         else env_or("SERVE_ADDR", "127.0.0.1:11434"))
        # The fleet is DYNAMIC: the autoscaler appends and
        # removes entries at runtime, so every iteration over the table
        # outside ``_mu`` works on a snapshot taken under it, and
        # replica indices are monotonic (never reused — metrics labels
        # stay unambiguous across scale events).
        self.replicas = [
            _Replica(url=u.rstrip("/"), index=i)
            for i, u in enumerate(upstreams)]        # guarded-by: _mu
        self._next_index = len(upstreams)            # guarded-by: _mu
        self._mu = threading.Lock()
        # Session-affinity table: conversation id -> home replica index,
        # LRU-bounded (an unbounded dict would grow one entry per
        # conversation forever).
        self._sessions: "OrderedDict[str, int]" = OrderedDict()  # guarded-by: _mu
        self._session_cap = 4096
        self._rr = 0                 # guarded-by: _mu (tiebreak rotation)
        self.scrape_s = max(0.05, (scrape_ms if scrape_ms is not None else
                                   env_float("SERVE_ROUTER_SCRAPE_MS",
                                             500.0)) / 1000.0)
        # 0 = try every replica once; N bounds the distinct replicas
        # tried per request. Resolved per request (``max_attempts``
        # property), not at construction — the fleet size moves under
        # autoscaling.
        self._retries_cfg = (retries if retries is not None
                             else env_int("SERVE_ROUTER_RETRIES", 0))
        self.affinity = (affinity if affinity is not None
                         else env_bool("SERVE_ROUTER_AFFINITY", True))
        self.timeout_s = (timeout_s if timeout_s is not None
                          else env_float("SERVE_ROUTER_TIMEOUT_S", 300.0))
        self.metrics = registry or Registry()
        self._m_requests = self.metrics.counter("router_requests_total")
        self._m_retries = self.metrics.counter("router_retries_total")
        self._m_shed = self.metrics.counter("router_requests_shed_total")
        self._m_errors = self.metrics.counter("router_errors_total")
        # Migration ledger: sessions moved replica-to-replica
        # on drain/retire vs sessions whose home died un-exported (they
        # rehome and cold re-prefill — a bounded cost, never an error).
        # The migration histogram's 0.95 quantile is the "migration
        # p95" acceptance number.
        self._m_migrated = self.metrics.counter("kv_sessions_migrated_total")
        self._m_lost = self.metrics.counter("kv_sessions_lost_total")
        self._m_migration_failed = self.metrics.counter(
            "router_migration_failures_total")
        self._m_migration_ms = self.metrics.histogram("router_migration_ms")
        self._m_scale_up = self.metrics.counter("router_autoscale_up_total")
        self._m_scale_down = self.metrics.counter(
            "router_autoscale_down_total")
        # Disaggregated prefill/decode (serve/disagg.py): the
        # handoff ledger — completed prefill→decode handoffs, their
        # wall (prefill dispatch + pull + ack), and failed handoffs
        # (degraded to the prefill replica, never a client error).
        self._m_handoffs = self.metrics.counter("disagg_handoffs_total")
        self._m_handoff_failures = self.metrics.counter(
            "disagg_handoff_failures_total")
        self._m_handoff_ms = self.metrics.histogram("disagg_handoff_ms")
        # Prefill replicas whose /admin/disagg/prefill answered 501 (no
        # tier / no surface). NOT permanent, unlike the prefix/session
        # sets: the memo clears when the replica dies or changes class
        # — a restart on the same port may have gained a tier, exactly
        # the symmetry the per-scrape class re-resolution restores.
        self._disagg_unsupported: set[int] = set()  # guarded-by: _mu
        # Sessions with a handoff IN FLIGHT: a concurrent identical new
        # conversation (the group_chat fan shape) must not drive a
        # second full prefill + pull of the same session — and its
        # forget must not race the first handoff's export.
        self._handoff_inflight: set[str] = set()    # guarded-by: _mu
        # How long a drain waits for the replica's in-flight streams to
        # settle before migrating (migration must capture sessions those
        # streams retain at finish).
        self.drain_wait_s = env_float("SERVE_ROUTER_DRAIN_WAIT_S", 30.0)
        # Queue-driven autoscaler: ticked by the scrape loop;
        # None = fixed fleet. Installed via attach_autoscaler (tests) or
        # build_router_from_env (SERVE_ROUTER_AUTOSCALE=1).
        self.autoscaler: Optional["Autoscaler"] = None
        # Cross-replica shared prefix tier (serve/prefix.py):
        # the scrape loop lists each replica's cached prefixes by token
        # hash and tells replicas missing one to PULL it from the
        # replica that built it — a prefix promoted by one replica's
        # traffic becomes injectable fleet-wide, so session-affinity
        # imbalance no longer decides who gets the admission win.
        self.prefix_share = (prefix_share if prefix_share is not None
                             else env_bool("SERVE_ROUTER_PREFIX_SHARE",
                                           True))
        self._m_prefix_syncs = self.metrics.counter(
            "router_prefix_syncs_total")
        self._m_prefix_sync_failures = self.metrics.counter(
            "router_prefix_sync_failures_total")
        self._prefix_unsupported: set[int] = set()  # guarded-by: _mu
        # Replicas whose /admin/session answered 501 (no tier) — like
        # the prefix set: permanent per replica, never re-probed.
        self._session_unsupported: set[int] = set()  # guarded-by: _mu
        # (dst index, hash) -> last import attempt time. Scrape-thread
        # only. A replica whose store evicted an import (its cap is its
        # own policy) must not be force-fed the same hash every pass —
        # the cooldown turns a would-be import/evict thrash loop into
        # one retry per minute.
        self._prefix_sync_at: dict[tuple, float] = {}
        self._prefix_sync_cooldown_s = 60.0

        self.router = Router()
        # The Ollama wire contract, proxied: generation endpoints route
        # by load/affinity; metadata endpoints go to the first eligible
        # replica (replicas serve identical model sets).
        for ep in ("/api/generate", "/api/chat"):
            self.router.add("POST", ep, self._route_generate)
        for ep in ("/api/embed", "/api/embeddings", "/api/show"):
            self.router.add("POST", ep, self._route_any)
        for ep in ("/api/tags", "/api/ps"):
            self.router.add("GET", ep, self._route_any)
        # Version answers locally (static — same string as the replica
        # fronts): health probes must not 503 while the fleet warms.
        self.router.add("GET", "/api/version", lambda r: Response(
            200, {"version": "0.1.0-p2p-llm-chat-tpu"}))
        for ep in ("/api/pull", "/api/push", "/api/create", "/api/copy"):
            self.router.add("POST", ep, self._route_any)
        self.router.add("DELETE", "/api/delete", self._route_any)
        self.router.add("GET", "/", lambda r: Response(
            200, "Ollama is running", content_type="text/plain"))
        self.router.add("HEAD", "/", lambda r: Response(200, ""))
        self.router.add("GET", "/healthz",
                        lambda r: Response(200, {"status": "ok"}))
        self.router.add("GET", "/readyz", self._readyz)
        self.router.add("GET", "/metrics", self._metrics)
        self.router.add("GET", "/admin/replicas", self._admin_replicas)
        self.router.add("POST", "/admin/drain", self._admin_drain)
        self.router.add("POST", "/admin/undrain", self._admin_undrain)
        # grafttrace (obs/): the router records its own
        # routing/handoff spans and merges per-replica timelines into
        # one cross-fleet view on GET /admin/trace?id=. Same
        # bind_registry literals as the replica fronts — the single
        # registration site for the serve_trace_* series.
        self.trace = _trace.TraceStore(replica="router")
        self.trace.bind_registry(self.metrics)
        self.router.add("GET", "/admin/trace", self._admin_trace)

        self._closed = threading.Event()
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, daemon=True, name="router-scrape")
        self._server: Optional[HttpServer] = None
        # First scrape inline so the router boots with a live view
        # instead of an all-dead table until the poller's first tick.
        self._scrape_all()
        self._scrape_thread.start()

    # -- replica state -------------------------------------------------------

    @property
    def max_attempts(self) -> int:
        """Distinct replicas tried per request — resolved against the
        LIVE fleet size (autoscaling moves it)."""
        if self._retries_cfg > 0:
            return self._retries_cfg
        with self._mu:
            return max(1, len(self.replicas))

    def _replica_snapshot(self) -> list[_Replica]:
        """The fleet table, copied under the lock — the iteration form
        every non-``_mu`` path uses now that the list mutates at
        runtime."""
        with self._mu:
            return list(self.replicas)

    def _scrape_all(self) -> None:
        # Parallel: a slow/blackholed replica costs its own 2 s timeout,
        # never delaying the OTHER replicas' readiness/drain/queue-depth
        # view past the scrape interval — the routing table must stay
        # fresh precisely when part of the fleet is misbehaving.
        results: dict = {}
        reps = self._replica_snapshot()

        def scrape(rep: _Replica) -> None:
            probe = self._scrape_one(rep.url)
            sessions = _KEEP_SESSIONS
            if probe[0] is not None:
                # Reachable: refresh the session-key observation the
                # death ledger counts. Unreachable keeps the LAST-KNOWN
                # list — that snapshot is exactly the evidence a death
                # needs.
                sessions = self._fetch_session_keys(rep)
            results[rep.index] = (probe, sessions)

        threads = [threading.Thread(target=scrape, args=(rep,))
                   for rep in reps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5.0)
        for rep in reps:
            if rep.index not in results:
                continue
            (ready, depth, shed, cls, instreams, occ), sessions = \
                results[rep.index]
            now = time.monotonic()
            with self._mu:
                died = rep.alive and ready is None
                rep.alive = ready is not None
                if rep.alive:
                    rep.ever_alive = True
                rep.ready = bool(ready)
                rep.last_scrape_s = now
                if died:
                    # A restart on the same port may return with a
                    # different posture — the 501 memo must be re-earned
                    # (same symmetry as the class re-resolution below).
                    self._disagg_unsupported.discard(rep.index)
                if cls is not None and cls != rep.cls:
                    # Re-resolve the class on EVERY scrape, not just the
                    # first sighting: a replica restarted on the same
                    # port with a new role (prefill yesterday, decode
                    # today) is a DIFFERENT pool member — pinning the
                    # first-seen class kept routing new conversations at
                    # a replica that no longer runs admission work
                    # (pinned by the router's tests).
                    log.info("replica %d (%s) class %s -> %s", rep.index,
                             rep.url, rep.cls, cls)
                    rep.cls = cls
                    self._disagg_unsupported.discard(rep.index)
                if sessions is not _KEEP_SESSIONS:
                    rep.sessions = sessions
                if instreams is not None:
                    rep.inflight_streams = instreams
                if occ is not None:
                    rep.occupancy = occ
                if depth is not None:
                    rep.queue_depth = depth
                if shed is not None:
                    # Shedding = the counter moved since the last scrape:
                    # the replica hit its queue bound within one scrape
                    # interval, so routing more there is known-futile.
                    rep.shedding = (rep.shed_total >= 0
                                    and shed > rep.shed_total)
                    rep.shed_total = shed
                else:
                    # No counter signal (unreachable, or a backend that
                    # doesn't export it): don't penalize forever — a 503
                    # on the request path re-flags it within one try.
                    rep.shedding = False
            if died:
                # Alive -> unreachable transition: rehome its sessions
                # NOW (bounded-cost cold re-prefill on the new home; the
                # ledger counts them), not at each session's next turn.
                self._note_replica_death(rep)

    def _fetch_session_keys(self, rep: _Replica):
        """The replica's current open-session keys, for the death
        ledger. 501/404 = no tier (permanent; remembered like the
        prefix set); transient failures keep the last observation."""
        with self._mu:
            if rep.index in self._session_unsupported:
                return None
        try:
            with urllib.request.urlopen(f"{rep.url}/admin/session",
                                        timeout=2.0) as r:
                return tuple((json.loads(r.read()).get("sessions")
                              or {}).keys())
        except urllib.error.HTTPError as e:
            code = e.code
            e.close()
            if code in (501, 404):
                with self._mu:
                    self._session_unsupported.add(rep.index)
                return None
            return _KEEP_SESSIONS
        except Exception:   # noqa: BLE001 — transient; keep last known
            return _KEEP_SESSIONS

    def _scrape_one(self, url: str):
        """(ready, queue_depth, shed_total, cls, inflight_streams,
        occupancy) — ready None = unreachable. The readiness probe and
        the metrics fetch fail INDEPENDENTLY: a replica whose /readyz
        just answered 200 stays routable when only its /metrics times
        out (stale depth/shed values persist) — collapsing that into
        "unreachable" once idled a healthy replica behind a transient
        exposition stall. ``cls`` comes from the /readyz body (both the
        200 and 503 forms carry it) — None when the replica predates
        the class field (treated as an unchanged class upstream)."""
        cls = None
        try:
            req = urllib.request.Request(f"{url}/readyz")
            try:
                with urllib.request.urlopen(req, timeout=2.0) as r:
                    ready = r.status == 200
                    body = r.read()
            except urllib.error.HTTPError as e:
                body = e.read()     # 503 warming/draining: alive, not ready
                e.close()
                ready = False
            try:
                got = json.loads(body).get("class")
                if got in _disagg.REPLICA_CLASSES:
                    cls = got
            except Exception:   # noqa: BLE001 — classless replica
                pass
        except Exception:   # noqa: BLE001 — probe failure = unreachable
            return None, None, None, None, None, None
        try:
            with urllib.request.urlopen(f"{url}/metrics", timeout=2.0) as r:
                snap = parse_metrics_text(r.read().decode("utf-8", "replace"))
        except Exception:   # noqa: BLE001 — keep stale depth/shed
            return ready, None, None, cls, None, None

        def total(base: str):
            """Sum the base series across label sets: a multi-model
            replica exports ONLY ``{model="tag"}``-labeled series
            (serve/multi.py relabels everything), so reading the
            unlabeled key alone would leave the queue-depth
            weighting and shed penalty silently inert there."""
            vals = [v for k, v in snap.items()
                    if k == base or k.startswith(base + "{")]
            return sum(vals) if vals else None

        return (ready, total("serve_queue_depth"),
                total("requests_shed_total"), cls,
                total("serve_inflight_requests"),
                total("serve_batch_occupancy"))

    def _scrape_loop(self) -> None:
        # Per-replica scrape failures back off implicitly via the fixed
        # interval; the loop itself must never die (a dead poller would
        # freeze the routing table on a stale view).
        while not self._closed.wait(self.scrape_s):
            try:
                self._scrape_all()
            except Exception:   # noqa: BLE001
                log.exception("scrape loop iteration failed")
            try:
                self._sync_prefixes()
            except Exception:   # noqa: BLE001
                log.exception("prefix sync pass failed")
            if self.autoscaler is not None:
                try:
                    self.autoscaler.tick(self)
                except Exception:   # noqa: BLE001
                    log.exception("autoscaler tick failed")

    # -- cross-replica shared prefix tier ------------------------------------

    def _sync_prefixes(self) -> None:
        """One shared-prefix reconciliation pass (scrape thread): list
        every live replica's cached prefixes by token hash, pick each
        missing hash's source (the replica with the most hits — it has
        the hottest, most battle-tested copy), and tell the lacking
        replica to pull it (POST /admin/prefix/import {"from", "h"}) —
        KV bytes flow replica-to-replica, the router moves only control
        JSON. Bounded to a few imports per pass so a cold fleet warms
        over seconds without an import storm; only entries with >= 1
        hit ship (cold promotions aren't worth evicting a destination's
        hot entries for); a per-(destination, hash) cooldown keeps a
        capacity-bound store that evicts an import from being force-fed
        the same hash every pass; replicas without a prefix store (501)
        are remembered and skipped."""
        reps = self._replica_snapshot()
        if not self.prefix_share or len(reps) < 2:
            return
        import json as _json
        by_idx = {rep.index: rep for rep in reps}
        views: dict[int, dict] = {}
        for rep in reps:
            with self._mu:
                skip = (not rep.alive
                        or rep.index in self._prefix_unsupported)
            if skip:
                continue
            try:
                with urllib.request.urlopen(f"{rep.url}/admin/prefix",
                                            timeout=2.0) as r:
                    views[rep.index] = (_json.loads(r.read().decode())
                                        .get("prefixes") or {})
            except urllib.error.HTTPError as e:
                code = e.code
                e.close()
                if code in (501, 404):
                    # No prefix store on this replica — permanent; do
                    # not re-probe it every pass.
                    with self._mu:
                        self._prefix_unsupported.add(rep.index)
            except Exception:   # noqa: BLE001 — transient; next pass
                pass
        if len(views) < 2:
            return
        union: dict[str, tuple] = {}    # hash -> (hits, source url)
        for idx, prefixes in views.items():
            for h, meta in prefixes.items():
                hits = float(meta.get("hits", 0) or 0)
                cur = union.get(h)
                if cur is None or hits > cur[0]:
                    union[h] = (hits, by_idx[idx].url)
        now = time.monotonic()
        if len(self._prefix_sync_at) > 2048:
            self._prefix_sync_at = {
                k: t for k, t in self._prefix_sync_at.items()
                if now - t < self._prefix_sync_cooldown_s}
        budget = 2                      # imports per pass — no storms
        for idx, prefixes in views.items():
            dst = by_idx[idx].url
            for h, (hits, src) in union.items():
                if budget <= 0:
                    return
                if h in prefixes or src == dst:
                    continue
                # Only PROVEN entries ship: a promoted-but-never-hit
                # prefix isn't worth an import (and with bounded
                # per-replica stores, importing cold entries evicts hot
                # ones — the exact inversion this feature must avoid).
                if hits < 1:
                    continue
                last = self._prefix_sync_at.get((idx, h))
                if (last is not None
                        and now - last < self._prefix_sync_cooldown_s):
                    continue
                self._prefix_sync_at[(idx, h)] = now
                try:
                    req = urllib.request.Request(
                        f"{dst}/admin/prefix/import",
                        data=_json.dumps({"from": src, "h": h}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=10.0) as r:
                        r.read()
                    self._m_prefix_syncs.inc()
                    log.info("prefix %s… synced %s -> %s", h[:12], src,
                             dst)
                except Exception:   # noqa: BLE001 — count, keep going
                    self._m_prefix_sync_failures.inc()
                budget -= 1

    def _eligible(self, cls: Optional[str] = None,
                  rotate: bool = True) -> list[_Replica]:
        """Replicas that may take NEW work, best-first: ready, not
        draining, ordered by load score (queue depth + router inflight +
        shed penalty). Equal scores tiebreak on a rotating index so a
        burst of instant requests (depth never visibly moves) still
        spreads across the fleet instead of piling on replica 0.
        ``cls`` filters to one replica class (the disagg pools).
        ``rotate=False`` for PEEKS (the disagg pool probe, the metrics
        census): a peek that advanced the rotation alongside the real
        candidate pick would step it twice per request — with an even
        fleet size that keeps the parity constant and un-spreads the
        tiebreak entirely."""
        with self._mu:
            if rotate:
                self._rr += 1
            rot = self._rr
            n = len(self.replicas)
            cands = [r for r in self.replicas if r.ready and not r.draining
                     and (cls is None or r.cls == cls)]
            scored = sorted(
                cands,
                key=lambda r: (r.queue_depth + r.inflight
                               + (_SHED_PENALTY if r.shedding else 0.0),
                               (r.index + rot) % n))
        return scored

    # -- session affinity ----------------------------------------------------

    @staticmethod
    def session_key(path: str, body: dict,
                    headers: dict[str, str]) -> Optional[str]:
        """Conversation id for affinity. Explicit wins (``X-Session-Id``
        header or a ``session`` body field — both ignored by replicas);
        else /api/chat derives it from the FIRST message (constant
        across a conversation's turns, unlike the latest one) and
        /api/generate from the ``context`` head ids (the stateless-
        continuation round trip carries them back every turn). One-shot
        prompts get no key and ride pure load balancing."""
        sid = headers.get("x-session-id") or body.get("session")
        if sid:
            return str(sid)
        if path == "/api/chat":
            # Key on the first TWO messages, not just the first: apps
            # send a fixed system prompt as message 0, and keying on it
            # alone would hash EVERY conversation to one session and
            # serialize the fleet onto a single home replica. The first
            # two (system + first user turn, or first user + first
            # assistant reply) are stable across a conversation's later
            # turns, and conversations they DO collide on share their
            # whole opening prefix — co-locating those is prefix-cache
            # locality, not a hotspot.
            msgs = body.get("messages")
            if isinstance(msgs, list) and msgs:
                parts = [f"{m.get('role')}:{m.get('content')}"
                         for m in msgs[:2] if isinstance(m, dict)]
                if parts:
                    return hashlib.sha1(
                        "\x1f".join(parts).encode()).hexdigest()[:16]
            return None
        ctx = body.get("context")
        if isinstance(ctx, (list, tuple)) and ctx:
            ids = list(ctx[:HEAD_GRAIN])
            if len(ids) == HEAD_GRAIN and all(
                    type(t) is int for t in ids):
                # EXACTLY the KV tier's anonymous session key (the
                # shared kv_tier.head_key derivation — a follow-up's
                # context head IS the session's token head). Sharing it
                # means a migrated/handed-off session's affinity flip —
                # keyed by the tier keys the source replica lists —
                # rehomes bare /api/generate continuations too, so
                # anonymous wake follows the payload to its new replica
                # instead of cold-missing at the old home.
                return _head_key(ids)
            head = ",".join(str(t) for t in ids)
            return hashlib.sha1(head.encode()).hexdigest()[:16]
        return None

    def _candidates(self, session: Optional[str]) -> list[_Replica]:
        """Routing order: the session's home replica first when it is
        still eligible; else best-score order (and the session rehomes
        to whichever replica ends up serving it)."""
        order = self._eligible()
        if session is None or not self.affinity or not order:
            return order
        with self._mu:
            home = self._sessions.get(session)
            if home is not None:
                self._sessions.move_to_end(session)
        if home is not None:
            for i, r in enumerate(order):
                if r.index == home:
                    return [order[i]] + order[:i] + order[i + 1:]
        return order

    def _note_served(self, session: Optional[str], rep: _Replica) -> None:
        if session is None or not self.affinity:
            return
        with self._mu:
            self._sessions[session] = rep.index
            self._sessions.move_to_end(session)
            while len(self._sessions) > self._session_cap:
                self._sessions.popitem(last=False)

    # -- proxying ------------------------------------------------------------

    def _open(self, rep: _Replica, req: Request) -> _Upstream:
        headers = {}
        ct = req.headers.get("content-type")
        if ct:
            headers["Content-Type"] = ct
        sid = req.headers.get("x-session-id")
        if sid:
            headers["X-Session-Id"] = sid
        # Trace propagation: the replica's scheduler spans land under
        # the id this header carries (_route_generate mints one when
        # the client sent none, so every routed request is mergeable).
        tid = req.headers.get(_trace.HEADER_LC)
        if tid:
            headers[_trace.HEADER] = tid
        up = urllib.request.Request(
            f"{rep.url}{req.path}", data=req.body or None,
            headers=headers, method=req.method)
        try:
            resp = urllib.request.urlopen(up, timeout=self.timeout_s)
            return _Upstream(resp.status, resp.headers, resp)
        except urllib.error.HTTPError as e:
            # Non-2xx with a well-formed body (including the replica's
            # 503 shed): HTTPError IS the response object.
            return _Upstream(e.code, e.headers, e)

    def _respond(self, upstream: _Upstream, rep: _Replica,
                 on_done) -> Response:
        """Upstream -> client response; streams pass through chunk-wise.
        ``on_done`` runs exactly once when the response is fully
        delivered (or the stream ends either way)."""
        ctype = upstream.headers.get("Content-Type") or "application/json"
        is_stream = (upstream.headers.get("Transfer-Encoding") == "chunked"
                     or "ndjson" in ctype)
        if not is_stream:
            try:
                body = upstream.read_all()
            finally:
                on_done()
            return Response(upstream.status, body, content_type=ctype)

        def passthrough() -> Iterator[bytes]:
            try:
                yield from upstream.iter_chunks()
            finally:
                on_done()

        return Response(upstream.status, stream=passthrough(),
                        content_type=ctype)

    def _try_replicas(self, req: Request, session: Optional[str],
                      prefer: Optional[_Replica] = None,
                      avoid_decode: bool = False,
                      tctx: Optional[_trace.TraceContext] = None
                      ) -> Response:
        """Route with retry: walk the candidate list (home replica
        first), moving on at a 503 shed or a connection failure. No
        sleeping anywhere on this path — a fully-saturated fleet must
        answer 503 + Retry-After in milliseconds, not after a backoff
        ladder (the CLIENT owns the retry delay; Retry-After tells it
        how long). ``prefer`` jumps one replica to the front (the
        disagg handoff's destination — or, after a failed handoff, the
        prefill replica that holds the parked work); ``avoid_decode``
        stably demotes decode-class replicas for a NEW conversation
        that could not ride the handoff — admission prefill belongs on
        the prefill/mixed pools, a decode replica is the last resort."""
        self._m_requests.inc()
        # router.route: the routing decision wall — candidate walk
        # including every failover hop, ending when a replica ACCEPTS
        # (stream delivery is the replica's api.request span, not
        # routing). Recorded only for sampled generate-path requests.
        t_route = time.monotonic()
        traced = tctx is not None and tctx.sampled
        cands = self._candidates(session)
        if avoid_decode:
            cands.sort(key=lambda r: r.cls == "decode")     # stable
        if prefer is not None:
            cands = [prefer] + [c for c in cands
                                if c.index != prefer.index]
        cands = cands[: self.max_attempts]
        if not cands:
            self._m_shed.inc()
            return Response(
                503, {"error": "no replica ready"},
                headers={"Retry-After": "2"})
        retry_after = None
        last_error = None
        for attempt, rep in enumerate(cands):
            if attempt:
                # Each failover is a retry against the fleet — counted
                # on the shared utils/backoff series so router failovers
                # and control-plane retries read on one scale.
                _backoff.note_retry()
                self._m_retries.inc()
                with self._mu:
                    rep.retried_to += 1
            with self._mu:
                rep.inflight += 1
                rep.routed += 1
            done = threading.Event()

            def on_done(rep=rep, done=done) -> None:
                if not done.is_set():
                    done.set()
                    with self._mu:
                        rep.inflight -= 1
            try:
                upstream = self._open(rep, req)
            except Exception as e:  # noqa: BLE001 — connection-level failure
                on_done()
                with self._mu:
                    was_alive = rep.alive
                    rep.alive = False
                    rep.ready = False
                log.warning("replica %d (%s) unreachable: %s",
                            rep.index, rep.url, e)
                if was_alive:
                    self._note_replica_death(rep)
                continue
            if upstream.status == 503:
                ra = upstream.headers.get("Retry-After")
                try:
                    if ra is not None:
                        ra_f = float(ra)
                        retry_after = (ra_f if retry_after is None
                                       else min(retry_after, ra_f))
                except ValueError:
                    pass
                upstream.read_all()
                on_done()
                with self._mu:
                    rep.shedding = True
                continue
            if upstream.status >= 500 and upstream.status != 501:
                # Replica-side failure (e.g. an armed
                # serve.scheduler.admit failpoint surfacing as a 500):
                # the request produced no client-visible output, so
                # failing over is safe and lands it on a healthy
                # replica. 501 is excluded — it is a deliberate ANSWER
                # (unsupported model-management endpoints), identical on
                # every replica. Remember the body: if every replica
                # 5xxs the same way, the client gets the real error, not
                # a fabricated shed.
                ctype = (upstream.headers.get("Content-Type")
                         or "application/json")
                last_error = (upstream.status, upstream.read_all(), ctype)
                on_done()
                self._m_errors.inc()
                log.warning("replica %d (%s) answered %d on %s; failing "
                            "over", rep.index, rep.url, upstream.status,
                            req.path)
                continue
            self._note_served(session, rep)
            if traced:
                self.trace.add(tctx.trace_id, "router.route", t_route,
                               time.monotonic() - t_route,
                               replica=rep.url, attempts=attempt + 1)
            return self._respond(upstream, rep, on_done)
        if traced:
            # Exhausted walk: the span's outcome meta says WHY the
            # request never reached a scheduler — breach attribution
            # reads these as route-phase failures.
            self.trace.add(tctx.trace_id, "router.route", t_route,
                           time.monotonic() - t_route,
                           attempts=len(cands),
                           outcome=("error" if retry_after is None
                                    and last_error is not None
                                    else "shed"))
        if retry_after is None and last_error is not None:
            status, body, ctype = last_error
            return Response(status, body, content_type=ctype)
        self._m_shed.inc()
        return Response(
            503, {"error": "all replicas at capacity; retry later"},
            headers={"Retry-After": str(max(1, round(retry_after or 1)))})

    # -- handlers ------------------------------------------------------------

    def _route_generate(self, req: Request) -> Response:
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        if not isinstance(body, dict):
            return Response(400, {"error": "request body must be an object"})
        session = self.session_key(req.path, body, req.headers)
        # Parse-or-mint the trace context at the fleet ingress and
        # stamp it back onto the inbound header dict, so _open (and
        # the handoff's prefill dispatch) forward ONE id to every
        # replica this request touches — the merge key.
        tctx = _trace.parse_header(req.headers.get(_trace.HEADER_LC))
        if tctx is None:
            tctx = _trace.mint()
        req.headers[_trace.HEADER_LC] = tctx.header_value()
        with self._mu:
            is_new = session is None or session not in self._sessions
        prefer = None
        disagg_pools = False
        if is_new:
            prefer, disagg_pools = self._disagg_route(req, body, session)
        return self._try_replicas(req, session, prefer=prefer,
                                  avoid_decode=(is_new and disagg_pools
                                                and prefer is None),
                                  tctx=tctx)

    def _route_any(self, req: Request) -> Response:
        return self._try_replicas(req, None)

    # -- disaggregated prefill/decode (serve/disagg.py) ----------------------

    def _disagg_route(self, req: Request, body: dict,
                      session: Optional[str]):
        """Hand a NEW conversation across the class pools. Returns
        ``(prefer, pools)``: ``prefer`` is the replica to try first —
        the decode destination after a successful handoff (its adopted
        session wakes there, first token sampled decode-side), or the
        prefill replica after a FAILED one (it retains the parked work;
        finishing there is the degradation contract — never a client
        error); None = classic routing. ``pools`` reports whether both
        class pools were eligible (the caller demotes decode replicas
        for un-handed-off new work only when a prefill pool exists).
        All HTTP runs OFF the router lock."""
        order = self._eligible(rotate=False)
        with self._mu:
            unsupported = set(self._disagg_unsupported)
        prefills = [r for r in order if r.cls == "prefill"
                    and r.index not in unsupported]
        decodes = [r for r in order if r.cls == "decode"]
        pools = bool(prefills) and bool(decodes)
        if not pools:
            return None, bool(prefills) or bool(decodes)
        P, D = prefills[0], decodes[0]
        sid = str(req.headers.get("x-session-id")
                  or body.get("session") or "")
        # Single-flight per session: the group_chat fan shape lands N
        # IDENTICAL new conversations concurrently — all sharing one
        # session key, all seeing is_new before the first affinity flip.
        # Only the first drives the handoff; the rest route classically
        # (avoid_decode steers them at the prefill/mixed pools) instead
        # of racing N prefills and N forgets against each other's
        # exports. Anonymous /api/generate openers (no key) skip the
        # guard — they cannot collide on a key either.
        if session is not None:
            with self._mu:
                # Re-check the affinity table UNDER THE SAME LOCK the
                # guard takes: the caller's is_new snapshot predates
                # this point, and a concurrent handoff may have flipped
                # affinity and RELEASED its guard in between — without
                # the re-check that fan member re-drives a full
                # prefill + pull for a session that already lives on
                # its decode home.
                if session in self._sessions:
                    # pools=False on purpose: the session has a home
                    # now, so the caller must follow affinity — the
                    # avoid_decode demotion would push the (decode)
                    # home to the back of the candidate list.
                    return None, False
                if session in self._handoff_inflight:
                    return None, pools
                self._handoff_inflight.add(session)
        t0 = time.monotonic()
        # The handoff rides the request's trace (stamped by
        # _route_generate before this call): the prefill replica's
        # disagg.prefill_park and the decode replica's disagg.import
        # spans land under the same id this router-side envelope does.
        tctx = _trace.parse_header(req.headers.get(_trace.HEADER_LC))
        traced = tctx is not None and tctx.sampled

        def _span(outcome: str, **meta) -> None:
            if traced:
                self.trace.add(tctx.trace_id, "disagg.handoff", t0,
                               time.monotonic() - t0, prefill=P.url,
                               decode=D.url, outcome=outcome, **meta)
        with self._mu:
            P.inflight += 1     # the prefill dispatch is real load
        try:
            try:
                meta = _disagg.drive_handoff(
                    P.url, D.url, req.path, body, session=sid,
                    timeout_s=self.timeout_s,
                    trace=(tctx.header_value() if tctx else ""))
            except _disagg.HandoffUnsupported:
                with self._mu:
                    self._disagg_unsupported.add(P.index)
                log.info("replica %d (%s) has no disagg prefill "
                         "surface; not asking again", P.index, P.url)
                return None, pools
            except Exception as e:  # noqa: BLE001 — HandoffError + rest
                self._m_handoff_failures.inc()
                _span("failed")
                log.warning("disagg handoff %s -> %s failed (%s); "
                            "finishing on the prefill replica", P.url,
                            D.url, e)
                return P, pools
            if meta is None:
                return None, pools  # structured can't: classic routing
            key = str(meta.get("key") or "")
            # Affinity flips with the ack, under BOTH the tier-derived
            # key (sid: strips to the raw id; head: matches
            # session_key's context-head derivation, so the next bare
            # /api/generate turn follows the payload) and the
            # router-side session key when it differs (the /api/chat
            # messages-hash names no tier key). The single-flight
            # guard releases only AFTER this flip — a fan member
            # arriving then sees the session as known and follows the
            # affinity instead of starting a second handoff.
            akey = key[4:] if key.startswith("sid:") else key
            with self._mu:
                for k in {akey, session} - {None, ""}:
                    self._sessions[k] = D.index
                    self._sessions.move_to_end(k)
                while len(self._sessions) > self._session_cap:
                    self._sessions.popitem(last=False)
            self._m_handoffs.inc()
            _span("ok", key=key)
            ms = (time.monotonic() - t0) * 1e3
            self._m_handoff_ms.observe(ms)
            log.info("disagg handoff: %s prefilled on replica %d, "
                     "decoding on replica %d (%.0f ms)", key, P.index,
                     D.index, ms)
            return D, pools
        finally:
            with self._mu:
                P.inflight -= 1
                if session is not None:
                    self._handoff_inflight.discard(session)

    def _readyz(self, req: Request) -> Response:
        """Fleet readiness: ready when ANY replica can take new work."""
        if self._eligible():
            return Response(200, {"status": "ready"})
        return Response(503, {"status": "no replica ready"},
                        headers={"Retry-After": "2"})

    def _admin_trace(self, req: Request) -> Response:
        """GET /admin/trace: the router store's ids + stats; ``?id=``
        merges the CROSS-REPLICA timeline — the router's own routing/
        handoff spans plus every live replica's spans for that id,
        sorted on the shared wall-anchored ``t0_ms`` axis. Replicas
        that never sampled the id (or already evicted it) simply
        contribute nothing; a dead replica drops out after its fetch
        timeout, same posture as the /metrics aggregate."""
        tid = str(req.query.get("id") or "")
        if not tid:
            return Response(200, {"traces": self.trace.ids(),
                                  "stats": self.trace.stats()})
        spans = self.trace.get(tid)
        with self._mu:
            reps = [(r.index, r.url) for r in self.replicas if r.alive]
        q = urllib.parse.urlencode({"id": tid})
        # The per-replica fetch is itself a traced hop: forward the
        # admin request's own X-Graft-Trace so a traced debugging
        # session shows its fan-out in the replica ingress logs.
        hdrs = {}
        raw_tid = req.headers.get(_trace.HEADER_LC)
        if raw_tid:
            hdrs[_trace.HEADER] = raw_tid

        def fetch(url: str, out: dict, idx: int) -> None:
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        f"{url}/admin/trace?{q}", headers=hdrs),
                        timeout=2.0) as r:
                    out[idx] = json.loads(r.read().decode("utf-8"))
            except Exception:  # noqa: BLE001 — 404/dead replica: no spans
                pass

        got: dict = {}
        fetchers = [threading.Thread(target=fetch, args=(url, got, idx))
                    for idx, url in reps]
        for t in fetchers:
            t.start()
        for t in fetchers:
            t.join(timeout=2.5)
        for idx, _ in reps:
            doc = got.get(idx)
            if not isinstance(doc, dict):
                continue
            for s in doc.get("spans") or []:
                if isinstance(s, dict):
                    s.setdefault("replica", str(idx))
                    spans.append(s)
        if not spans:
            return Response(404, {"error": f"trace {tid!r} unknown "
                                           "fleet-wide"})
        spans.sort(key=lambda s: (s.get("t0_ms") or 0.0))
        return Response(200, {"id": tid, "spans": spans})

    def _metrics(self, req: Request) -> Response:
        """Aggregate /metrics: the router's own registry, each replica's
        scrape relabeled ``replica="i"``, and unsuffixed fleet totals
        (sum over replicas). TYPE lines key on base names, once."""
        text = self.metrics.render()
        with self._mu:
            reps = [(r.index, r.url, r.routed, r.ready, r.draining)
                    for r in self.replicas]
        lines: list[str] = []
        typed: set = set()

        def typeline(base: str) -> None:
            if base not in typed:
                typed.add(base)
                kind = "counter" if base.endswith("_total") else "gauge"
                lines.append(f"# TYPE {base} {kind}\n")

        for idx, url, routed, ready, draining in reps:
            typeline("router_routed_total")
            lines.append(f'router_routed_total{{replica="{idx}"}} {routed}\n')
            typeline("router_replica_ready")
            lines.append(
                f'router_replica_ready{{replica="{idx}"}} {int(ready)}\n')
            typeline("router_replica_draining")
            lines.append(f'router_replica_draining{{replica="{idx}"}} '
                         f"{int(draining)}\n")
        # Disagg pool census: ELIGIBLE members per replica class (the
        # routing view — a draining or unready replica is not pool
        # capacity). Always emitted, so a dashboard can alarm on an
        # empty pool rather than a missing series.
        pools = {c: 0 for c in _disagg.REPLICA_CLASSES}
        for r in self._eligible(rotate=False):
            pools[r.cls] = pools.get(r.cls, 0) + 1
        # Literal TYPE line (not typeline's f-string): the metrics-
        # contract analyzer registers the export site from it — the
        # name sits outside the code-literal suffix grammar.
        typed.add("router_pool_replicas")
        lines.append("# TYPE router_pool_replicas gauge\n")
        for c in _disagg.REPLICA_CLASSES:
            lines.append(f'router_pool_replicas{{class="{c}"}} '
                         f"{pools[c]}\n")
        totals: "OrderedDict[str, float]" = OrderedDict()
        with self._mu:
            alive = {r.index: r.alive for r in self.replicas}

        def fetch(url: str, out: dict, idx: int) -> None:
            try:
                with urllib.request.urlopen(f"{url}/metrics",
                                            timeout=2.0) as r:
                    out[idx] = parse_metrics_text(
                        r.read().decode("utf-8", "replace"))
            except Exception:   # noqa: BLE001 — a dead replica drops out
                pass

        # Fetch replicas in PARALLEL, skipping known-dead ones: a
        # monitoring poll must pay one slow replica's latency at most
        # once, not 2 s x N serially — and a poll during an incident is
        # exactly when the aggregate matters. (The scrape loop flips a
        # dead replica back alive within one interval of recovery.)
        snaps: dict = {}
        fetchers = [threading.Thread(target=fetch, args=(url, snaps, idx))
                    for idx, url, _, _, _ in reps if alive.get(idx)]
        for t in fetchers:
            t.start()
        for t in fetchers:
            t.join(timeout=2.5)
        for idx, url, _, _, _ in reps:
            snap = snaps.get(idx)
            if snap is None:
                continue
            for series, v in snap.items():
                base = series.split("{", 1)[0]
                typeline(base)
                label = f'replica="{idx}"'
                lines.append(f"{_merge_label(series, label)} {v}\n")
                if _fleet_additive(series):
                    totals[series] = totals.get(series, 0.0) + v
        # Fleet totals AFTER the per-replica series so scrapers see the
        # labeled breakdown first; same series key, no replica label.
        # The router's own failovers fold into the fleet
        # retry_attempts_total (every replica exports the series, so the
        # unlabeled sum already exists — a second unlabeled row would be
        # invalid exposition).
        if "retry_attempts_total" in totals:
            totals["retry_attempts_total"] += _backoff.retries_total()
        else:
            typeline("retry_attempts_total")
            totals["retry_attempts_total"] = float(_backoff.retries_total())
        for series, v in totals.items():
            lines.append(f"{series} {v}\n")
        text += "".join(lines)
        return Response(200, text, content_type="text/plain; version=0.0.4")

    # -- draining = migration ------------------------------------------------

    def _find_replica(self, body: dict) -> Optional[_Replica]:
        sel = body.get("replica")
        for rep in self._replica_snapshot():
            if sel == rep.index or sel == str(rep.index) or sel == rep.url:
                return rep
        return None

    def _forward_drain(self, rep: _Replica, draining: bool) -> None:
        """Flip the replica's OWN drain hook so its /readyz answers
        draining for any other balancer watching it. Best-effort: a
        replica that predates the hook still drains router-side."""
        verb = "drain" if draining else "undrain"
        try:
            up = urllib.request.Request(f"{rep.url}/admin/{verb}",
                                        data=b"{}", method="POST")
            with urllib.request.urlopen(up, timeout=2.0) as r:
                r.read()
        except Exception as e:  # noqa: BLE001
            log.warning("replica %d %s forward failed: %s",
                        rep.index, verb, e)

    def _drain_replica(self, rep: _Replica, draining: bool) -> dict:
        """Drain (with live session migration) or undrain one replica —
        the shared body of POST /admin/drain|undrain and the
        autoscaler's retire path."""
        with self._mu:
            rep.draining = draining
        self._forward_drain(rep, draining)
        out: dict = {"status": "drain" if draining else "undrain",
                     "replica": rep.index}
        if draining:
            # Drain-as-migration: by the time this returns, every open
            # session the replica homed lives on another replica (or is
            # explicitly accounted as left-behind) — completing the
            # drain AFTER the move is what makes it lossless.
            out["migration"] = self._migrate_sessions(rep)
        log.info("replica %d (%s) %s", rep.index, rep.url,
                 "draining" if draining else "undrained")
        return out

    def _admin_drain(self, req: Request) -> Response:
        return self._set_drain(req, True)

    def _admin_undrain(self, req: Request) -> Response:
        return self._set_drain(req, False)

    def _set_drain(self, req: Request, draining: bool) -> Response:
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        rep = self._find_replica(body if isinstance(body, dict) else {})
        if rep is None:
            return Response(404, {"error": "no such replica; pass "
                                           '{"replica": <index or url>}'})
        return Response(200, self._drain_replica(rep, draining))

    # -- live session migration ----------------------------------------------

    def _wait_inflight_drained(self, rep: _Replica) -> None:
        """Wait (bounded by SERVE_ROUTER_DRAIN_WAIT_S) for the draining
        replica's in-flight streams to finish: a stream completing
        AFTER the migration pass would retain its session on the source
        — parked but never exported. Polls the replica's own
        serve_inflight_requests gauge (summed across model labels)."""
        deadline = time.monotonic() + max(0.0, self.drain_wait_s)
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"{rep.url}/metrics",
                                            timeout=2.0) as r:
                    snap = parse_metrics_text(
                        r.read().decode("utf-8", "replace"))
            except Exception:   # noqa: BLE001 — replica gone: stop waiting
                return
            inflight = sum(v for k, v in snap.items()
                           if k == "serve_inflight_requests"
                           or k.startswith("serve_inflight_requests{"))
            if inflight <= 0:
                return
            time.sleep(0.1)
        log.warning("replica %d still has in-flight streams after "
                    "%.0fs; migrating what is parked", rep.index,
                    self.drain_wait_s)

    def _session_keys(self, rep: _Replica) -> Optional[list[str]]:
        """The replica's open-session keys, or None when it has no
        session tier (501/404) or is unreachable."""
        try:
            with urllib.request.urlopen(f"{rep.url}/admin/session",
                                        timeout=5.0) as r:
                return list((json.loads(r.read()).get("sessions")
                             or {}).keys())
        except urllib.error.HTTPError as e:
            e.close()
            return None
        except Exception:   # noqa: BLE001 — unreachable
            return None

    def _migrate_sessions(self, rep: _Replica) -> dict:
        """Move every open session off ``rep`` to the best eligible
        replica: wait out in-flight streams, park-all on the source,
        then per session — destination PULLS the payload
        (POST /admin/session/import {"from", "key"}; KV bytes flow
        replica-to-replica), source forgets ONLY on the ack, affinity
        flips atomically. A failed step (the serve.kv_tier.export/import
        and serve.router.migrate failpoints land here) leaves BOTH
        replicas consistent: the source keeps the session, the counter
        and a log line record it, and the client sees nothing — its
        next turn cold re-prefills at worst."""
        out = {"migrated": 0, "failed": 0, "dest": None, "sessions": 0}
        if self._session_keys(rep) is None:
            return out              # no tier on this replica: nothing owed
        self._wait_inflight_drained(rep)
        try:
            up = urllib.request.Request(
                f"{rep.url}/admin/session/park_all", data=b"{}",
                method="POST")
            with urllib.request.urlopen(up, timeout=60.0) as r:
                r.read()
        except Exception as e:  # noqa: BLE001 — park what it can
            log.warning("replica %d park_all failed: %s", rep.index, e)
        keys = self._session_keys(rep) or []
        out["sessions"] = len(keys)
        if not keys:
            return out
        dests = [d for d in self._eligible() if d.index != rep.index]
        if not dests:
            log.warning("no eligible replica to migrate %d session(s) "
                        "off replica %d; they stay parked there",
                        len(keys), rep.index)
            return out
        dst = dests[0]
        out["dest"] = dst.index
        for key in keys:
            t0 = time.monotonic()
            try:
                failpoint("serve.router.migrate")
                imp = urllib.request.Request(
                    f"{dst.url}/admin/session/import",
                    data=json.dumps({"from": rep.url, "key": key}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(imp, timeout=60.0) as r:
                    r.read()
            except Exception as e:  # noqa: BLE001 — source keeps the session
                self._m_migration_failed.inc()
                out["failed"] += 1
                log.warning("session %s migration %s -> %s failed (%s); "
                            "source retains it", key, rep.url, dst.url, e)
                continue
            # Destination ack'd: NOW the source may drop its copy (a
            # failed forget merely leaves a redundant parked copy the
            # source's cost eviction will age out — harmless).
            try:
                fg = urllib.request.Request(
                    f"{rep.url}/admin/session/forget",
                    data=json.dumps({"key": key}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(fg, timeout=5.0) as r:
                    r.read()
            except Exception as e:  # noqa: BLE001
                log.warning("session %s forget on %s failed: %s", key,
                            rep.url, e)
            # Affinity flip: the tier keys ARE the affinity keys
            # ("sid:<id>" strips to the raw id the router keys on;
            # "head:<hash>" matches the shared context-head derivation
            # in session_key) — the next turn routes straight to the
            # session's new home.
            akey = key[4:] if key.startswith("sid:") else key
            with self._mu:
                self._sessions[akey] = dst.index
                self._sessions.move_to_end(akey)
            self._m_migrated.inc()
            self._m_migration_ms.observe((time.monotonic() - t0) * 1e3)
            out["migrated"] += 1
        if out["migrated"] or out["failed"]:
            log.info("replica %d drain migrated %d/%d session(s) to "
                     "replica %d (%d failed, retained at source)",
                     rep.index, out["migrated"], out["sessions"],
                     dst.index, out["failed"])
        return out

    def _note_replica_death(self, rep: _Replica) -> None:
        """A replica stopped answering: every session homed on it
        rehomes NOW. Their parked payloads died with the process (or
        are unreachable behind it) — each follow-up turn lands on a
        healthy replica and cold re-prefills from the client's own
        context round-trip. Bounded extra compute, a log line, and the
        lost-vs-migrated ledger; NEVER an error to the client.

        The ledger counts the replica's LAST-SCRAPED open-session list
        (``_Replica.sessions``) — the KV that actually existed — not
        the affinity entries, which miss sessions past the LRU cap (or
        all of them with affinity off) and count conversations that
        never had parked KV."""
        with self._mu:
            homed = [k for k, v in self._sessions.items()
                     if v == rep.index]
            for k in homed:
                del self._sessions[k]
            lost = len(rep.sessions or ())
            rep.sessions = None     # counted once; a respawn starts clean
        if lost:
            self._m_lost.inc(lost)
        if lost or homed:
            log.warning(
                "replica %d (%s) died with %d open session(s) (%d "
                "affinity entries dropped); follow-ups rehome and cold "
                "re-prefill (kv_sessions_lost_total ledger — no client "
                "errors)", rep.index, rep.url, lost, len(homed))

    # -- elastic fleet (autoscaler surface) ----------------------------------

    def add_replica(self, url: str) -> _Replica:
        """Grow the fleet: the new replica joins not-alive/not-ready and
        starts taking traffic once the scrape loop sees its /readyz —
        warmup gating composes with scaling for free."""
        with self._mu:
            rep = _Replica(url=url.rstrip("/"), index=self._next_index)
            self._next_index += 1
            self.replicas.append(rep)
        log.info("fleet grew: replica %d (%s) joined", rep.index, rep.url)
        return rep

    def remove_replica(self, rep: _Replica) -> None:
        """Forget a replica (after retirement drained + migrated it).
        Affinity entries still pointing at it drop so their sessions
        rebalance."""
        with self._mu:
            self.replicas = [r for r in self.replicas if r is not rep]
            for k in [k for k, v in self._sessions.items()
                      if v == rep.index]:
                del self._sessions[k]
        log.info("fleet shrank: replica %d (%s) removed", rep.index,
                 rep.url)

    def retire_replica(self, rep: _Replica, stop_fn=None) -> None:
        """Scale-down = drain-as-migration, then removal: every session
        the replica homed moves first, so retirement is invisible to
        clients. ``stop_fn(url)`` tears the process down (the spawner's
        job; None = the operator owns it — it is left drained)."""
        self._drain_replica(rep, True)
        if stop_fn is not None:
            try:
                stop_fn(rep.url)
            except Exception:   # noqa: BLE001 — removal proceeds
                log.exception("replica %d stop callback failed", rep.index)
        self.remove_replica(rep)

    def _admin_replicas(self, req: Request) -> Response:
        with self._mu:
            return Response(200, {
                "replicas": [r.snapshot() for r in self.replicas],
                "sessions": len(self._sessions)})

    def attach_autoscaler(self, autoscaler: "Autoscaler") -> None:
        """Install the queue-driven autoscaler (ticked by the scrape
        loop; scrape-thread-only state lives inside it)."""
        self.autoscaler = autoscaler

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaRouter":
        self._server = HttpServer(self.router, self.addr_cfg).start()
        reps = self._replica_snapshot()
        log.info("replica router on %s over %d replicas: %s",
                 self._server.addr, len(reps),
                 ", ".join(r.url for r in reps))
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
        if self.autoscaler is not None:
            self.autoscaler.close()
        if self._server:
            self._server.stop()


class Autoscaler:
    """Queue-driven elastic fleet: spawn replicas under sustained
    backpressure, retire them (through drain-as-migration) when the
    fleet idles.

    The policy reads the SAME scraped signals routing weights on (the
    replicas' backpressure: per-replica ``serve_queue_depth`` + router-side
    inflight, and the shed-counter-moved flag): pressure = total
    depth / eligible replicas. Pressure above ``up_q`` — or ANY replica
    actively shedding — for ``sustain`` consecutive scrape passes scales
    up (one replica per trigger; the streak resets, so a warming replica
    gets time to absorb load before the next spawn). Pressure below
    ``down_q`` for ``sustain`` passes scales down by ONE replica, least
    load first, retirement always through
    :meth:`ReplicaRouter.retire_replica` so scaling down is invisible to
    clients. The fleet never shrinks below ``min_replicas`` eligible
    replicas or grows past ``max_replicas`` total.

    ``spawn_fn()`` returns the new replica's base URL (or None to skip);
    ``retire_fn(url)`` tears its process down; ``can_retire_fn(url)``
    limits victims (the process spawner only retires replicas it
    spawned — boot replicas belong to the operator). All state is
    scrape-thread-only (tick runs there exclusively)."""

    def __init__(self, spawn_fn, retire_fn=None, can_retire_fn=None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 up_q: Optional[float] = None,
                 down_q: Optional[float] = None,
                 sustain: Optional[int] = None) -> None:
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        self.can_retire_fn = can_retire_fn or (lambda url: True)
        self.min_replicas = (min_replicas if min_replicas is not None
                             else env_int("SERVE_ROUTER_AUTOSCALE_MIN", 1))
        self.max_replicas = (max_replicas if max_replicas is not None
                             else env_int("SERVE_ROUTER_AUTOSCALE_MAX", 4))
        self.up_q = (up_q if up_q is not None
                     else env_float("SERVE_ROUTER_AUTOSCALE_UP_Q", 4.0))
        self.down_q = (down_q if down_q is not None
                       else env_float("SERVE_ROUTER_AUTOSCALE_DOWN_Q", 0.5))
        self.sustain = (sustain if sustain is not None
                        else env_int("SERVE_ROUTER_AUTOSCALE_SUSTAIN", 3))
        self._up_streak = 0       # owned-by: tick (scrape thread)
        self._down_streak = 0     # owned-by: tick (scrape thread)
        # A retirement in flight (drain-as-migration runs seconds to
        # minutes): it runs OFF the scrape thread so fleet health keeps
        # scraping, and this event keeps a second retire (or a
        # conflicting spawn decision) from racing it.
        self._retiring = threading.Event()

    def tick(self, router: ReplicaRouter) -> None:
        """One policy evaluation (scrape thread, after each pass)."""
        with router._mu:
            # Capacity counts LIVE replicas plus still-WARMING spawns
            # (never answered a scrape yet) — a replica that DIED must
            # not hold a capacity slot, or a crash at max_replicas
            # would block its own replacement forever.
            n_capacity = sum(1 for r in router.replicas
                             if r.alive or not r.ever_alive)
            elig = [r for r in router.replicas
                    if r.alive and r.ready and not r.draining]
            depth = sum(r.queue_depth + r.inflight for r in elig)
            shedding = any(r.shedding for r in elig)
            loads = {r.index: r.queue_depth + r.inflight for r in elig}
            urls = {r.index: r.url for r in elig}
        if self._retiring.is_set():
            return                  # let the in-flight retire settle first
        pressure = depth / max(1, len(elig))
        if ((pressure > self.up_q or shedding)
                and n_capacity < self.max_replicas):
            self._up_streak += 1
            self._down_streak = 0
            if self._up_streak >= self.sustain:
                self._up_streak = 0
                url = self.spawn_fn()
                if url:
                    router.add_replica(url)
                    router._m_scale_up.inc()
                    log.info("autoscale up: pressure %.1f (shedding=%s) "
                             "-> spawned %s", pressure, shedding, url)
        elif (elig and not shedding and pressure < self.down_q
                and len(elig) > self.min_replicas):
            self._down_streak += 1
            self._up_streak = 0
            if self._down_streak >= self.sustain:
                self._down_streak = 0
                victims = sorted(
                    (load, idx) for idx, load in loads.items()
                    if self.can_retire_fn(urls[idx]))
                if victims:
                    _, idx = victims[0]
                    rep = next((r for r in router._replica_snapshot()
                                if r.index == idx), None)
                    if rep is not None:
                        self._retire_async(router, rep, pressure)
        else:
            self._up_streak = 0
            self._down_streak = 0

    def _retire_async(self, router: ReplicaRouter, rep: _Replica,
                      pressure: float) -> None:
        """Run the retirement (drain-as-migration + process stop) on its
        own thread: _wait_inflight_drained + park_all + per-session
        pulls can take minutes, and the scrape loop must keep the
        routing table fresh — ESPECIALLY while the fleet is changing."""
        log.info("autoscale down: pressure %.2f -> retiring replica %d "
                 "(%s)", pressure, rep.index, rep.url)
        self._retiring.set()

        def _run() -> None:
            try:
                router.retire_replica(rep, stop_fn=self.retire_fn)
                router._m_scale_down.inc()
            except Exception:   # noqa: BLE001 — next tick re-evaluates
                log.exception("replica %d retirement failed", rep.index)
            finally:
                self._retiring.clear()

        threading.Thread(target=_run, daemon=True,
                         name="autoscale-retire").start()

    def close(self) -> None:
        fn = getattr(self.spawn_fn, "stop_all", None)
        if callable(fn):
            fn()


class ProcessReplicaSpawner:
    """The env-path spawner (``SERVE_ROUTER_AUTOSCALE=1``): replicas as
    ``python -m p2p_llm_chat_tpu_torch.serve`` subprocesses on successive
    ports from ``SERVE_ROUTER_AUTOSCALE_PORT_BASE``, inheriting the
    router's environment (minus the mode flags a replica must never
    see) — so SERVE_BACKEND/CKPT_DIR/SERVE_KV*/SERVE_DEVICE flow through
    and a spawned replica is a full-stack engine of the port, on the
    card unless ``SERVE_DEVICE=cpu``. Retirement only applies to
    replicas this spawner created; boot upstreams are the operator's.

    The one deliberate divergence from the reference's spawner: it
    starts the port's entry, not ``p2p_llm_chat_tpu.serve.api``, so an
    elastic fleet of the port grows port replicas. And
    :meth:`stop_all` reaps its children before it returns (the router
    process exits right after it on SIGTERM)."""

    def __init__(self, port_base: Optional[int] = None,
                 env_extra: Optional[dict] = None,
                 max_ports: int = 0) -> None:
        self.port_base = (port_base if port_base is not None else
                          env_int("SERVE_ROUTER_AUTOSCALE_PORT_BASE",
                                  11500))
        # Extra child env (the disagg ClassAutoscaler tags spawns with
        # SERVE_REPLICA_CLASS through this).
        self.env_extra = dict(env_extra or {})
        # Hard bound on the port range this spawner may bind (0 =
        # unbounded, the single-pool legacy). Crash-killed spawns leak
        # their port slot (only retire() reaps), so an UNbounded
        # monotonic walk would eventually cross into a sibling
        # spawner's range — with per-class spawners on adjacent ranges
        # that is an Address-already-in-use loop. Bounded, a leaked
        # range means a skipped spawn (logged; the pressure persists
        # and the next tick retries), never a cross-range bind.
        self.max_ports = max_ports
        self._mu = threading.Lock()
        self._n = 0                           # guarded-by: _mu
        self._procs: dict[str, object] = {}   # guarded-by: _mu (url -> Popen)
        # Ports whose retired process has been REAPED (exit observed):
        # reused lowest-first, so the spawner stays inside the port
        # range a launcher's collision check reserved — a monotonic
        # walk would leave it after max_replicas lifetime spawns.
        self._free_ports: list[int] = []      # guarded-by: _mu

    def __call__(self) -> Optional[str]:
        import os
        import subprocess
        import sys
        with self._mu:
            if self._free_ports:
                self._free_ports.sort()
                port = self._free_ports.pop(0)
            elif self.max_ports and self._n >= self.max_ports:
                port = None     # range exhausted by crash-leaked slots
            else:
                port = self.port_base + self._n
                self._n += 1
        if port is None:
            log.warning("spawner port range [%d, %d) exhausted (crash-"
                        "killed spawns leak their slot until reaped); "
                        "skipping this spawn", self.port_base,
                        self.port_base + self.max_ports)
            return None
        url = f"http://127.0.0.1:{port}"
        env = {**os.environ,
               "SERVE_ADDR": f"127.0.0.1:{port}",
               "SERVE_ROUTER_UPSTREAMS": "",
               "SERVE_COORDINATOR": "",
               **self.env_extra}
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"],
                env=env)
        except Exception:   # noqa: BLE001 — a failed spawn skips the pass
            log.exception("autoscale replica spawn failed")
            return None
        with self._mu:
            self._procs[url] = proc
        return url

    def can_retire(self, url: str) -> bool:
        with self._mu:
            return url in self._procs

    def retire(self, url: str) -> None:
        with self._mu:
            p = self._procs.pop(url, None)
        if p is None:
            return
        p.terminate()
        # Reap on a side thread with a kill escalation: terminate alone
        # leaks a zombie per scale-down (Popen never waited), and a
        # wedged replica that ignores SIGTERM would live forever. The
        # port returns to the pool only after the exit is OBSERVED —
        # rebinding earlier races the dying listener.
        threading.Thread(target=self._reap, args=(url, p), daemon=True,
                         name="replica-reap").start()

    def _reap(self, url: str, p) -> None:
        import subprocess
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                log.warning("retired replica %s ignored SIGKILL; "
                            "abandoning (port not reused)", url)
                return
        try:
            port = int(url.rsplit(":", 1)[1])
        except ValueError:
            return
        with self._mu:
            self._free_ports.append(port)

    def stop_all(self) -> None:
        """Terminate every child, then reap each (kill after 10 s)."""
        with self._mu:
            procs = list(self._procs.items())
            self._procs.clear()
        for _, p in procs:
            p.terminate()
        for url, p in procs:
            self._reap(url, p)


def build_router_from_env() -> ReplicaRouter:
    ups = [u.strip() for u in
           env_or("SERVE_ROUTER_UPSTREAMS", "").split(",") if u.strip()]
    if not ups:
        raise SystemExit("SERVE_ROUTER_UPSTREAMS must list at least one "
                         "replica URL (comma-separated)")
    router = ReplicaRouter(ups)
    if env_bool("SERVE_ROUTER_AUTOSCALE", False):
        if (env_int("SERVE_PREFILL_REPLICAS", 0)
                or env_int("SERVE_DECODE_REPLICAS", 0)):
            # Class-tagged fleet (SERVE_PREFILL/DECODE_REPLICAS): the
            # pools scale INDEPENDENTLY — prefill on admission-queue
            # pressure, decode on stream/slot occupancy
            # (serve/disagg.py policy table in docs/serving.md).
            router.attach_autoscaler(_disagg.build_class_autoscaler())
            log.info("per-class autoscaler armed: %d..%d replicas PER "
                     "CLASS, up>%.1f, down<%.1f, sustain %d passes",
                     router.autoscaler.min_replicas,
                     router.autoscaler.max_replicas,
                     router.autoscaler.up_q, router.autoscaler.down_q,
                     router.autoscaler.sustain)
        else:
            spawner = ProcessReplicaSpawner()
            router.attach_autoscaler(Autoscaler(
                spawn_fn=spawner, retire_fn=spawner.retire,
                can_retire_fn=spawner.can_retire))
            log.info("autoscaler armed: %d..%d replicas, up>%.1f "
                     "req/replica or shedding, down<%.1f, sustain %d "
                     "passes",
                     router.autoscaler.min_replicas,
                     router.autoscaler.max_replicas,
                     router.autoscaler.up_q, router.autoscaler.down_q,
                     router.autoscaler.sustain)
    return router


def main() -> None:
    build_router_from_env().serve_forever()


if __name__ == "__main__":
    main()
