"""Per-user P2P chat node daemon.

The port's copy of ``p2p_llm_chat_tpu/node.py``: the same wire bytes and
behaviour, so port and reference peers mix in one fleet; the port imports
nothing of the reference package.

Reference: go/cmd/node/main.go. One process per user composing:

- a P2P host with a chat stream handler on ``/p2p-llm-chat/1.0.0``
  (ChatProtocolID, main.go:48; handler main.go:158-172),
- an in-memory append-only Inbox (main.go:97-128),
- a DirectoryClient that registers on startup — fatal on failure
  (main.go:183-184) — and resolves recipients on send (main.go:225),
- a local HTTP API for the UI: ``POST /send`` (main.go:219-265),
  ``GET /inbox?after=`` (main.go:267-270), ``GET /me`` (main.go:272-278).

Env config (exact names from main.go:131-134): ``MYNAMEIS``, ``HTTP_ADDR``,
``DIRECTORY_URL``, ``BOOTSTRAP_ADDRS``; additive: ``P2P_ADDR`` (p2p listen
address, default 127.0.0.1:0), ``RELAY_ADDRS`` (comma-separated relay
multiaddrs to hold reservations on — the reference ships a relay daemon but
never wires it into the node, SURVEY.md §2 C6), ``IDENTITY_FILE`` (persist
the keypair; reference regenerates per start, README.md:134).

Deliberate fix (documented surface change): ``GET /me`` returns the base58
peer id string — the reference returns raw peer-ID bytes there
(``string(h.ID())``, main.go:275), an acknowledged quirk (SURVEY.md §2).

Directory resilience (additive — the directory is the acknowledged single
point of failure, reference README.md:135): successful lookups are cached
and served stale when the directory is down, so peers that have already
talked keep exchanging messages through an outage; and the node
re-registers on a background interval with exponential backoff
(``NODE_REREGISTER_S``, default 30 s, 0 disables), so a restarted
directory — it is in-memory, losing every record (SURVEY.md §2 C5) —
relearns the node without operator action. Startup registration stays
fatal-on-failure (main.go:184 parity).

DHT rung (additive): the reference constructs a kad-DHT it never routes
with (go/cmd/node/main.go:151, errors non-fatal at :153). Here the
from-scratch Kademlia (p2p/dht.py) is the THIRD rung of the lookup
ladder — directory -> cached record -> DHT — so never-before-paired
peers still resolve each other through a directory outage. The node
publishes its signed address record to the DHT on registration and on
every re-register tick. Env: ``DHT_ADDR`` (UDP listen, default
``127.0.0.1:0``; ``off`` disables), ``DHT_BOOTSTRAP`` (comma-separated
``host:port`` seeds). All DHT failures are non-fatal (reference :153
parity); ``GET /me`` exposes ``dht_addr`` so deployments can chain
bootstrap seeds without extra config.

NAT-PMP (parity with ``libp2p.NATPortMap()``, main.go:143): on by
default, best-effort, background — maps the p2p listen port on the
gateway (p2p/natpmp.py, RFC 6886) and advertises the external address
in directory/DHT records; renews at half-lifetime from the re-register
loop; releases on stop. ``NATPMP=0`` disables, ``NATPMP_GATEWAY``
overrides gateway discovery.

At-least-once delivery (additive — the reference tries each addr once
and drops the message, SURVEY.md §2 C5): every outgoing message carries
a sender-minted ``msg_id`` (proto.mint_msg_id) and the chat stream
grows an ack frame — the receiver acks after the inbox push, dedups
redelivered copies by ``msg_id``, and the sender parks unacked messages
in a bounded per-recipient **Outbox** (``P2P_OUTBOX_MAX`` messages per
peer, ``P2P_OUTBOX_TTL_S`` seconds). A redelivery worker retries on the
utils/backoff jittered schedule and RE-RESOLVES the recipient each
round (directory first, then the DHT rung — a queued message usually
means the peer moved or restarted, so stale addrs must refresh before
the next dial). ``POST /send`` answers ``{"status": "queued"}`` when
the peer is down instead of a 502, and ``stop()`` attempts one final
outbox flush, then deregisters from the directory (the DHT record
expires via its own TTL). Peers that predate the ack frame close the
stream without answering — EOF counts as legacy-delivered, keeping the
wire compatible in both directions. Drops (TTL lapse, overflow) are
counted on ``GET /metrics`` as ``p2p_messages_dropped_total``;
docs/robustness.md §Peer lifecycle has the state machine.
"""

from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Optional

from .directory import DirectoryClient
from .inbox import Inbox
from .obs import trace as _trace
from .utils.backoff import Backoff
from .p2p import Identity, Multiaddr, P2PHost
from .p2p.dht import DHTNode, parse_seeds
from .p2p.natpmp import PortMapper
from .p2p.transport import SecureStream
from .proto import ChatMessage, ack_frame, mint_msg_id, now_rfc3339, parse_ack
from .utils import failpoints as _fp
from .utils.env import env_float, env_int, env_or
from .utils.failpoints import failpoint
from .utils.http import HttpServer, Request, Response, Router
from .utils.log import get_logger
from .utils.metrics import Registry

log = get_logger("node")

CHAT_PROTOCOL_ID = "/p2p-llm-chat/1.0.0"   # go/cmd/node/main.go:48


class Outbox:
    """Bounded per-recipient queue of sent-but-unacked messages.

    Locking: ``_mu`` guards the tables and is NEVER held across network
    I/O — the redelivery worker snapshots under the lock, dials
    unlocked, then removes delivered entries under the lock again.
    Rounds themselves are serialized by the node's ``_flush_mu``, so a
    message is never dialed twice concurrently (and even a duplicate
    dial is idempotent at the receiver via msg_id dedup).
    """

    def __init__(self, max_per_peer: int, ttl_s: float) -> None:
        self.max_per_peer = max(1, max_per_peer)
        self.ttl_s = ttl_s
        self._mu = threading.Lock()
        # recipient -> deque[(msg, enqueued_at_monotonic)], send order
        self._pending: dict[str, collections.deque] = {}  # guarded-by: _mu

    def put(self, msg: ChatMessage) -> list[ChatMessage]:
        """Enqueue for redelivery; returns the OLDEST entries dropped to
        make room at the per-peer bound (overflow accounting)."""
        dropped: list[ChatMessage] = []
        with self._mu:
            q = self._pending.setdefault(msg.to_user, collections.deque())
            while len(q) >= self.max_per_peer:
                dropped.append(q.popleft()[0])
            q.append((msg, time.monotonic()))
        return dropped

    def expire(self, now: float) -> list[ChatMessage]:
        """Drop entries older than ``ttl_s``; returns them (TTL
        accounting). The queue head is the oldest, so one front-scan per
        recipient suffices."""
        out: list[ChatMessage] = []
        with self._mu:
            for user in list(self._pending):
                q = self._pending[user]
                while q and now - q[0][1] > self.ttl_s:
                    out.append(q.popleft()[0])
                if not q:
                    del self._pending[user]
        return out

    def snapshot(self) -> dict[str, list[tuple[ChatMessage, float]]]:
        with self._mu:
            return {u: list(q) for u, q in self._pending.items()}

    def remove(self, user: str, msg_id: str) -> Optional[float]:
        """Remove a delivered message; returns its enqueue time (for the
        delivery-latency observation), or None when already gone."""
        with self._mu:
            q = self._pending.get(user)
            if not q:
                return None
            for i, (m, t0) in enumerate(q):
                if m.msg_id == msg_id:
                    del q[i]
                    if not q:
                        del self._pending[user]
                    return t0
        return None

    def depth(self) -> int:
        with self._mu:
            return sum(len(q) for q in self._pending.values())

    def has(self, user: str) -> bool:
        with self._mu:
            return bool(self._pending.get(user))


class ChatNode:
    def __init__(
        self,
        username: Optional[str] = None,
        http_addr: Optional[str] = None,
        directory_url: Optional[str] = None,
        bootstrap_addrs: Optional[str] = None,
        p2p_addr: Optional[str] = None,
        relay_addrs: Optional[str] = None,
        identity_file: Optional[str] = None,
        inbox_cap: Optional[int] = None,
        dht_addr: Optional[str] = None,
        dht_bootstrap: Optional[str] = None,
    ) -> None:
        # Eager FAIL_POINTS parse: malformed chaos config fails at boot.
        from .utils.failpoints import load_env as load_failpoints_env
        load_failpoints_env()
        # Env-var defaults keep the reference's exact config surface
        # (go/cmd/node/main.go:131-134).
        self.username = username if username is not None else env_or("MYNAMEIS", "anon")
        self.http_addr = http_addr if http_addr is not None else env_or("HTTP_ADDR", ":8081")
        self.directory_url = (directory_url if directory_url is not None
                              else env_or("DIRECTORY_URL", "http://127.0.0.1:8080"))
        self.bootstrap_addrs = (bootstrap_addrs if bootstrap_addrs is not None
                                else env_or("BOOTSTRAP_ADDRS", ""))
        self.relay_addrs = (relay_addrs if relay_addrs is not None
                            else env_or("RELAY_ADDRS", ""))
        p2p_listen = p2p_addr if p2p_addr is not None else env_or("P2P_ADDR", "127.0.0.1:0")
        ident = Identity.load_or_generate(
            identity_file if identity_file is not None else env_or("IDENTITY_FILE", "") or None
        )
        self.host = P2PHost(identity=ident, listen_addr=p2p_listen)
        self.inbox = Inbox(max_messages=inbox_cap)
        self.dir = DirectoryClient(self.directory_url)
        dht_addr = dht_addr if dht_addr is not None else env_or("DHT_ADDR", "127.0.0.1:0")
        self.dht: Optional[DHTNode] = None
        if dht_addr.lower() not in ("off", "0", ""):
            try:
                self.dht = DHTNode(ident, dht_addr)
            except (ValueError, OSError) as e:
                # Bad addr / port taken: degrade, don't crash — every DHT
                # failure is non-fatal (go/cmd/node/main.go:153 parity).
                log.warning("DHT disabled: cannot bind %r (%s)", dht_addr, e)
        self.dht_bootstrap = (dht_bootstrap if dht_bootstrap is not None
                              else env_or("DHT_BOOTSTRAP", ""))
        # NAT-PMP port mapping (libp2p.NATPortMap() parity, main.go:143):
        # on by default like the reference, best-effort — no cooperative
        # gateway just means punch/relay carry reachability instead.
        # NATPMP=0 disables; NATPMP_GATEWAY=host[:port] overrides discovery
        # (used by tests to point at a fake gateway).
        self._natpmp_enabled = env_or("NATPMP", "1") not in ("0", "off", "")
        self._natpmp_gateway = env_or("NATPMP_GATEWAY", "")
        self._mapper: Optional[PortMapper] = None
        self._nat_ext: Optional[tuple[str, int]] = None
        self.reregister_s = float(env_or("NODE_REREGISTER_S", "30"))
        self._lookup_cache: dict[str, object] = {}
        self._cache_mu = threading.Lock()
        self._closed = threading.Event()
        # At-least-once delivery state (module docstring): the unacked
        # outbox, the per-sender msg_id sequence, and the drop ledger.
        self.outbox = Outbox(env_int("P2P_OUTBOX_MAX", 128),
                             env_float("P2P_OUTBOX_TTL_S", 300.0))
        self._outbox_kick = threading.Event()
        # Serializes redelivery rounds (worker tick vs stop()'s final
        # flush). Held across dials BY DESIGN — it is a round mutex, not
        # a data lock; outbox._mu nests strictly inside it.
        self._flush_mu = threading.Lock()
        self._seq_mu = threading.Lock()
        self._send_seq = 0                       # guarded-by: _seq_mu
        # Per-boot salt for msg_id minting: _send_seq restarts at 0
        # with the process, so ids must carry a per-incarnation nonce
        # or a post-restart send repeating an earlier (seq, content)
        # pair would re-mint an old id and get dedup-suppressed by a
        # receiver that stayed up (silent loss of a NEW message).
        self._boot_nonce = uuid.uuid4().hex
        self._drop_mu = threading.Lock()
        self._dropped = {"ttl": 0, "overflow": 0}  # guarded-by: _drop_mu
        self.metrics = Registry()
        self._m_outbox_depth = self.metrics.gauge("p2p_outbox_depth")
        self._m_redelivered = self.metrics.counter("p2p_redelivered_total")
        self._m_dedup = self.metrics.counter("p2p_dedup_suppressed_total")
        self._m_delivery_ms = self.metrics.histogram("p2p_delivery_ms")
        self._http: Optional[HttpServer] = None
        self.router = Router()
        self.router.add("POST", "/send", self._handle_send)
        self.router.add("GET", "/inbox", self._handle_inbox)
        self.router.add("GET", "/me", self._handle_me)
        self.router.add("GET", "/metrics", self._handle_metrics)
        self.router.add("GET", "/healthz", lambda r: Response(200, {"status": "ok"}))
        # grafttrace (obs/trace.py): /send is a chat-plane INGRESS — it
        # parses or mints a trace context per message and records the
        # node.send span (lookup ladder + delivery, with the winning
        # leg's via=direct|relay meta). Same bounded store + listing
        # contract as the serve fronts.
        self.trace = _trace.TraceStore(replica=f"node:{self.username}")
        self.router.add("GET", "/admin/trace", self._handle_trace)

    # -- p2p side ------------------------------------------------------------

    def _on_chat_stream(self, stream: SecureStream, remote_peer_id: str) -> None:
        """Inbound chat message: read whole stream until the sender half-
        closes, parse one JSON ChatMessage, push to inbox
        (go/cmd/node/main.go:158-172). Messages carrying a ``msg_id``
        get an ack frame back on the same (full-duplex) stream AFTER the
        inbox push — a redelivered duplicate is suppressed by the inbox
        but STILL acked, because the original delivery already won and
        the sender only needs to stop retrying."""
        try:
            raw = stream.read_all()
            if not raw:
                return
            msg = ChatMessage.from_json(raw)
            fresh = self.inbox.push(msg)
            if fresh:
                log.info("inbox <- %s: %r (from peer %s)",
                         msg.from_user, msg.content[:60], remote_peer_id[:12])
            else:
                self._m_dedup.inc()
                log.info("dedup: suppressed duplicate %s from %s",
                         msg.msg_id[:12], msg.from_user)
            if msg.msg_id:
                stream.send_frame(ack_frame(msg.msg_id))
        except (ValueError, OSError) as e:
            log.warning("bad chat stream from %s: %s", remote_peer_id[:12], e)
        finally:
            stream.close()

    # -- HTTP API ------------------------------------------------------------

    def _handle_send(self, req: Request) -> Response:
        """POST /send {to_username, content} (go/cmd/node/main.go:219-265)."""
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        to_username = str(body.get("to_username") or "")
        content = str(body.get("content") or "")
        if not to_username or not content:
            return Response(400, {"error": "to_username and content required"})

        # node.send covers the whole send path — lookup ladder + the
        # delivery walk — and its ``via`` meta names the winning leg
        # (relay vs direct), so a relay-path SLO breach attributes to
        # the p2p phase with the leg visible. The trace id echoes in
        # the response so a client (loadgen) can fetch the timeline.
        tctx = _trace.parse_header(req.headers.get(_trace.HEADER_LC))
        if tctx is None:
            tctx = _trace.mint()
        t_send = time.monotonic()

        def _span(**meta) -> None:
            if tctx.sampled:
                self.trace.add(tctx.trace_id, "node.send", t_send,
                               time.monotonic() - t_send,
                               to=to_username, **meta)

        from_cache = False
        via_dht = False
        try:
            rec = self.dir.lookup(to_username)          # main.go:225
            with self._cache_mu:
                self._lookup_cache[to_username] = rec
        except Exception as e:
            # Directory down or record missing: fall back to the last
            # known-good record so peers that have already talked keep
            # talking through a directory outage (README.md:135 names the
            # directory as the single point of failure; this removes it
            # from the send path for warm pairs).
            with self._cache_mu:
                rec = self._lookup_cache.get(to_username)
            if rec is not None:
                from_cache = True
                log.warning("directory lookup for %s failed (%s); using "
                            "cached record", to_username, e)
            elif self.dht is not None:
                # Third rung: never-paired peers resolve via the DHT's
                # signed records while the directory is down (the cache
                # rung only covers peers we've already talked to). The
                # lookup runs inline on the /send handler thread, so it
                # carries a wall-time budget: with a routing table full
                # of dead contacts the alpha-rounds of UDP timeouts must
                # not hold the UI's send for many seconds (ADVICE r4).
                rec = self.dht.get_record(to_username, budget_s=3.0)
                if rec is not None:
                    log.warning("directory lookup for %s failed (%s); "
                                "resolved via DHT", to_username, e)
                    via_dht = True
            if rec is None and not self.outbox.has(to_username):
                return Response(404, {"error": f"lookup failed: {e}"})
            # rec None but the outbox holds queued messages for this
            # user: the recipient exists and is mid-churn (e.g. they
            # deregistered on shutdown and the first queued send spent
            # the cached record) — this send JOINS the queue instead of
            # 404ing, preserving order behind the already-parked ones.

        with self._seq_mu:
            self._send_seq += 1
            seq = self._send_seq
        msg = ChatMessage(from_user=self.username, to_user=to_username,
                          content=content, timestamp=now_rfc3339(),
                          msg_id=mint_msg_id(self.username, seq, content,
                                             nonce=self._boot_nonce))

        if self.outbox.has(to_username):
            # A backlog is already parked for this recipient (the peer
            # just came back but the worker hasn't flushed yet, or is
            # mid-flush): delivering the fresh message directly would
            # jump ahead of the queued ones — _flush_outbox stops at
            # the first failure per recipient precisely to preserve
            # send order. Join the back of the queue and kick the
            # worker so the whole backlog drains in order.
            for old in self.outbox.put(msg):
                self._note_drop("overflow", old)
            self._m_outbox_depth.set(self.outbox.depth())
            self._outbox_kick.set()
            _span(outcome="queued", attempts=0)
            return Response(200, {"status": "queued", "id": msg.id,
                                  "msg_id": msg.msg_id,
                                  "trace": tctx.trace_id})

        errors: list[str] = []
        won = self._deliver(rec, msg, errors) if rec is not None else ""
        if won:
            if via_dht:
                # Cache only after a delivery proves the record good — a
                # dead DHT record must not poison the cache rung.
                with self._cache_mu:
                    self._lookup_cache[to_username] = rec
            self._m_delivery_ms.observe((time.monotonic() - t_send) * 1000.0)
            _span(via=("relay" if "/p2p-circuit/" in won else "direct"))
            return Response(200, {"status": "sent", "id": msg.id,
                                  "trace": tctx.trace_id})  # main.go:264

        # The cached record may be stale (the peer moved while the
        # directory was down). If the DHT holds a record with different
        # addrs, try those before giving up — it is republished every
        # re-register tick, so it tracks moves the cache cannot.
        if from_cache and self.dht is not None:
            # Same wall-time budget as the third-rung lookup above: this
            # retry also runs inline on the /send handler thread.
            fresh = self.dht.get_record(to_username, budget_s=3.0)
            if fresh is not None and fresh.peer_id != rec.peer_id:
                # Identity pinning: for a peer we already hold a binding
                # for, a DHT record signed by a DIFFERENT identity is a
                # username squat, not a move — refuse it. (Never-paired
                # resolution has no prior binding and is trust-on-first-
                # use, the same model as the reference's unauthenticated
                # directory.)
                log.warning("DHT record for %s signed by a different "
                            "identity; ignoring", to_username)
                fresh = None
            if fresh is not None and set(fresh.addrs) != set(rec.addrs):
                log.warning("cached addrs for %s are dead; retrying via "
                            "DHT record", to_username)
                won = self._deliver(fresh, msg, errors)
                if won:
                    with self._cache_mu:
                        self._lookup_cache[to_username] = fresh
                    self._m_delivery_ms.observe(
                        (time.monotonic() - t_send) * 1000.0)
                    _span(via=("relay" if "/p2p-circuit/" in won
                               else "direct"))
                    return Response(200, {"status": "sent", "id": msg.id,
                                          "trace": tctx.trace_id})
        if from_cache:
            # Total failure on a cached record: drop it so the next send
            # re-resolves instead of re-dialing dead addrs forever.
            with self._cache_mu:
                self._lookup_cache.pop(to_username, None)
        # At-least-once: the peer is unreachable RIGHT NOW — park the
        # message in the outbox and let the redelivery worker retry on
        # the backoff schedule, re-resolving each round. The client gets
        # a well-formed queued answer instead of the reference's
        # 502-and-forget (SURVEY.md §2 C5 message loss).
        for old in self.outbox.put(msg):
            self._note_drop("overflow", old)
        self._m_outbox_depth.set(self.outbox.depth())
        self._outbox_kick.set()
        _span(outcome="queued", attempts=len(errors))
        return Response(200, {"status": "queued", "id": msg.id,
                              "msg_id": msg.msg_id, "trace": tctx.trace_id})

    def _deliver(self, rec, msg: ChatMessage, errors: list[str]) -> str:
        """Try each advertised addr (direct first, then circuits), one stream
        per message, write JSON, half-close, await the ack
        (main.go:235-261 plus the at-least-once wire). Returns the
        addr that delivered (truthy — callers keep their boolean
        checks; the trace span reads the relay marker off it), or ""
        when every addr failed."""
        addrs = sorted(rec.addrs, key=lambda a: "/p2p-circuit/" in a)
        for addr_str in addrs:
            try:
                # Chaos: a raised/error'd/dropped deliver fails THIS
                # attempt — the message falls through to the outbox and
                # the redelivery worker (docs/robustness.md contract).
                act = failpoint("p2p.node.deliver")
                if act is not None:
                    raise ConnectionError(
                        f"failpoint p2p.node.deliver ({act.kind})")
                maddr = Multiaddr.parse(addr_str)
                if maddr.peer_id is None:
                    maddr = maddr.with_peer(rec.peer_id)
                stream = self.host.new_stream(maddr, CHAT_PROTOCOL_ID, timeout=5.0)
                try:
                    stream.send_frame(msg.to_json())
                    stream.close_write()
                    if msg.msg_id:
                        # At-least-once wire: wait for the receiver's
                        # ack frame. None (EOF without a frame) is a
                        # pre-ack peer closing after the read — count it
                        # delivered (legacy wire compat); a frame that
                        # is not OUR ack is a broken peer.
                        stream.settimeout(5.0)
                        raw = stream.recv_frame()
                        if raw is not None and parse_ack(raw) != msg.msg_id:
                            raise ConnectionError("bad delivery ack")
                finally:
                    stream.close()
                return addr_str
            except Exception as e:  # noqa: BLE001 — collect and try next addr
                errors.append(f"{addr_str}: {e}")
        return ""

    def _note_drop(self, reason: str, msg: ChatMessage) -> None:
        """Account an outbox drop (`reason` = ttl|overflow) — the churn
        contract's loss ledger (a nonzero count under plain churn is a
        contract breach; docs/loadtest.md peer_churn)."""
        with self._drop_mu:
            self._dropped[reason] += 1
        log.warning("outbox dropped %s -> %s (%s)",
                    (msg.msg_id or msg.id)[:12], msg.to_user, reason)

    def _handle_metrics(self, req: Request) -> Response:
        """GET /metrics: the chat-plane delivery ledger (Prometheus
        text), same exposition contract as the serve fronts."""
        self._m_outbox_depth.set(self.outbox.depth())
        text = self.metrics.render()
        with self._drop_mu:
            drops = dict(self._dropped)
        text += "# TYPE p2p_messages_dropped_total counter\n" + "".join(
            f'p2p_messages_dropped_total{{reason="{r}"}} {n}\n'
            for r, n in sorted(drops.items()))
        hits = _fp.snapshot()
        if hits:
            # Same operator alarm as the serve front: ANY
            # failpoint_hits_total series in a production scrape means
            # chaos is armed on this node.
            text += "# TYPE failpoint_hits_total counter\n" + "".join(
                f'failpoint_hits_total{{site="{site}"}} {n}\n'
                for site, n in sorted(hits.items()))
        return Response(200, text, content_type="text/plain; version=0.0.4")

    def _handle_trace(self, req: Request) -> Response:
        """GET /admin/trace[?id=]: the node's span store — same listing
        contract as the serve fronts (serve/api.py _trace_list), so one
        client-side fetch loop reads any plane's timelines."""
        tid = str(req.query.get("id") or "")
        if tid:
            spans = self.trace.get(tid)
            if not spans:
                return Response(404, {"error": f"trace {tid!r} not held"})
            return Response(200, {"id": tid, "spans": spans})
        # Stats nest under their own key: the store's stats() also
        # counts "traces" and would clobber the id list if splatted.
        return Response(200, {"traces": self.trace.ids(),
                              "stats": self.trace.stats()})

    def _handle_inbox(self, req: Request) -> Response:
        """GET /inbox?after=<id> (go/cmd/node/main.go:267-270)."""
        after = req.query.get("after", "")
        return Response(200, [m.to_dict() for m in self.inbox.drain(after)])

    def _handle_me(self, req: Request) -> Response:
        """GET /me (go/cmd/node/main.go:272-278). Returns the base58 peer id
        (deliberate fix of the raw-bytes quirk at main.go:275) plus addrs."""
        out = {
            "username": self.username,
            "peer_id": self.host.peer_id,
            "addrs": [str(a) for a in self.host.addrs()],
        }
        if self.dht is not None:
            dht_host, dht_port = self.dht.addr
            if dht_host in ("0.0.0.0", "::"):
                # A wildcard bind is not dialable — substitute the host's
                # advertise address so seed chaining works cross-host.
                dht_host = self.host.advertise_host
            out["dht_addr"] = f"{dht_host}:{dht_port}"
        return Response(200, out)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ChatNode":
        self.host.set_stream_handler(CHAT_PROTOCOL_ID, self._on_chat_stream)
        self.host.start()

        # Relay reservations (additive; see module docstring).
        for addr_str in filter(None, (s.strip() for s in self.relay_addrs.split(","))):
            self.host.reserve_on_relay(Multiaddr.parse(addr_str))

        # Register with the directory — fatal on failure, matching
        # go/cmd/node/main.go:184.
        addrs = [str(a) for a in self.host.addrs()]
        self.dir.register(self.username, self.host.peer_id, addrs)
        log.info("registered %s (%s) with directory %s",
                 self.username, self.host.peer_id[:12], self.directory_url)

        # DHT join + signed-record publish — every step non-fatal
        # (go/cmd/node/main.go:153 parity). The join runs on a background
        # thread: unreachable seeds cost seconds of UDP timeouts and must
        # not delay the HTTP API coming up.
        if self.dht is not None:
            self.dht.start()
            threading.Thread(target=self._dht_join, args=(addrs,),
                             daemon=True, name="dht-join").start()

        # NAT-PMP mapping — background (gateway retransmits cost seconds),
        # best-effort; a mapped external addr is re-advertised via the
        # re-register loop once acquired.
        if self._natpmp_enabled:
            threading.Thread(target=self._natpmp_setup, daemon=True,
                             name="natpmp").start()

        # Bootstrap connects: parse multiaddr -> connect; errors logged,
        # non-fatal (go/cmd/node/main.go:189-211).
        for addr_str in filter(None, (s.strip() for s in self.bootstrap_addrs.split(","))):
            try:
                pid = self.host.connect(Multiaddr.parse(addr_str))
                log.info("bootstrap connected to %s", pid[:12])
            except Exception as e:  # noqa: BLE001
                log.warning("bootstrap connect %s failed: %s", addr_str, e)

        if self.reregister_s > 0:
            threading.Thread(target=self._reregister_loop, daemon=True,
                             name="reregister").start()
        threading.Thread(target=self._redelivery_loop, daemon=True,
                         name="redelivery").start()

        self._http = HttpServer(self.router, self.http_addr).start()
        log.info("node %s HTTP API on %s", self.username, self._http.addr)
        return self

    def _dht_join(self, addrs: list[str]) -> None:
        """Background DHT bootstrap + initial record publish (start() must
        not block on UDP timeouts to dead seeds). The re-register loop
        republishes afterwards, so a failed initial publish self-heals."""
        try:
            seeds = parse_seeds(self.dht_bootstrap)
            if seeds:
                self.dht.bootstrap(seeds)
            self.dht.put_self_record(self.username, addrs)
        except Exception as e:  # noqa: BLE001
            log.warning("dht join/publish failed (non-fatal): %s", e)

    def _natpmp_setup(self) -> None:
        """Map the p2p listen port on the gateway and advertise the
        external addr (NATPortMap parity). Every failure degrades to
        punch/relay reachability."""
        try:
            gw_host, gw_port = None, 5351
            if self._natpmp_gateway:
                h, _, p = self._natpmp_gateway.rpartition(":")
                gw_host, gw_port = (h or self._natpmp_gateway,
                                    int(p) if h else 5351)
            mapper = PortMapper(self.host.listen_port,
                                gateway=gw_host, port=gw_port)
            if self._closed.is_set():
                return
            ext = mapper.acquire()
            # Assign BEFORE checking _closed: stop() sets _closed first and
            # checks _mapper second, so whichever thread loses the race
            # still sees the other's write and release() runs exactly once
            # (it is a no-op on an already-released mapping).
            self._mapper = mapper
            if self._closed.is_set():
                mapper.release()
                return
            if ext is None:
                return
            self._advertise_mapping(ext)
        except Exception as e:  # noqa: BLE001
            log.warning("NAT-PMP setup failed (non-fatal): %s", e)

    def _advertise_mapping(self, ext: tuple[str, int]) -> None:
        """(Re)advertise the NAT-mapped external addr and eagerly push the
        updated record to the directory + DHT."""
        if self._nat_ext is not None and self._nat_ext != ext:
            self.host.remove_advertised_addr(
                Multiaddr(self._nat_ext[0], self._nat_ext[1]))
        self._nat_ext = ext
        self.host.add_advertised_addr(Multiaddr(ext[0], ext[1]))
        addrs = [str(a) for a in self.host.addrs()]
        try:
            self.dir.register(self.username, self.host.peer_id, addrs)
        except Exception:  # noqa: BLE001 — reregister loop will retry
            pass
        if self.dht is not None:
            try:
                self.dht.put_self_record(self.username, addrs)
            except Exception:  # noqa: BLE001
                pass

    def _reregister_loop(self) -> None:
        """Periodically re-register so an (in-memory, record-losing)
        directory restart relearns this node; failures back off with
        jittered exponential delays up to 8x the interval (utils/backoff
        — the jitter keeps a fleet of nodes from hammering a restarted
        directory in lockstep) and never crash the node — only the
        STARTUP registration is fatal (main.go:184 parity). Failure logs
        are bounded to one WARNING per outage (state-change logging: an
        hours-long outage is one 'lost' line and one 'recovered' line,
        not one line per attempt)."""
        backoff = Backoff(base_s=self.reregister_s,
                          max_s=self.reregister_s * 8, jitter=0.25)
        dir_ok = True
        delay = self.reregister_s
        while not self._closed.wait(delay):
            try:
                # In a try: host sockets may be mid-close when stop()
                # races this tick, and the loop must survive it.
                addrs = [str(a) for a in self.host.addrs()]
            except Exception:  # noqa: BLE001
                continue
            try:
                self.dir.register(self.username, self.host.peer_id, addrs)
                if not dir_ok:
                    dir_ok = True
                    log.info("directory %s reachable again; re-registered",
                             self.directory_url)
                backoff.reset()
                delay = self.reregister_s
            except Exception as e:  # noqa: BLE001 — outage, keep trying
                delay = backoff.next()
                if dir_ok:
                    dir_ok = False
                    log.warning("re-register failed (%s); backing off "
                                "(next attempt in %.0fs, then "
                                "exponentially up to %.0fs)",
                                e, delay, self.reregister_s * 8)
                else:
                    log.debug("re-register still failing (%s); next "
                              "attempt in %.0fs", e, delay)
            # Renew the NAT-PMP mapping before it lapses (half-lifetime
            # cadence is tracked inside the mapper); a changed grant
            # (gateway reboot, reassigned port) is re-advertised so the
            # records track the LIVE external addr, not the original one.
            if self._mapper is not None:
                try:
                    changed = self._mapper.renew_if_due()
                    if changed is not None:
                        self._advertise_mapping(changed)
                except Exception as e:  # noqa: BLE001
                    log.debug("NAT-PMP renew failed: %s", e)
            # DHT republish runs even when the directory is down — that is
            # precisely when the DHT rung carries the lookups.
            if self.dht is not None:
                try:
                    # AFTER the directory register (dead-contact RPC
                    # timeouts here must not delay directory relearn):
                    # republish keeps the record alive past the DHT's TTL
                    # and re-seeds it onto nodes that joined since.
                    self.dht.put_self_record(self.username, addrs)
                except Exception as e:  # noqa: BLE001
                    log.debug("dht republish failed: %s", e)

    # -- at-least-once redelivery -------------------------------------------

    def _resolve_for_redelivery(self, to_username: str):
        """Re-resolve a queued recipient before a redelivery round:
        directory first (the fresh record — the peer most likely MOVED,
        which is why the message is queued), then the cache, then the
        DHT rung with the same identity pinning as the /send ladder.
        Returns None when no rung answers — the recipient stays queued
        and the round backs off."""
        # Chaos: a failed resolve leaves the whole recipient queued this
        # round — no crash, no message loss, retried on the backoff
        # schedule (docs/robustness.md contract).
        act = failpoint("p2p.node.resolve")
        if act is not None:
            return None
        try:
            rec = self.dir.lookup(to_username)
            with self._cache_mu:
                self._lookup_cache[to_username] = rec
            return rec
        except Exception:  # noqa: BLE001 — fall through the ladder
            pass
        with self._cache_mu:
            cached = self._lookup_cache.get(to_username)
        if self.dht is not None:
            fresh = self.dht.get_record(to_username, budget_s=3.0)
            if fresh is not None:
                if cached is not None and fresh.peer_id != getattr(
                        cached, "peer_id", None):
                    # Identity pinning (same rule as _handle_send): a
                    # record signed by a different identity is a squat,
                    # not a move — keep the pinned binding.
                    return cached
                return fresh
        return cached

    def _flush_outbox(self) -> bool:
        """One redelivery round: TTL-expire, then per recipient
        re-resolve and retry the queued messages in send order (stopping
        at the first failure per recipient, so order is preserved).
        Returns True when anything failed this round. Serialized by
        ``_flush_mu``; the outbox lock is never held across a dial."""
        with self._flush_mu:
            for old in self.outbox.expire(time.monotonic()):
                self._note_drop("ttl", old)
            any_failed = False
            for user, entries in self.outbox.snapshot().items():
                try:
                    rec = self._resolve_for_redelivery(user)
                except Exception as e:  # noqa: BLE001 — incl. armed raise
                    log.debug("redelivery resolve %s failed: %s", user, e)
                    rec = None
                if rec is None:
                    any_failed = True
                    continue
                for msg, t0 in entries:
                    errors: list[str] = []
                    if not self._deliver(rec, msg, errors):
                        any_failed = True
                        log.debug("redelivery %s -> %s failed: %s",
                                  msg.msg_id[:12], user, "; ".join(errors))
                        break
                    if self.outbox.remove(user, msg.msg_id) is not None:
                        self._m_redelivered.inc()
                        wait_s = time.monotonic() - t0
                        self._m_delivery_ms.observe(wait_s * 1000.0)
                        log.info("redelivered %s -> %s after %.1fs",
                                 msg.msg_id[:12], user, wait_s)
            self._m_outbox_depth.set(self.outbox.depth())
            return any_failed

    def _redelivery_loop(self) -> None:
        """Background worker: retries unacked messages on a jittered
        exponential schedule (utils/backoff — the jitter keeps a fleet
        of senders from dialing a restarted peer in lockstep). A /send
        that queues kicks the worker awake, so the first retry doesn't
        wait out an idle tick."""
        backoff = Backoff(base_s=0.25, max_s=4.0, jitter=0.5)
        delay = 0.25
        while True:
            self._outbox_kick.wait(timeout=delay)
            self._outbox_kick.clear()
            if self._closed.is_set():
                return
            if self.outbox.depth() == 0:
                backoff.reset()
                delay = 0.5       # idle: the kick event wakes us instantly
                continue
            try:
                failed = self._flush_outbox()
            except Exception as e:  # noqa: BLE001 — worker must survive
                log.warning("redelivery round failed: %s", e)
                failed = True
            delay = backoff.next() if failed else (backoff.reset() or 0.05)

    @property
    def http_url(self) -> str:
        assert self._http is not None
        return self._http.url

    def serve_forever(self) -> None:
        """Run as a daemon until SIGTERM/SIGINT, then clean up — the
        NAT-PMP mapping in particular must be released (a plain kill
        would leave the gateway forwarding the port for up to the
        mapping lifetime)."""
        import signal

        done = threading.Event()
        for signum in (signal.SIGTERM, signal.SIGINT):
            signal.signal(signum, lambda *_: done.set())
        self.start()
        done.wait()
        self.stop()

    def stop(self) -> None:
        self._closed.set()
        self._outbox_kick.set()     # unblock the worker so it exits
        if self._http:
            self._http.stop()
        # Graceful shutdown, while the p2p host is still up: one final
        # outbox flush (last chance for queued messages — _flush_mu
        # serializes against a worker round already in flight), then
        # deregister so the directory stops advertising a dead node
        # (the reference never deregisters — SURVEY.md §2 C5; the DHT
        # record is signed + TTL'd and expires on its own).
        if self.outbox.depth():
            try:
                self._flush_outbox()
            except Exception as e:  # noqa: BLE001 — best-effort flush
                log.debug("final outbox flush failed: %s", e)
        try:
            self.dir.deregister(self.username, self.host.peer_id)
            log.info("deregistered %s from directory %s (DHT record "
                     "expires via its own TTL)",
                     self.username, self.directory_url)
        except Exception as e:  # noqa: BLE001 — directory may be gone
            log.debug("directory deregister failed (non-fatal): %s", e)
        if self.dht is not None:
            self.dht.close()
        if self._mapper is not None:
            try:
                self._mapper.release()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
        self.host.close()


def main() -> None:
    ChatNode().serve_forever()


if __name__ == "__main__":
    main()
