"""Kademlia DHT: serverless username -> signed peer-record resolution.

The port's copy of ``p2p_llm_chat_tpu/p2p/dht.py``: the same wire bytes
and behaviour, so port and reference peers mix in one fleet; the port
imports nothing of the reference package.

The reference constructs a kad-DHT on every node (go/cmd/node/main.go:151,
via go-libp2p-kad-dht v0.34.0, go/cmd/node/go.mod:9) but never routes with
it — discovery is 100% via the Directory service (SURVEY.md §2), and DHT
errors are non-fatal (main.go:153). Here the DHT is built from scratch AND
actually wired in: it is the third rung of the node's lookup ladder
(directory -> lookup cache -> DHT), so two peers whose bootstrap graphs
overlap can resolve each other with the directory fully down — including
peers that have never talked (which the cache rung cannot cover).

Design (classic Kademlia, adapted to the chat plane):

- Node IDs are 256-bit: sha256 of the self-certifying base58 peer id
  (p2p/identity.py). Record keys are sha256(b"user:" + username), so the
  username namespace and the node-ID space share one XOR metric.
- RPCs are single JSON datagrams over the node's UDP socket — PING,
  FIND_NODE, GET, PUT. Request/response with per-RPC nonces and small
  bounded retries; Kademlia tolerates loss by design, so the reliable
  stream machinery (p2p/udp.py) is deliberately not used here.
- Every datagram is SIGNED by its sender's Ed25519 key over the canonical
  message body, verified against the key embedded in the claimed peer id;
  unverifiable datagrams are dropped. Routing-table updates are further
  PROOF-GATED (S/Kademlia-style): a response proves key ownership against
  OUR fresh nonce, so it may add/move a contact directly; a request only
  triggers a background challenge ping to the observed source address,
  and the table changes when (and only when) the signed pong comes back.
  Without this, one spoofed ``{"from": victim}`` datagram would re-point
  the victim's routing entry at an attacker address (contact hijack /
  record eclipse).
- Records are SIGNED: {username, peer_id, addrs, seq} with an Ed25519
  signature over the canonical JSON by the key embedded in peer_id.
  Storers validate (a) the signature against the self-certifying id and
  (b) that the record key matches its username, so a malicious node
  cannot alter another IDENTITY's record or file a record under the
  wrong key; seq is last-writer-wins (directory.py parity) and stale
  writes are ignored. The username -> identity binding itself is
  last-writer-wins, exactly the reference directory's trust model (its
  /register is unauthenticated, go/cmd/directory/main.go — README.md:135
  treats the directory as trusted infrastructure): a squatter CAN claim
  a username with their own identity here just as they can there. What
  the signatures add over the directory: third-party DHT nodes cannot
  tamper with records in flight or in storage, and node.py pins the
  peer IDENTITY for warm pairs (a DHT record for a known peer is only
  accepted if its peer_id matches the cached binding).
- k-buckets (k=16) with least-recently-seen eviction: a full bucket pings
  its oldest contact and only replaces it if the ping fails (the classic
  liveness bias that keeps long-lived contacts).
- Iterative (not recursive) lookups with alpha=3 parallelism; PUT stores
  on the k closest nodes found; GET returns the freshest (highest-seq)
  valid record seen. Stored records expire after ``record_ttl_s`` (2h);
  owners republish on the node's re-register interval (node.py).
"""

from __future__ import annotations

import functools
import hashlib
import json
import secrets
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor, TimeoutError as FutTimeout, as_completed
from dataclasses import dataclass, field
from typing import Callable, Optional

try:
    from cryptography.exceptions import InvalidSignature
except ImportError:
    # Gated stdlib dev fallback (P2P_DEV_CRYPTO=1): identity.py resolves
    # the same way, and its dev verify raises this class.
    from .devcrypto import require_dev_crypto
    require_dev_crypto("p2p.dht")
    from .devcrypto import InvalidSignature     # type: ignore[assignment]

from .identity import Identity, peer_id_to_public_key
from ..utils.backoff import Backoff, note_retry
from ..utils.failpoints import failpoint
from ..utils.log import get_logger

log = get_logger("dht")

K = 16            # bucket size / replication factor
ALPHA = 3         # lookup parallelism
ID_BITS = 256
_MAX_DGRAM = 8192


def node_id_for_peer(peer_id: str) -> int:
    return int.from_bytes(hashlib.sha256(peer_id.encode()).digest(), "big")


def key_for_username(username: str) -> int:
    return int.from_bytes(
        hashlib.sha256(b"user:" + username.encode()).digest(), "big")


def _distance(a: int, b: int) -> int:
    return a ^ b


@dataclass(frozen=True)
class Contact:
    peer_id: str
    host: str
    port: int

    @functools.cached_property
    def node_id(self) -> int:
        # cached: lookups sort shortlists by distance every round, and
        # re-hashing the same peer id per comparison adds up.
        return node_id_for_peer(self.peer_id)

    def to_wire(self) -> dict:
        return {"peer_id": self.peer_id, "host": self.host, "port": self.port}

    @classmethod
    def from_wire(cls, d: dict) -> "Contact":
        return cls(peer_id=str(d["peer_id"]), host=str(d["host"]),
                   port=int(d["port"]))


def _msg_signing_bytes(msg: dict) -> bytes:
    """Canonical bytes of a wire message minus its signature field."""
    core = {k: v for k, v in msg.items() if k != "sig"}
    return json.dumps(core, sort_keys=True, separators=(",", ":")).encode()


def _verify_msg(msg: dict) -> bool:
    """Signature valid against the key embedded in the claimed peer id."""
    pid = msg.get("from")
    sig = msg.get("sig")
    if not isinstance(pid, str) or not isinstance(sig, str):
        return False
    try:
        pub = peer_id_to_public_key(pid)
        pub.verify(bytes.fromhex(sig), _msg_signing_bytes(msg))
        return True
    except (InvalidSignature, ValueError):
        return False


def _record_signing_bytes(username: str, peer_id: str, addrs: list[str],
                          seq: int) -> bytes:
    # Canonical JSON: sorted keys, no whitespace — both signer and verifier
    # rebuild this exact byte string.
    return json.dumps(
        {"addrs": addrs, "peer_id": peer_id, "seq": seq, "username": username},
        sort_keys=True, separators=(",", ":")).encode()


@dataclass
class SignedRecord:
    """A username's signed address record (the DHT's stored value)."""
    username: str
    peer_id: str
    addrs: list[str]
    seq: int
    sig_hex: str
    stored_at: float = field(default_factory=time.monotonic, compare=False)

    @classmethod
    def create(cls, ident: Identity, username: str, addrs: list[str],
               seq: Optional[int] = None) -> "SignedRecord":
        seq = int(time.time() * 1000) if seq is None else seq
        sig = ident.sign(_record_signing_bytes(username, ident.peer_id,
                                               list(addrs), seq))
        return cls(username=username, peer_id=ident.peer_id,
                   addrs=list(addrs), seq=seq, sig_hex=sig.hex())

    def verify(self, expect_key: Optional[int] = None) -> bool:
        """Signature valid against the self-certifying peer id, and (when
        ``expect_key`` is given) the record actually belongs at that key."""
        if expect_key is not None and key_for_username(self.username) != expect_key:
            return False
        try:
            pub = peer_id_to_public_key(self.peer_id)
            pub.verify(bytes.fromhex(self.sig_hex),
                       _record_signing_bytes(self.username, self.peer_id,
                                             self.addrs, self.seq))
            return True
        except (InvalidSignature, ValueError):
            return False

    def to_wire(self) -> dict:
        return {"username": self.username, "peer_id": self.peer_id,
                "addrs": self.addrs, "seq": self.seq, "sig": self.sig_hex}

    @classmethod
    def from_wire(cls, d: dict) -> "SignedRecord":
        return cls(username=str(d["username"]), peer_id=str(d["peer_id"]),
                   addrs=[str(a) for a in d["addrs"]], seq=int(d["seq"]),
                   sig_hex=str(d["sig"]))


class RoutingTable:
    """256 k-buckets ordered by shared-prefix length with ``self_id``.

    Thread-safe; contacts move to the tail (most recently seen) on every
    touch. When a bucket is full, ``maybe_add`` returns the least-recently
    seen contact as an eviction CANDIDATE — the caller pings it and calls
    ``replace`` only if the ping fails (Kademlia's liveness bias).
    """

    def __init__(self, self_id: int, k: int = K) -> None:
        self.self_id = self_id
        self.k = k
        self._buckets: list[list[Contact]] = [[] for _ in range(ID_BITS)]  # guarded-by: _mu
        self._mu = threading.Lock()

    def _bucket_index(self, node_id: int) -> int:
        d = _distance(self.self_id, node_id)
        return d.bit_length() - 1 if d else 0

    def touch(self, c: Contact) -> Optional[Contact]:
        """Record contact activity. Returns an eviction candidate when the
        bucket is full (see class docstring), else None."""
        if c.node_id == self.self_id:
            return None
        with self._mu:
            bucket = self._buckets[self._bucket_index(c.node_id)]
            for i, existing in enumerate(bucket):
                if existing.peer_id == c.peer_id:
                    bucket.pop(i)
                    bucket.append(c)   # refresh addr + recency
                    return None
            if len(bucket) < self.k:
                bucket.append(c)
                return None
            return bucket[0]

    def replace(self, stale: Contact, fresh: Contact) -> None:
        with self._mu:
            bucket = self._buckets[self._bucket_index(stale.node_id)]
            for i, existing in enumerate(bucket):
                if existing.peer_id == stale.peer_id:
                    bucket.pop(i)
                    break
            if (len(bucket) < self.k
                    and all(e.peer_id != fresh.peer_id for e in bucket)):
                bucket.append(fresh)

    def get(self, peer_id: str) -> Optional[Contact]:
        # The contact's bucket is derivable from its id — no full scan
        # (this runs on the rx thread for every request datagram).
        with self._mu:
            bucket = self._buckets[self._bucket_index(node_id_for_peer(peer_id))]
            for existing in bucket:
                if existing.peer_id == peer_id:
                    return existing
        return None

    def remove(self, peer_id: str) -> None:
        with self._mu:
            bucket = self._buckets[self._bucket_index(node_id_for_peer(peer_id))]
            for i, existing in enumerate(bucket):
                if existing.peer_id == peer_id:
                    bucket.pop(i)
                    return

    def closest(self, target: int, n: Optional[int] = None) -> list[Contact]:
        n = self.k if n is None else n
        with self._mu:
            allc = [c for b in self._buckets for c in b]
        allc.sort(key=lambda c: _distance(c.node_id, target))
        return allc[:n]

    def __len__(self) -> int:
        with self._mu:
            return sum(len(b) for b in self._buckets)


class DHTNode:
    """One Kademlia participant bound to a UDP socket.

    ``start()`` spawns the receiver thread; ``bootstrap(addrs)`` joins the
    network via any known (host, port) seeds; ``put_record``/``get_record``
    are the username-record surface node.py uses. All RPCs are fire-and-
    retry datagrams — an unreachable peer just times out its slot in the
    iterative lookup.
    """

    def __init__(self, ident: Identity, listen_addr: str = "127.0.0.1:0",
                 *, k: int = K, rpc_timeout_s: float = 0.6,
                 record_ttl_s: float = 7200.0,
                 max_records: int = 4096) -> None:
        self.ident = ident
        self.node_id = node_id_for_peer(ident.peer_id)
        self.k = k
        self.rpc_timeout_s = rpc_timeout_s
        self.record_ttl_s = record_ttl_s
        self.max_records = max_records
        host, _, port = listen_addr.rpartition(":")
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host or "127.0.0.1", int(port or 0)))
        self.table = RoutingTable(self.node_id, k=k)
        self._store: dict[int, SignedRecord] = {}  # guarded-by: _store_mu
        self._store_mu = threading.Lock()
        # rid -> (event, hits, resolved dst addr the RPC was sent to)
        self._pending: dict[str, tuple[threading.Event, list,
                                       tuple[str, int]]] = {}  # guarded-by: _pending_mu
        self._pending_mu = threading.Lock()
        self._evicting: set[str] = set()  # guarded-by: _evict_mu
        self._evict_mu = threading.Lock()
        self._challenging: set[str] = set()  # guarded-by: _challenge_mu
        self._challenge_mu = threading.Lock()
        # Destination-resolution memo (_resolve_dst): hostname -> IP, so
        # a slow DNS server is consulted once per destination, not on
        # every RPC. Bounded; numeric IPs never enter it.
        self._resolve_cache: dict[str, str] = {}  # guarded-by: _resolve_mu
        self._resolve_mu = threading.Lock()
        self._closed = threading.Event()
        self._rx: Optional[threading.Thread] = None
        # One long-lived pool for lookup/store fan-out — per-round executor
        # creation on the inline /send path would pay thread startup for
        # every ALPHA-batch and leak straggler threads per round. Sized at
        # 3x the widest single fan-out (k) so a /send-path lookup does not
        # queue behind a concurrent republish's k store RPCs and time out
        # live contacts as false no-answers.
        self._pool = ThreadPoolExecutor(max_workers=3 * max(k, ALPHA),
                                        thread_name_prefix="dht-fan")

    # -- lifecycle -----------------------------------------------------------

    @property
    def addr(self) -> tuple[str, int]:
        return self.sock.getsockname()

    def start(self) -> "DHTNode":
        self._rx = threading.Thread(target=self._recv_loop, daemon=True,
                                    name="dht-rx")
        self._rx.start()
        return self

    def close(self) -> None:
        self._closed.set()
        self._pool.shutdown(wait=False)
        try:
            self.sock.close()
        except OSError:
            pass

    def bootstrap(self, seeds: list[tuple[str, int]]) -> int:
        """Ping the seeds, then iteratively look up our own id to populate
        buckets along the path (the standard Kademlia join). Returns the
        routing-table size; 0 means nobody answered (non-fatal, matching
        the reference's non-fatal DHT errors, main.go:153)."""
        for host, port in seeds:
            self._rpc({"t": "ping"}, (host, port))
        self.iterative_find_node(self.node_id)
        return len(self.table)

    # -- wire ----------------------------------------------------------------

    def _recv_loop(self) -> None:
        import errno as _errno

        while not self._closed.is_set():
            try:
                data, src = self.sock.recvfrom(_MAX_DGRAM)
            except OSError as e:
                # Transient errors (e.g. ICMP port-unreachable surfacing as
                # ConnectionResetError on some stacks) must not kill the rx
                # thread — only a real close should end the loop. An fd
                # invalidated without _closed being set (EBADF/ENOTSOCK)
                # is unrecoverable: exit instead of busy-spinning, and a
                # short sleep paces any other persistent error state
                # (ADVICE r4).
                if self._closed.is_set():
                    return
                if e.errno in (_errno.EBADF, _errno.ENOTSOCK):
                    log.warning("dht rx socket invalidated (%s); rx "
                                "thread exiting", e)
                    return
                time.sleep(0.01)
                continue
            try:
                msg = json.loads(data.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            try:
                self._on_message(msg, src)
            except Exception as e:  # noqa: BLE001 — one bad dgram must not kill rx
                log.warning("dht rx error from %s: %s", src, e)

    def _on_message(self, msg: dict, src: tuple[str, int]) -> None:
        t = msg.get("t")
        rid = msg.get("rid")
        sender_pid = msg.get("from")
        if not isinstance(sender_pid, str) or not sender_pid:
            return
        if sender_pid == self.ident.peer_id or not _verify_msg(msg):
            return                       # unsigned/forged: drop entirely
        if t in ("pong", "nodes", "value", "stored"):
            with self._pending_mu:
                ent = self._pending.get(rid) if isinstance(rid, str) else None
            if ent is not None:
                # A signed response to OUR nonce proves the key holder is
                # reachable at src — the only path that updates the table
                # directly. (The reply address IS the contact address:
                # single-socket UDP.) Table update only when src matches
                # the address the RPC was SENT to: a challenged peer that
                # can spoof UDP sources must not re-point its own contact
                # entry at a victim address (ADVICE r4 reflection vector).
                # The response itself still delivers either way — rid
                # possession plus the signature prove it's the peer we
                # asked.
                if src == ent[2]:
                    self._note_contact(Contact(sender_pid, src[0], src[1]))
                ent[1].append((msg, src))
                ent[0].set()
            return
        # Requests never touch the table on their own say-so: challenge the
        # claimed identity at the observed source address in the background
        # (the signed pong lands in the response path above).
        known = self.table.get(sender_pid)
        if known is None or (known.host, known.port) != src:
            self._challenge(src)
        else:
            self.table.touch(known)      # recency refresh, address unchanged
        reply = {"rid": rid, "from": self.ident.peer_id}
        if t == "ping":
            reply["t"] = "pong"
        elif t == "find_node":
            reply["t"] = "nodes"
            reply["nodes"] = [c.to_wire()
                              for c in self.table.closest(int(msg["target"], 16))]
        elif t == "get":
            key = int(msg["key"], 16)
            rec = self._load(key)
            if rec is not None:
                reply["t"] = "value"
                reply["record"] = rec.to_wire()
            else:
                reply["t"] = "nodes"
                reply["nodes"] = [c.to_wire() for c in self.table.closest(key)]
        elif t == "put":
            ok = self._maybe_store(SignedRecord.from_wire(msg["record"]))
            reply["t"] = "stored"
            reply["ok"] = ok
        else:
            return
        self._send(reply, src)

    def _send(self, msg: dict, dst: tuple[str, int]) -> None:
        msg["sig"] = self.ident.sign(_msg_signing_bytes(msg)).hex()
        try:
            self.sock.sendto(json.dumps(msg).encode(), dst)
        except OSError:
            pass

    def _rpc(self, msg: dict, dst: tuple[str, int],
             timeout_s: Optional[float] = None, attempts: int = 2,
             ) -> Optional[dict]:
        """Request -> first matching response; one bounded retry (plain UDP:
        a single lost datagram must not read as a dead peer)."""
        rid = secrets.token_hex(8)
        msg = dict(msg, rid=rid, **{"from": self.ident.peer_id})
        ev = threading.Event()
        hits: list = []
        # dst rides the entry so the response path can require the reply
        # to come from the address we actually queried before it may
        # update the routing table. Hostname dsts resolve first
        # (_resolve_dst — numeric-IP fast path, memoized DNS): recvfrom
        # reports the numeric source IP, so a literal hostname tuple
        # would never match its own replies and seed bootstrap
        # (DHT_BOOTSTRAP=host:port) would silently never table the seed.
        # (A multihomed peer replying from a different interface IP is
        # still skipped for the table update — the response itself
        # delivers; the peer enters the table on a later direct answer.)
        # Resolution happens BEFORE taking _pending_mu: the RX thread
        # needs that lock to dispatch every response, so a blocking
        # gethostbyname inside it would stall the whole node's response
        # path for the resolver timeout.
        dst_ip = self._resolve_dst(dst[0])
        with self._pending_mu:
            self._pending[rid] = (ev, hits, (dst_ip, dst[1]))
        try:
            per_try = self.rpc_timeout_s if timeout_s is None else timeout_s
            # Jittered backoff between retries (utils/backoff): every
            # node retrying a just-restarted seed at the same instant is
            # a thundering herd; the jitter decorrelates them. Bounded:
            # the extra sleep stays well under one rpc timeout, so the
            # lookup wall budgets (_iterate / the /send handler) hold.
            bo = Backoff(base_s=per_try / 8, max_s=per_try / 2, jitter=0.5)
            for i in range(max(1, attempts)):
                # Failpoint: one RPC attempt. ``drop`` = this datagram is
                # lost on the wire (the caller sees a timeout-shaped None
                # without waiting out the real timeout — fast chaos);
                # ``delay`` injects network latency before the send.
                act = failpoint("p2p.dht.rpc")
                if act is not None and act.kind == "drop":
                    if i + 1 >= max(1, attempts):
                        return None
                    continue       # counted by the follow-up attempt below
                if i > 0:
                    note_retry()
                    time.sleep(bo.next())
                self._send(dict(msg), dst)
                if ev.wait(per_try):
                    return hits[0][0]
            return None
        finally:
            with self._pending_mu:
                self._pending.pop(rid, None)

    def _resolve_dst(self, host: str) -> str:
        """Destination IP for the response-address match (see _rpc).

        Numeric IPv4 literals — the overwhelmingly common case: every
        contact learned from the wire already carries one — pass through
        on an ``inet_aton`` probe without ever touching the resolver;
        only operator-supplied bootstrap HOSTNAMES resolve, and each
        resolves once per node lifetime (memoized) so a slow or dead DNS
        server cannot stall every RPC behind a synchronous
        ``gethostbyname``. Resolution FAILURES are not memoized: DNS
        flakiness at boot must not pin a hostname to itself forever —
        the next RPC retries. Staleness trade-off: a re-pointed
        bootstrap hostname is not picked up until restart; bootstrap
        seeds are static operator config, and the cost of the
        alternative was a resolver call on the hot path of every RPC."""
        try:
            # Normalized via ntoa, not returned verbatim: inet_aton also
            # accepts abbreviated forms ('127.1', '10.1.2') that would
            # never equal recvfrom's canonical source IP — the response
            # match would then silently skip tabling the peer.
            return socket.inet_ntoa(socket.inet_aton(host))
        except OSError:
            pass
        with self._resolve_mu:
            ip = self._resolve_cache.get(host)
        if ip is not None:
            return ip
        try:
            ip = socket.gethostbyname(host)
        except OSError:
            return host                       # transient: retry next RPC
        with self._resolve_mu:
            if len(self._resolve_cache) >= 256:
                self._resolve_cache.clear()   # bounded, rebuilds on use
            self._resolve_cache[host] = ip
        return ip

    # -- routing-table maintenance -------------------------------------------

    def _challenge(self, src: tuple[str, int]) -> None:
        """Background ping of an unproven requester's source address; the
        signed pong (if any) enters the table via the response path."""
        key = "%s:%d" % src
        with self._challenge_mu:
            if key in self._challenging or len(self._challenging) >= 64:
                # Cap outstanding challenges: identities are free to mint,
                # so unbounded per-datagram thread spawn would be a cheaper
                # DoS than the hijack this defends against. At the cap new
                # (possibly legit) requesters are simply not tabled yet —
                # they retry on their next RPC.
                return
            self._challenging.add(key)

        def _go() -> None:
            try:
                self._rpc({"t": "ping"}, src)
            finally:
                with self._challenge_mu:
                    self._challenging.discard(key)

        threading.Thread(target=_go, daemon=True,
                         name="dht-challenge").start()

    def _note_contact(self, c: Contact) -> None:
        candidate = self.table.touch(c)
        if candidate is None:
            return
        # Full bucket: keep the old contact iff it still answers. The ping
        # MUST leave the rx thread — _note_contact runs on it, and the rx
        # thread is the only reader that could ever deliver the pong (a
        # same-thread _rpc would always time out, evicting live contacts
        # and stalling all datagram processing for rpc_timeout_s).
        with self._evict_mu:
            if candidate.peer_id in self._evicting:
                return
            self._evicting.add(candidate.peer_id)

        def _check() -> None:
            try:
                if self._rpc({"t": "ping"},
                             (candidate.host, candidate.port)) is None:
                    self.table.replace(candidate, c)
            finally:
                with self._evict_mu:
                    self._evicting.discard(candidate.peer_id)

        threading.Thread(target=_check, daemon=True,
                         name="dht-evict-check").start()

    # -- store ---------------------------------------------------------------

    def _maybe_store(self, rec: SignedRecord) -> bool:
        key = key_for_username(rec.username)
        if not rec.verify(expect_key=key):
            log.warning("dht: rejecting unverifiable record for %r",
                        rec.username)
            return False
        with self._store_mu:
            cur = self._store.get(key)
            if cur is not None and cur.seq > rec.seq:
                return False       # stale write (last-writer-wins, by seq)
            if cur is None and len(self._store) >= self.max_records:
                # Bound the store (anyone can mint identities and PUT):
                # sweep expired entries, then evict the key FARTHEST from
                # our node id — Kademlia stores keys near their closest
                # nodes, so the farthest record is the one some other node
                # is responsible for.
                now = time.monotonic()
                for k2 in [k2 for k2, r in self._store.items()
                           if now - r.stored_at > self.record_ttl_s]:
                    del self._store[k2]
                if len(self._store) >= self.max_records:
                    victim = max(self._store,
                                 key=lambda k2: _distance(k2, self.node_id))
                    if _distance(key, self.node_id) >= _distance(
                            victim, self.node_id):
                        return False   # new key is the farthest — refuse
                    del self._store[victim]
            self._store[key] = rec
        return True

    def _load(self, key: int) -> Optional[SignedRecord]:
        with self._store_mu:
            rec = self._store.get(key)
            if rec is None:
                return None
            if time.monotonic() - rec.stored_at > self.record_ttl_s:
                del self._store[key]
                return None
            return rec

    def _suspect(self, c: Contact) -> None:
        """A contact missed a lookup RPC: evict only after a dedicated ping
        also fails (deduped, off-thread). If it answers, the signed-pong
        path refreshes its recency instead."""
        with self._challenge_mu:
            key = "suspect:" + c.peer_id
            if key in self._challenging or len(self._challenging) >= 64:
                return
            self._challenging.add(key)

        def _go() -> None:
            try:
                if self._rpc({"t": "ping"}, (c.host, c.port)) is None:
                    self.table.remove(c.peer_id)
            finally:
                with self._challenge_mu:
                    self._challenging.discard(key)

        threading.Thread(target=_go, daemon=True, name="dht-suspect").start()

    # -- iterative lookups ---------------------------------------------------

    def _fan_out(self, contacts: list[Contact],
                 fn: Callable[[Contact], object],
                 max_wait_s: Optional[float] = None) -> dict[Contact, object]:
        """Run ``fn`` over contacts on the shared pool; drop stragglers and
        raised calls (a missing key = no answer). Bounded: fn is an _rpc
        wrapper, itself capped at attempts*timeout; ``max_wait_s``
        additionally clamps the collect window (lookup deadlines)."""
        if not contacts:
            return {}
        out: dict[Contact, object] = {}
        try:
            futs = {self._pool.submit(fn, c): c for c in contacts}
        except RuntimeError:      # pool shut down: node closing
            return {}
        wait = 2 * self.rpc_timeout_s + 0.5
        if max_wait_s is not None:
            wait = min(wait, max_wait_s)
        try:
            for f in as_completed(futs, timeout=wait):
                try:
                    out[futs[f]] = f.result()
                except Exception:  # noqa: BLE001 — treat as no answer
                    pass
        except FutTimeout:
            pass
        for f in futs:
            f.cancel()   # drop any still-queued RPCs nobody will read
        return out

    def _iterate(self, target: int,
                 query: Callable[[Contact],
                                 Optional[tuple[Optional[SignedRecord],
                                                list[Contact]]]],
                 deadline: Optional[float] = None,
                 ) -> tuple[Optional[SignedRecord], list[Contact]]:
        """Shared iterative-lookup core: keep querying the alpha closest
        unqueried candidates until the k closest are all queried or a value
        surfaces. ``query`` returns None when the peer gave NO answer (the
        suspect/eviction path) vs ``(record_or_None, contacts)`` for any
        answer. Returns (best_record_or_None, k closest live contacts).
        ``deadline`` (time.monotonic()) bounds total wall time: a table
        full of dead contacts otherwise costs multiple alpha-rounds of
        UDP timeouts (ADVICE r4 — the /send handler runs this inline)."""
        shortlist: dict[str, Contact] = {
            c.peer_id: c for c in self.table.closest(target, self.k)}
        queried: set[str] = set()
        best: Optional[SignedRecord] = None
        while True:
            ordered = sorted(shortlist.values(),
                             key=lambda c: _distance(c.node_id, target))
            batch = [c for c in ordered[:self.k]
                     if c.peer_id not in queried][:ALPHA]
            past = (deadline is not None
                    and time.monotonic() >= deadline)
            if past or not batch:
                live = [c for c in ordered if c.peer_id in queried]
                return best, live[:self.k]
            # Clamp the round's collect window to the remaining budget:
            # without this, a deadline that lands mid-round still waits
            # _fan_out's full as_completed timeout (~1.7 s) past it.
            wait = None
            if deadline is not None:
                wait = max(0.05, deadline - time.monotonic())
            results = self._fan_out(batch, query, max_wait_s=wait)
            for c in batch:
                queried.add(c.peer_id)
                res = results.get(c)
                if res is None:
                    # No answer (query returns None on RPC timeout, never
                    # an empty tuple): out of this lookup, but NOT out of
                    # the routing table directly — a dedicated background
                    # ping decides eviction (one miss under bursty loss
                    # must not strip live long-lived contacts; the
                    # docstring's liveness bias).
                    shortlist.pop(c.peer_id, None)
                    self._suspect(c)
                    continue
                rec, nodes = res
                if rec is not None and (best is None or rec.seq > best.seq):
                    best = rec
                for nc in nodes:
                    if nc.peer_id != self.ident.peer_id:
                        shortlist.setdefault(nc.peer_id, nc)
            if best is not None:
                # FIND_VALUE terminates on the first verified value — the
                # /send path calls this inline, and walking the rest of the
                # shortlist would add seconds of UDP timeouts for nothing.
                ordered = sorted(shortlist.values(),
                                 key=lambda c: _distance(c.node_id, target))
                live = [c for c in ordered if c.peer_id in queried]
                return best, live[:self.k]

    def iterative_find_node(self, target: int) -> list[Contact]:
        def q(c: Contact) -> Optional[tuple[None, list[Contact]]]:
            resp = self._rpc({"t": "find_node", "target": f"{target:064x}"},
                             (c.host, c.port))
            if resp is None:
                return None            # no answer -> suspect path
            if resp.get("t") != "nodes":
                return (None, [])      # answered, just not useful
            return None, [Contact.from_wire(d) for d in resp.get("nodes", [])]
        _, closest = self._iterate(target, q)
        return closest

    def put_record(self, rec: SignedRecord) -> int:
        """Store ``rec`` on the k closest nodes to its key (and locally if
        we are one of them). Returns the number of stores acknowledged."""
        key = key_for_username(rec.username)
        closest = self.iterative_find_node(key)
        self._maybe_store(rec)
        # Parallel stores: serial dead-contact timeouts would stack to
        # ~10s+ on the re-register thread after churn.
        results = self._fan_out(
            closest[:self.k],
            lambda c: self._rpc({"t": "put", "record": rec.to_wire()},
                                (c.host, c.port)))
        return sum(1 for resp in results.values()
                   if resp is not None and resp.get("ok"))

    def get_record(self, username: str,
                   budget_s: Optional[float] = None) -> Optional[SignedRecord]:
        """Iterative value lookup; validates locally before returning (a
        malicious responder cannot shortcut the signature check).
        ``budget_s`` caps total lookup wall time (see _iterate)."""
        key = key_for_username(username)
        local = self._load(key)

        def q(c: Contact) -> Optional[tuple[Optional[SignedRecord],
                                            list[Contact]]]:
            resp = self._rpc({"t": "get", "key": f"{key:064x}"},
                             (c.host, c.port))
            if resp is None:
                return None            # no answer -> suspect path
            if resp.get("t") == "value":
                try:
                    rec = SignedRecord.from_wire(resp["record"])
                except (KeyError, ValueError, TypeError):
                    return (None, [])
                return (rec if rec.verify(expect_key=key) else None), []
            if resp.get("t") == "nodes":
                return None, [Contact.from_wire(d)
                              for d in resp.get("nodes", [])]
            return (None, [])

        deadline = (time.monotonic() + budget_s
                    if budget_s is not None else None)
        best, _ = self._iterate(key, q, deadline=deadline)
        if local is not None and (best is None or local.seq > best.seq):
            best = local
        return best

    def put_self_record(self, username: str, addrs: list[str]) -> int:
        return self.put_record(SignedRecord.create(self.ident, username, addrs))


def parse_seeds(s: str) -> list[tuple[str, int]]:
    """Parse ``DHT_BOOTSTRAP``: comma-separated host:port pairs. Malformed
    entries are skipped with a warning — one typo must not kill the whole
    join (the node treats every DHT failure as non-fatal)."""
    seeds = []
    for part in filter(None, (p.strip() for p in s.split(","))):
        host, _, port = part.rpartition(":")
        try:
            seeds.append((host or "127.0.0.1", int(port)))
        except ValueError:
            log.warning("ignoring malformed DHT_BOOTSTRAP entry %r", part)
    return seeds
