"""Authenticated, encrypted P2P streams over TCP.

The port's copy of ``p2p_llm_chat_tpu/p2p/transport.py``: the same wire
bytes and behaviour, so port and reference peers mix in one fleet; the
port imports nothing of the reference package.

From-scratch equivalent of the reference's libp2p host + noise-secured
streams (SURVEY.md §1 L0; host construction go/cmd/node/main.go:137-144,
stream open/write/close go/cmd/node/main.go:245-261, handler
go/cmd/node/main.go:158-172). Not a port — a minimal Noise-XX-style design:

Handshake (dialer D -> listener L), all over one TCP connection:

    1. D->L  plaintext frame: eph_pub_D                      (32B X25519)
    2. L->D  plaintext frame: eph_pub_L || static_pub_L || sig_L
             where sig_L = Ed25519(static_L, "hs1" || eph_D || eph_L || static_pub_L)
    3. both derive: shared = X25519(eph_D, eph_L)
             k_D2L, k_L2D = HKDF-SHA256(shared, salt=eph_D||eph_L, info=PROTO, 64B)
    4. D->L  encrypted frame: static_pub_D || sig_D
             where sig_D = Ed25519(static_D, "hs2" || eph_D || eph_L || static_pub_D)
    5. D->L  encrypted frame: protocol ID (stream dispatch, the equivalent
             of libp2p protocol negotiation for SetStreamHandler)

Both sides authenticate with their static Ed25519 identity; peer IDs are
self-certifying (identity.py) so the dialer verifies the listener against
the directory record and the listener learns the authenticated remote peer.
Data frames are ChaCha20-Poly1305 with a per-direction 96-bit counter nonce,
4-byte big-endian length prefix. A stream carries whole messages: the sender
writes frames and closes; the receiver reads frames until EOF (the
reference's one-stream-per-message framing, go/cmd/node/main.go:160).

Relay circuits: `dial` transparently tunnels through a relay for
``/p2p-circuit`` multiaddrs — the end-to-end handshake runs *through* the
relay's byte pipe, so the relay never sees plaintext or holds keys (same
property as libp2p circuit-relay-v2, go/cmd/relay/main.go:37).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Callable, Optional

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
except ImportError:
    # INSECURE stdlib dev fallback, explicit opt-in only (P2P_DEV_CRYPTO=1
    # — see p2p/devcrypto.py for exactly what is and is not provided).
    from .devcrypto import require_dev_crypto
    require_dev_crypto("p2p.transport")
    from .devcrypto import (            # type: ignore[assignment]
        ChaCha20Poly1305,
        Ed25519PublicKey,
        HKDF,
        X25519PrivateKey,
        X25519PublicKey,
        hashes,
        serialization,
    )

from ..utils.env import env_bool
from ..utils.failpoints import failpoint
from ..utils.log import get_logger
from .addr import Multiaddr
from .identity import Identity, peer_id_to_public_key, public_key_to_peer_id

log = get_logger("p2p")

PROTO_INFO = b"/p2p-llm-chat-tpu/secure/1.0.0"
MAX_FRAME = 16 * 1024 * 1024
HANDSHAKE_TIMEOUT = 10.0

# Relay control message types (JSON, plaintext first frame on a relay conn).
RELAY_RESERVE = "reserve"
RELAY_HOP = "hop"
RELAY_ACCEPT = "accept"
RELAY_INCOMING = "incoming"
RELAY_PING = "ping"
RELAY_PONG = "pong"
# NAT hole punching (coordination only — message bytes then flow directly
# peer-to-peer over UDP, see p2p/udp.py; the relay never splices them).
RELAY_PUNCH = "punch"
RELAY_PUNCH_ACK = "punch_ack"


class HandshakeError(Exception):
    pass


# ---------------------------------------------------------------------------
# Framing primitives (shared by plaintext handshake + relay control frames)
# ---------------------------------------------------------------------------

def send_raw_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack(">I", len(data)) + data)


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_raw_frame(sock: socket.socket) -> Optional[bytes]:
    header = recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    if length == 0:
        return b""
    return recv_exact(sock, length)


def send_json_frame(sock: socket.socket, obj: dict) -> None:
    send_raw_frame(sock, json.dumps(obj).encode("utf-8"))


def recv_json_frame(sock: socket.socket) -> Optional[dict]:
    raw = recv_raw_frame(sock)
    if raw is None:
        return None
    return json.loads(raw.decode("utf-8"))


# ---------------------------------------------------------------------------
# Secure stream
# ---------------------------------------------------------------------------

class SecureStream:
    """An authenticated encrypted byte-frame stream over one TCP connection."""

    def __init__(self, sock: socket.socket, send_key: bytes, recv_key: bytes,
                 remote_peer_id: str) -> None:
        self._sock = sock
        self._send = ChaCha20Poly1305(send_key)
        self._recv = ChaCha20Poly1305(recv_key)
        self._send_ctr = 0        # guarded-by: _send_lock
        self._recv_ctr = 0
        self._send_lock = threading.Lock()
        self.remote_peer_id = remote_peer_id

    def send_frame(self, data: bytes) -> None:
        with self._send_lock:
            nonce = self._send_ctr.to_bytes(12, "little")
            self._send_ctr += 1
            send_raw_frame(self._sock, self._send.encrypt(nonce, data, None))

    def recv_frame(self) -> Optional[bytes]:
        ct = recv_raw_frame(self._sock)
        if ct is None:
            return None
        nonce = self._recv_ctr.to_bytes(12, "little")
        self._recv_ctr += 1
        return self._recv.decrypt(nonce, ct, None)

    def read_all(self) -> bytes:
        """Read frames until the remote closes; concatenation of payloads.

        The receive-side analogue of the reference's ``io.ReadAll`` until
        EOF (go/cmd/node/main.go:160).
        """
        parts = []
        while True:
            f = self.recv_frame()
            if f is None:
                return b"".join(parts)
            parts.append(f)

    def close_write(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def settimeout(self, t: Optional[float]) -> None:
        self._sock.settimeout(t)


def _derive_keys(eph_priv: X25519PrivateKey, remote_eph_pub: bytes,
                 eph_d: bytes, eph_l: bytes) -> tuple[bytes, bytes]:
    shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(remote_eph_pub))
    okm = HKDF(
        algorithm=hashes.SHA256(), length=64, salt=eph_d + eph_l, info=PROTO_INFO
    ).derive(shared)
    return okm[:32], okm[32:]  # (k_dialer_to_listener, k_listener_to_dialer)


def _x25519_pub_bytes(priv: X25519PrivateKey) -> bytes:
    return priv.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )


def dialer_handshake(sock: socket.socket, identity: Identity,
                     expected_peer_id: Optional[str]) -> SecureStream:
    # Failpoint: the secure-channel dial handshake. ``drop``/``error``
    # surface as the HandshakeError every dial path already degrades on
    # (node._deliver collects it and tries the next advertised addr);
    # ``raise`` exercises the same paths with an unexpected fault.
    act = failpoint("p2p.transport.handshake")
    if act is not None and act.kind in ("drop", "error"):
        raise HandshakeError(
            act.msg or "injected fault: p2p.transport.handshake")
    sock.settimeout(HANDSHAKE_TIMEOUT)
    eph = X25519PrivateKey.generate()
    eph_d = _x25519_pub_bytes(eph)
    send_raw_frame(sock, eph_d)

    msg2 = recv_raw_frame(sock)
    if msg2 is None or len(msg2) != 32 + 32 + 64:
        raise HandshakeError("bad handshake msg2")
    eph_l, static_l, sig_l = msg2[:32], msg2[32:64], msg2[64:]
    listener_pub = Ed25519PublicKey.from_public_bytes(static_l)
    try:
        listener_pub.verify(sig_l, b"hs1" + eph_d + eph_l + static_l)
    except Exception as e:
        raise HandshakeError(f"listener signature invalid: {e}") from None
    remote_peer_id = public_key_to_peer_id(listener_pub)
    if expected_peer_id is not None and remote_peer_id != expected_peer_id:
        raise HandshakeError(
            f"peer identity mismatch: expected {expected_peer_id}, got {remote_peer_id}"
        )

    k_d2l, k_l2d = _derive_keys(eph, eph_l, eph_d, eph_l)
    stream = SecureStream(sock, send_key=k_d2l, recv_key=k_l2d,
                          remote_peer_id=remote_peer_id)
    sig_d = identity.sign(b"hs2" + eph_d + eph_l + identity.public_bytes)
    stream.send_frame(identity.public_bytes + sig_d)
    sock.settimeout(None)
    return stream


def listener_handshake(sock: socket.socket, identity: Identity,
                       first_frame: Optional[bytes] = None) -> SecureStream:
    sock.settimeout(HANDSHAKE_TIMEOUT)
    eph_d = first_frame if first_frame is not None else recv_raw_frame(sock)
    if eph_d is None or len(eph_d) != 32:
        raise HandshakeError("bad handshake msg1")
    eph = X25519PrivateKey.generate()
    eph_l = _x25519_pub_bytes(eph)
    static_l = identity.public_bytes
    sig_l = identity.sign(b"hs1" + eph_d + eph_l + static_l)
    send_raw_frame(sock, eph_l + static_l + sig_l)

    k_d2l, k_l2d = _derive_keys(eph, eph_d, eph_d, eph_l)
    stream = SecureStream(sock, send_key=k_l2d, recv_key=k_d2l,
                          remote_peer_id="")
    msg3 = stream.recv_frame()
    if msg3 is None or len(msg3) != 32 + 64:
        raise HandshakeError("bad handshake msg3")
    static_d, sig_d = msg3[:32], msg3[32:]
    dialer_pub = Ed25519PublicKey.from_public_bytes(static_d)
    try:
        dialer_pub.verify(sig_d, b"hs2" + eph_d + eph_l + static_d)
    except Exception as e:
        raise HandshakeError(f"dialer signature invalid: {e}") from None
    stream.remote_peer_id = public_key_to_peer_id(dialer_pub)
    sock.settimeout(None)
    return stream


# ---------------------------------------------------------------------------
# Host
# ---------------------------------------------------------------------------

StreamHandler = Callable[[SecureStream, str], None]


class P2PHost:
    """Listens for inbound secure streams and dials outbound ones.

    The equivalent of the reference's libp2p host: ``set_stream_handler``
    mirrors ``host.SetStreamHandler`` (go/cmd/node/main.go:158), ``new_stream``
    mirrors ``host.NewStream`` (go/cmd/node/main.go:245), ``connect`` mirrors
    ``host.Connect`` (go/cmd/node/main.go:205). Additionally supports relay
    reservations + circuit dialing (the reference ships the relay daemon but
    never wires it into the node — SURVEY.md §2 C6; here it is wired).
    """

    def __init__(self, identity: Optional[Identity] = None,
                 listen_addr: str = "127.0.0.1:0",
                 advertise_host: Optional[str] = None) -> None:
        self.identity = identity or Identity.generate()
        host, _, port = listen_addr.rpartition(":")
        self._listen_host = host or "127.0.0.1"
        self._listen_port = int(port or 0)
        self._advertise_host = advertise_host or self._listen_host
        self._handlers: dict[str, StreamHandler] = {}
        self._server_sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._relay_threads: list[threading.Thread] = []
        self._relay_addrs: list[Multiaddr] = []
        self._extra_addrs: list[Multiaddr] = []
        self._relay_socks: list[socket.socket] = []  # guarded-by: _relay_socks_mu
        self._relay_socks_mu = threading.Lock()
        # Negative cache for hole punching: peers whose punch failed are
        # dialed via the relay circuit directly for a while, so every
        # /send to a UDP-blocked peer doesn't re-pay the punch stall.
        # Dials run on whatever thread asked (HTTP handlers, the node
        # loop), so the read-prune-insert below must hold the lock — the
        # unlocked version lost concurrent failure entries to the prune
        # rebuild (graftcheck lock-discipline finding).
        self._punch_failed: dict[str, float] = {}  # guarded-by: _punch_mu
        self._punch_mu = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    @property
    def peer_id(self) -> str:
        return self.identity.peer_id

    def start(self) -> "P2PHost":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._listen_host, self._listen_port))
        s.listen(128)
        self._listen_port = s.getsockname()[1]
        self._server_sock = s
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        log.info("p2p host %s listening on %s:%d",
                 self.peer_id[:12], self._listen_host, self._listen_port)
        return self

    def close(self) -> None:
        self._closed.set()
        if self._server_sock is not None:
            # shutdown() before close(): a thread blocked in accept() holds a
            # kernel reference to the listening socket, so close() alone would
            # leave the port accepting connections until accept() returns.
            try:
                self._server_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server_sock.close()
            except OSError:
                pass
        # Close relay control connections so _relay_control_loop threads
        # blocked in recv exit and the relay drops our reservations promptly
        # (otherwise it keeps routing circuits to a closed host).
        with self._relay_socks_mu:
            socks, self._relay_socks = self._relay_socks, []
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def addrs(self) -> list[Multiaddr]:
        """Advertised multiaddrs, each encapsulating /p2p/<peer-id>
        (go/cmd/node/main.go:176-181), plus any extra advertised addrs
        (e.g. a NAT-PMP-mapped external address) and relay circuit addrs."""
        out = [Multiaddr(self._advertise_host, self._listen_port, peer_id=self.peer_id)]
        for extra in list(self._extra_addrs):
            out.append(extra.with_peer(self.peer_id))
        for r in self._relay_addrs:
            out.append(Multiaddr(r.host, r.port, peer_id=self.peer_id,
                                 relay_peer_id=r.peer_id, is_circuit=True))
        return out

    def add_advertised_addr(self, maddr: Multiaddr) -> None:
        """Advertise an additional dialable address for this host (the
        NAT-PMP mapper's external ip:port; parity with the addrs a
        NATPortMap'd libp2p host announces)."""
        if not any(a.host == maddr.host and a.port == maddr.port
                   for a in self._extra_addrs):
            self._extra_addrs.append(maddr)

    def remove_advertised_addr(self, maddr: Multiaddr) -> None:
        """Stop advertising an extra addr (a lapsed/moved NAT mapping)."""
        self._extra_addrs = [a for a in self._extra_addrs
                             if (a.host, a.port) != (maddr.host, maddr.port)]

    @property
    def listen_port(self) -> int:
        return self._listen_port

    @property
    def advertise_host(self) -> str:
        return self._advertise_host

    def set_stream_handler(self, protocol_id: str, handler: StreamHandler) -> None:
        self._handlers[protocol_id] = handler

    # -- inbound -------------------------------------------------------------

    def _accept_loop(self) -> None:
        assert self._server_sock is not None
        while not self._closed.is_set():
            try:
                conn, _addr = self._server_sock.accept()
            except OSError:
                return
            if self._closed.is_set():
                try:
                    conn.close()
                except OSError:
                    pass
                return
            threading.Thread(target=self._handle_inbound, args=(conn,),
                             daemon=True).start()

    def _handle_inbound(self, conn: socket.socket,
                        first_frame: Optional[bytes] = None) -> None:
        try:
            stream = listener_handshake(conn, self.identity, first_frame)
            proto_frame = stream.recv_frame()
            if proto_frame is None:
                stream.close()
                return
            protocol_id = proto_frame.decode("utf-8")
            handler = self._handlers.get(protocol_id)
            if handler is None:
                log.warning("no handler for protocol %s from %s",
                            protocol_id, stream.remote_peer_id[:12])
                stream.close()
                return
            handler(stream, stream.remote_peer_id)
        except (HandshakeError, ValueError, OSError, json.JSONDecodeError) as e:
            log.debug("inbound stream failed: %s", e)
            try:
                conn.close()
            except OSError:
                pass

    # -- outbound ------------------------------------------------------------

    def _tcp_connect(self, host: str, port: int, timeout: float) -> socket.socket:
        return socket.create_connection((host, port), timeout=timeout)

    def dial(self, maddr: Multiaddr, timeout: float = 5.0) -> SecureStream:
        """Open an authenticated secure connection to ``maddr`` (direct,
        hole-punched UDP, or relay circuit). The 5 s default matches the
        reference's /send connect deadline (go/cmd/node/main.go:235).

        Circuit addrs first attempt a UDP hole punch coordinated over
        the relay (p2p/udp.py — message bytes then flow peer-to-peer,
        matching the reference's direct-connectivity posture of QUIC +
        NATPortMap, go/cmd/node/main.go:139-143) and fall back to the
        relay's byte splice when punching fails (symmetric NATs, UDP
        blocked). ``P2P_HOLEPUNCH=0`` disables the attempt."""
        if maddr.is_circuit:
            deadline = time.monotonic() + timeout
            punch_ok = env_bool("P2P_HOLEPUNCH", True)
            # Negative cache keyed by REAL peer ids only (id-less circuit
            # addrs would all share one slot and suppress each other),
            # pruned on insert so long-lived hosts don't accumulate
            # entries forever.
            if maddr.peer_id:
                with self._punch_mu:
                    failed_at = self._punch_failed.get(maddr.peer_id)
            else:
                failed_at = None
            if failed_at is not None and time.time() - failed_at < 60.0:
                punch_ok = False
            if punch_ok:
                try:
                    return self._dial_holepunch(maddr, timeout)
                except (OSError, ConnectionError, HandshakeError,
                        ValueError) as e:
                    if maddr.peer_id:
                        now = time.time()
                        with self._punch_mu:
                            self._punch_failed = {
                                pid: t for pid, t in
                                self._punch_failed.items() if now - t < 60.0}
                            self._punch_failed[maddr.peer_id] = now
                    log.debug("hole punch to %s failed (%s); "
                              "falling back to relay circuit",
                              (maddr.peer_id or "?")[:12], e)
            # The relay fallback spends whatever of the dial deadline the
            # punch attempt left (never less than a floor so a punch that
            # consumed the budget still gets one quick relay try).
            timeout = max(0.5, deadline - time.monotonic())
            sock = self._tcp_connect(maddr.host, maddr.port, timeout)
            try:
                send_json_frame(sock, {"type": RELAY_HOP, "target": maddr.peer_id})
                resp = recv_json_frame(sock)
                if not resp or not resp.get("ok"):
                    raise ConnectionError(
                        f"relay hop refused: {resp.get('error') if resp else 'closed'}")
            except Exception:
                sock.close()
                raise
        else:
            sock = self._tcp_connect(maddr.host, maddr.port, timeout)
        try:
            return dialer_handshake(sock, self.identity, maddr.peer_id)
        except Exception:
            sock.close()
            raise

    def _dial_holepunch(self, maddr: Multiaddr,
                        timeout: float = 5.0) -> SecureStream:
        """Direct UDP connection to a NAT'd peer: learn our observed UDP
        endpoint from the relay, exchange endpoints over the relay's
        control plane, punch, then run the normal handshake over the
        reliable datagram layer."""
        from .udp import ReliableDgram, observe_udp_addr, punch

        usock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        usock.bind(("0.0.0.0", 0))
        deadline = time.monotonic() + timeout

        def left() -> float:
            rem = deadline - time.monotonic()
            if rem <= 0.05:
                raise ConnectionError("punch deadline exhausted")
            return rem

        try:
            # ONE deadline spans all three phases (observe, TCP punch
            # exchange, handshake retransmits) — each phase gets only the
            # remaining budget, so a UDP-hostile network falls back to
            # the relay circuit within the reference's 5 s /send
            # deadline instead of stacking per-phase timeouts ~2-3x it.
            observed = observe_udp_addr(usock, maddr.host, maddr.port,
                                        timeout=min(1.5, left() / 3),
                                        attempts=2)
            if observed is None:
                observed = usock.getsockname()
                if observed[0] in ("0.0.0.0", "::", ""):
                    # Without the relay's observe endpoint a wildcard
                    # bind has no routable address to advertise — a
                    # doomed punch would just stall the send path.
                    raise ConnectionError("no routable UDP endpoint")
            tsock = self._tcp_connect(maddr.host, maddr.port, left())
            try:
                tsock.settimeout(left())
                send_json_frame(tsock, {
                    "type": RELAY_PUNCH, "target": maddr.peer_id,
                    "udp_addr": [observed[0], observed[1]],
                })
                resp = recv_json_frame(tsock)
            finally:
                tsock.close()
            if not resp or not resp.get("ok") or not resp.get("udp_addr"):
                raise ConnectionError(
                    f"punch refused: {resp.get('error') if resp else 'closed'}")
            try:
                peer = (str(resp["udp_addr"][0]), int(resp["udp_addr"][1]))
            except (TypeError, ValueError, KeyError, IndexError):
                raise ConnectionError(
                    f"bad punch response addr: {resp.get('udp_addr')!r}"
                ) from None
            punch(usock, peer)
            stream = dialer_handshake(
                ReliableDgram(usock, peer, send_timeout_s=left()),
                self.identity, maddr.peer_id)
            log.info("hole-punched direct UDP path to %s",
                     stream.remote_peer_id[:12])
            return stream
        except Exception:
            usock.close()
            raise

    def new_stream(self, maddr: Multiaddr, protocol_id: str,
                   timeout: float = 5.0) -> SecureStream:
        stream = self.dial(maddr, timeout=timeout)
        stream.send_frame(protocol_id.encode("utf-8"))
        return stream

    def connect(self, maddr: Multiaddr, timeout: float = 5.0) -> str:
        """Reachability check: dial + handshake + close; returns remote peer
        id. Used for bootstrap connects (go/cmd/node/main.go:189-211)."""
        stream = self.dial(maddr, timeout=timeout)
        pid = stream.remote_peer_id
        stream.close()
        return pid

    # -- relay reservation ---------------------------------------------------

    def reserve_on_relay(self, relay_addr: Multiaddr,
                         retry_interval: float = 5.0) -> None:
        """Maintain a reservation on a relay so NAT'd peers are reachable at
        ``/.../p2p/<relay>/p2p-circuit/p2p/<us>``. Runs a daemon thread that
        holds a control connection and dials back for each incoming circuit."""
        if relay_addr.peer_id is None:
            raise ValueError("relay multiaddr must include /p2p/<relay-id>")
        self._relay_addrs.append(relay_addr)
        t = threading.Thread(target=self._relay_control_loop,
                             args=(relay_addr, retry_interval), daemon=True)
        t.start()
        self._relay_threads.append(t)

    def _relay_control_loop(self, relay_addr: Multiaddr, retry_interval: float) -> None:
        while not self._closed.is_set():
            sock = None
            try:
                sock = self._tcp_connect(relay_addr.host, relay_addr.port, 5.0)
                # Register under the lock with a _closed re-check: close()
                # sets _closed before swapping the list out, so a connect
                # racing with close() either lands in the swapped list (and
                # is closed there) or sees _closed here and self-closes —
                # never a leaked live reservation.
                with self._relay_socks_mu:
                    if self._closed.is_set():
                        sock.close()
                        return
                    self._relay_socks.append(sock)
                ts = str(int(time.time()))
                payload = f"{RELAY_RESERVE}|{self.peer_id}|{ts}".encode()
                sig = self.identity.sign(payload)
                send_json_frame(sock, {
                    "type": RELAY_RESERVE, "peer_id": self.peer_id, "ts": ts,
                    "sig": sig.hex(),
                })
                resp = recv_json_frame(sock)
                if not resp or not resp.get("ok"):
                    raise ConnectionError(f"reservation refused: {resp}")
                # Clear the connect timeout: this is a long-lived idle control
                # channel — a lingering per-socket timeout would make the
                # reservation flap every few seconds.
                sock.settimeout(None)
                log.info("reserved on relay %s", relay_addr)
                # PONGs and punch acks share the control socket with the
                # read loop's thread and punch threads; serialise sends.
                send_mu = threading.Lock()
                while not self._closed.is_set():
                    msg = recv_json_frame(sock)
                    if msg is None:
                        raise ConnectionError("relay control channel closed")
                    if msg.get("type") == RELAY_INCOMING:
                        threading.Thread(
                            target=self._accept_relayed,
                            args=(relay_addr, msg["conn_id"]), daemon=True,
                        ).start()
                    elif msg.get("type") == RELAY_PUNCH:
                        threading.Thread(
                            target=self._accept_punched,
                            args=(relay_addr, sock, send_mu, msg),
                            daemon=True,
                        ).start()
                    elif msg.get("type") == RELAY_PING:
                        with send_mu:
                            send_json_frame(sock, {"type": RELAY_PONG})
            except (OSError, ConnectionError, ValueError) as e:
                if sock is not None:
                    with self._relay_socks_mu:
                        if sock in self._relay_socks:
                            self._relay_socks.remove(sock)
                    try:
                        sock.close()
                    except OSError:
                        pass
                if self._closed.is_set():
                    return
                log.debug("relay control loop error (%s); retrying in %.0fs",
                          e, retry_interval)
                time.sleep(retry_interval)

    def _accept_punched(self, relay_addr: Multiaddr,
                        control_sock: socket.socket, send_mu: threading.Lock,
                        msg: dict) -> None:
        """Listener side of a hole punch: open a UDP socket, learn its
        observed endpoint, answer over the control channel, punch toward
        the dialer, and accept the normal inbound handshake over the
        reliable datagram layer (p2p/udp.py)."""
        from .udp import ReliableDgram, observe_udp_addr, punch

        try:
            dialer = (str(msg["udp_addr"][0]), int(msg["udp_addr"][1]))
        except (KeyError, TypeError, ValueError, IndexError):
            return
        usock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            usock.bind(("0.0.0.0", 0))
            observed = observe_udp_addr(usock, relay_addr.host,
                                        relay_addr.port, timeout=1.5,
                                        attempts=2)
            if observed is None:
                observed = usock.getsockname()
                if observed[0] in ("0.0.0.0", "::", ""):
                    # No routable endpoint to advertise: ack with null so
                    # the relay fails the dialer fast instead of letting
                    # it wait out the accept window.
                    with send_mu:
                        send_json_frame(control_sock, {
                            "type": RELAY_PUNCH_ACK,
                            "punch_id": msg.get("punch_id"),
                            "udp_addr": None,
                        })
                    usock.close()
                    return
            with send_mu:
                send_json_frame(control_sock, {
                    "type": RELAY_PUNCH_ACK,
                    "punch_id": msg.get("punch_id"),
                    "udp_addr": [observed[0], observed[1]],
                })
            punch(usock, dialer)
            self._handle_inbound(ReliableDgram(usock, dialer))
        except (OSError, ConnectionError, ValueError) as e:
            log.debug("punched accept failed: %s", e)
            try:
                usock.close()
            except OSError:
                pass

    def _accept_relayed(self, relay_addr: Multiaddr, conn_id: str) -> None:
        """Dial back to the relay to take an incoming circuit; the byte pipe
        then carries a normal inbound handshake."""
        try:
            sock = self._tcp_connect(relay_addr.host, relay_addr.port, 5.0)
            send_json_frame(sock, {"type": RELAY_ACCEPT, "conn_id": conn_id})
            resp = recv_json_frame(sock)
            if not resp or not resp.get("ok"):
                sock.close()
                return
            sock.settimeout(None)
            self._handle_inbound(sock)
        except (OSError, ConnectionError, ValueError) as e:
            log.debug("relayed accept failed: %s", e)
