"""Circuit relay daemon for NAT traversal.

The port's copy of ``p2p_llm_chat_tpu/relay.py``: the same wire bytes and
behaviour, so port and reference peers mix in one fleet; the port imports
nothing of the reference package.

Reference: go/cmd/relay/main.go — a standalone libp2p circuit-relay-v2 hop
with default resource limits that prints its multiaddrs and blocks forever.
Ours is the from-scratch equivalent for the in-tree transport (p2p/transport):

- NAT'd peers hold an authenticated *reservation* (Ed25519-signed, verified
  against the self-certifying peer id) over a persistent control connection.
- A dialer sends a HOP request naming the target peer; the relay signals the
  target over its control channel, the target dials back to ACCEPT, and the
  relay splices the two TCP connections byte-for-byte.
- The end-to-end secure handshake runs *through* the splice, so the relay
  never holds keys or sees plaintext — the property circuit-relay-v2
  provides in the reference.
- Resource limits in the spirit of relayv2 ``DefaultResources()``
  (go/cmd/relay/main.go:37): max reservations, max circuits, per-circuit
  idle timeout, pending-accept timeout.

Env: ``RELAY_ADDR`` (listen, default 127.0.0.1:4100), ``RELAY_MAX_RESERVATIONS``,
``RELAY_MAX_CIRCUITS``.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from .p2p import Identity, Multiaddr, peer_id_to_public_key
from .p2p.transport import (
    RELAY_ACCEPT,
    RELAY_HOP,
    RELAY_INCOMING,
    RELAY_PING,
    RELAY_PONG,
    RELAY_PUNCH,
    RELAY_PUNCH_ACK,
    RELAY_RESERVE,
    recv_json_frame,
    send_json_frame,
)
from .utils.env import env_int, env_or
from .utils.failpoints import (FailpointError, failpoint,
                               load_env as load_failpoints_env)
from .utils.log import get_logger
from .utils import native

log = get_logger("relay")

RESERVATION_STALE_S = 120.0     # control channel considered dead after this
CIRCUIT_IDLE_TIMEOUT_S = 300.0  # spliced circuit killed after idle
ACCEPT_TIMEOUT_S = 10.0         # target must dial back within this
RESERVE_TS_WINDOW_S = 60.0      # max |now - ts| on a signed RESERVE frame
SWEEP_INTERVAL_S = 30.0         # ping/evict cadence for reservations


@dataclass
class _Reservation:
    peer_id: str
    sock: socket.socket
    send_lock: threading.Lock = field(default_factory=threading.Lock)
    last_seen: float = field(default_factory=time.time)


@dataclass
class _PendingCircuit:
    dialer_sock: socket.socket
    event: threading.Event = field(default_factory=threading.Event)
    target_sock: Optional[socket.socket] = None


def _valid_udp_addr(v) -> Optional[tuple[str, int]]:
    """(host, port) from an untrusted wire value, or None. Punch addrs
    cross two trust boundaries (dialer -> relay -> target and back), so
    both hops validate instead of int()-ing whatever arrived."""
    try:
        if not isinstance(v, (list, tuple)) or len(v) != 2:
            return None
        host, port = str(v[0]), int(v[1])
        if not host or not 0 < port < 65536:
            return None
        return host, port
    except (TypeError, ValueError):
        return None


@dataclass
class _PendingPunch:
    event: threading.Event = field(default_factory=threading.Event)
    target_udp: Optional[list] = None


class RelayService:
    def __init__(self, addr: Optional[str] = None,
                 max_reservations: Optional[int] = None,
                 max_circuits: Optional[int] = None,
                 advertise_host: Optional[str] = None,
                 reserve_ts_window_s: float = RESERVE_TS_WINDOW_S,
                 stale_after_s: float = RESERVATION_STALE_S,
                 sweep_interval_s: float = SWEEP_INTERVAL_S) -> None:
        # Eager FAIL_POINTS parse: malformed chaos config fails at boot.
        load_failpoints_env()
        addr = addr if addr is not None else env_or("RELAY_ADDR", "127.0.0.1:4100")
        host, _, port = addr.rpartition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port or 0)
        self._advertise_host = advertise_host or (
            self._host if self._host not in ("0.0.0.0", "::") else "127.0.0.1")
        self.identity = Identity.generate()
        self.max_reservations = (max_reservations if max_reservations is not None
                                 else env_int("RELAY_MAX_RESERVATIONS", 128))
        self.max_circuits = (max_circuits if max_circuits is not None
                             else env_int("RELAY_MAX_CIRCUITS", 1024))
        self.reserve_ts_window_s = reserve_ts_window_s
        self.stale_after_s = stale_after_s
        self.sweep_interval_s = sweep_interval_s
        self._reservations: dict[str, _Reservation] = {}
        self._pending: dict[str, _PendingCircuit] = {}
        self._pending_punch: dict[str, _PendingPunch] = {}
        self._active_circuits = 0
        self._n_spliced = 0          # circuits ever spliced (punch tests
        #                              assert direct paths keep this at 0)
        # The data plane the last circuit ran on: "native"
        # (csrc/net_splice.cc) or "python" (the fallback pump); None
        # before the first circuit.
        self.pump: Optional[str] = None
        self._mu = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._udp: Optional[socket.socket] = None
        self._closed = threading.Event()

    @property
    def peer_id(self) -> str:
        return self.identity.peer_id

    def addr(self) -> Multiaddr:
        return Multiaddr(self._advertise_host, self._port, peer_id=self.peer_id)

    def start(self) -> "RelayService":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(128)
        self._port = s.getsockname()[1]
        self._server = s
        # STUN-lite UDP endpoint on the same port: answers "observe"
        # datagrams with the source address it saw, so NAT'd peers learn
        # their post-NAT UDP endpoint for hole punching (p2p/udp.py).
        # Best-effort: observe is an optional additive feature with a
        # graceful client fallback (observe_udp_addr tolerates silence),
        # so an unrelated process squatting the UDP port must not take
        # down circuit relaying.
        try:
            u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            u.bind((self._host, self._port))
            self._udp = u
            threading.Thread(target=self._udp_observe_loop,
                             daemon=True).start()
        except OSError as e:
            log.warning("UDP observe endpoint unavailable on port %d (%s); "
                        "hole-punch endpoint discovery disabled", self._port, e)
            self._udp = None
        threading.Thread(target=self._accept_loop, daemon=True).start()
        threading.Thread(target=self._sweep_loop, daemon=True).start()
        # Print multiaddrs like the reference does (go/cmd/relay/main.go:40-45).
        log.info("relay %s listening; multiaddr: %s", self.peer_id[:12], self.addr())
        return self

    def stop(self) -> None:
        self._closed.set()
        if self._udp is not None:
            try:
                self._udp.close()
            except OSError:
                pass
        if self._server is not None:
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        with self._mu:
            for r in self._reservations.values():
                try:
                    r.sock.close()
                except OSError:
                    pass
            self._reservations.clear()

    def serve_forever(self) -> None:
        self.start()
        threading.Event().wait()    # block forever (go/cmd/relay/main.go:46)

    # -- connection handling -------------------------------------------------

    def _udp_observe_loop(self) -> None:
        assert self._udp is not None
        while not self._closed.is_set():
            try:
                data, addr = self._udp.recvfrom(2048)
            except OSError:
                return
            try:
                msg = json.loads(data.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue
            if msg.get("type") == "observe":
                try:
                    self._udp.sendto(json.dumps({
                        "ok": True, "nonce": msg.get("nonce"),
                        "addr": [addr[0], addr[1]],
                    }).encode(), addr)
                except OSError:
                    pass

    def _accept_loop(self) -> None:
        assert self._server is not None
        while not self._closed.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._handle_conn, args=(conn,), daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(ACCEPT_TIMEOUT_S)
            msg = recv_json_frame(conn)
            if msg is None:
                conn.close()
                return
            # Failpoint: the relay control plane. ``drop`` discards the
            # control frame and closes the connection (the client sees a
            # dead relay and falls back to direct/punch paths); ``error``
            # answers a well-formed refusal; ``raise`` rides the except
            # below (connection closed, relay keeps serving others).
            act = failpoint("p2p.relay.control")
            if act is not None and act.kind in ("drop", "error"):
                if act.kind == "error":
                    send_json_frame(conn, {
                        "ok": False,
                        "error": act.msg or "injected fault"})
                conn.close()
                return
            mtype = msg.get("type")
            if mtype == RELAY_RESERVE:
                self._handle_reserve(conn, msg)
            elif mtype == RELAY_HOP:
                self._handle_hop(conn, msg)
            elif mtype == RELAY_ACCEPT:
                self._handle_accept(conn, msg)
            elif mtype == RELAY_PUNCH:
                self._handle_punch(conn, msg)
            else:
                send_json_frame(conn, {"ok": False, "error": "unknown type"})
                conn.close()
        except (OSError, ValueError, json.JSONDecodeError,
                FailpointError) as e:
            log.debug("relay conn error: %s", e)
            try:
                conn.close()
            except OSError:
                pass

    def _handle_reserve(self, conn: socket.socket, msg: dict) -> None:
        peer_id = str(msg.get("peer_id") or "")
        ts = str(msg.get("ts") or "")
        sig_hex = str(msg.get("sig") or "")
        try:
            pub = peer_id_to_public_key(peer_id)
            pub.verify(bytes.fromhex(sig_hex),
                       f"{RELAY_RESERVE}|{peer_id}|{ts}".encode())
        except Exception:
            send_json_frame(conn, {"ok": False, "error": "bad signature"})
            conn.close()
            return
        # Freshness window: the signature covers ts, so without this check a
        # captured RESERVE frame could be replayed forever to evict a peer's
        # live reservation and hijack its RELAY_INCOMING notifications.
        try:
            skew = abs(time.time() - float(ts))
        except ValueError:
            skew = float("inf")
        if skew > self.reserve_ts_window_s:
            send_json_frame(conn, {"ok": False, "error": "stale timestamp"})
            conn.close()
            return
        with self._mu:
            if (peer_id not in self._reservations
                    and len(self._reservations) >= self.max_reservations):
                send_json_frame(conn, {"ok": False, "error": "reservation limit"})
                conn.close()
                return
            old = self._reservations.get(peer_id)
            if old is not None:
                try:
                    old.sock.close()
                except OSError:
                    pass
            res = _Reservation(peer_id=peer_id, sock=conn)
            self._reservations[peer_id] = res
        send_json_frame(conn, {"ok": True})
        log.info("reservation: %s", peer_id[:12])
        conn.settimeout(None)
        # Bound *sends* on the control channel (SO_SNDTIMEO is send-only, so
        # the blocking recv loop below is unaffected): a peer that stops
        # reading can otherwise wedge the sweep ping or a HOP's
        # RELAY_INCOMING forever once the OS send buffer fills.
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                        struct.pack("ll", int(ACCEPT_TIMEOUT_S), 0))
        # Keep reading the control channel (pongs, punch acks, detect
        # close).
        try:
            while not self._closed.is_set():
                m = recv_json_frame(conn)
                if m is None:
                    break
                res.last_seen = time.time()
                if m.get("type") == RELAY_PUNCH_ACK:
                    with self._mu:
                        pp = self._pending_punch.get(
                            str(m.get("punch_id") or ""))
                    if pp is not None:
                        pp.target_udp = m.get("udp_addr")
                        pp.event.set()
        except (OSError, ValueError, json.JSONDecodeError):
            pass
        with self._mu:
            if self._reservations.get(peer_id) is res:
                del self._reservations[peer_id]
        try:
            conn.close()
        except OSError:
            pass
        log.info("reservation closed: %s", peer_id[:12])

    def _sweep_loop(self) -> None:
        """Ping every reservation periodically; evict those whose control
        channel has been silent past ``stale_after_s`` (the pong a live node
        sends back refreshes ``last_seen`` in the reserve read loop)."""
        while not self._closed.wait(self.sweep_interval_s):
            now = time.time()
            with self._mu:
                entries = list(self._reservations.items())
            for peer_id, res in entries:
                if now - res.last_seen > self.stale_after_s:
                    with self._mu:
                        if self._reservations.get(peer_id) is res:
                            del self._reservations[peer_id]
                    try:
                        res.sock.close()
                    except OSError:
                        pass
                    log.info("evicted stale reservation: %s", peer_id[:12])
                    continue
                # Bounded lock acquire: a sender already wedged on this
                # reservation must not stall sweeping of the others.
                if not res.send_lock.acquire(timeout=2.0):
                    continue
                try:
                    send_json_frame(res.sock, {"type": RELAY_PING})
                except OSError:
                    pass    # read loop will notice the dead socket
                finally:
                    res.send_lock.release()

    def _handle_hop(self, conn: socket.socket, msg: dict) -> None:
        target = str(msg.get("target") or "")
        with self._mu:
            res = self._reservations.get(target)
            if res is None:
                send_json_frame(conn, {"ok": False, "error": "no reservation for target"})
                conn.close()
                return
            if self._active_circuits >= self.max_circuits:
                send_json_frame(conn, {"ok": False, "error": "circuit limit"})
                conn.close()
                return
            conn_id = uuid.uuid4().hex
            pending = _PendingCircuit(dialer_sock=conn)
            self._pending[conn_id] = pending
        try:
            with res.send_lock:
                send_json_frame(res.sock, {"type": RELAY_INCOMING, "conn_id": conn_id})
        except OSError:
            with self._mu:
                self._pending.pop(conn_id, None)
            send_json_frame(conn, {"ok": False, "error": "target unreachable"})
            conn.close()
            return
        if not pending.event.wait(ACCEPT_TIMEOUT_S):
            with self._mu:
                self._pending.pop(conn_id, None)
            send_json_frame(conn, {"ok": False, "error": "target did not accept"})
            conn.close()
            return
        assert pending.target_sock is not None
        send_json_frame(conn, {"ok": True})
        self._splice(conn, pending.target_sock)

    def _handle_punch(self, conn: socket.socket, msg: dict) -> None:
        """Hole-punch coordination: forward the dialer's observed UDP
        endpoint to the target's control channel, wait for the target's
        ack carrying ITS observed endpoint, and return it to the dialer.
        The relay carries only this exchange — the handshake and message
        bytes then flow directly between the peers' UDP sockets."""
        target = str(msg.get("target") or "")
        udp_addr = _valid_udp_addr(msg.get("udp_addr"))
        if udp_addr is None:
            send_json_frame(conn, {"ok": False, "error": "bad udp_addr"})
            conn.close()
            return
        with self._mu:
            res = self._reservations.get(target)
            if res is None:
                send_json_frame(conn, {"ok": False,
                                       "error": "no reservation for target"})
                conn.close()
                return
            punch_id = uuid.uuid4().hex
            pending = _PendingPunch()
            self._pending_punch[punch_id] = pending
        try:
            with res.send_lock:
                send_json_frame(res.sock, {
                    "type": RELAY_PUNCH, "punch_id": punch_id,
                    "udp_addr": list(udp_addr),
                })
            if not pending.event.wait(ACCEPT_TIMEOUT_S):
                send_json_frame(conn, {"ok": False,
                                       "error": "target did not punch"})
                conn.close()
                return
            # A null/invalid ack addr is the target saying "I cannot
            # punch" — fail the dialer fast so it falls back to the
            # circuit instead of burning its handshake budget.
            target_udp = _valid_udp_addr(pending.target_udp)
            if target_udp is None:
                send_json_frame(conn, {"ok": False,
                                       "error": "target cannot punch"})
                conn.close()
                return
            send_json_frame(conn, {"ok": True,
                                   "udp_addr": list(target_udp)})
            conn.close()
        except OSError:
            try:
                conn.close()
            except OSError:
                pass
        finally:
            with self._mu:
                self._pending_punch.pop(punch_id, None)

    def _handle_accept(self, conn: socket.socket, msg: dict) -> None:
        conn_id = str(msg.get("conn_id") or "")
        with self._mu:
            pending = self._pending.pop(conn_id, None)
        if pending is None:
            send_json_frame(conn, {"ok": False, "error": "unknown conn_id"})
            conn.close()
            return
        send_json_frame(conn, {"ok": True})
        pending.target_sock = conn
        pending.event.set()

    def _splice(self, a: socket.socket, b: socket.socket) -> None:
        """Bidirectional byte pump between dialer and target sockets.

        Data plane goes native when buildable: one blocking C++
        poll-loop call per circuit (csrc/net_splice.cc — ctypes
        releases the GIL for its duration) instead of two Python
        recv/sendall threads serialising relayed bytes on the GIL. Same
        idle-timeout and half-close semantics either way."""
        with self._mu:
            self._active_circuits += 1
            self._n_spliced += 1
        lib = native.load("net_splice")
        pump = "native" if lib is not None else "python"
        if self.pump != pump:
            log.info("relay circuits spliced by the %s pump", pump)
            self.pump = pump
        if lib is not None:
            import ctypes
            lib.splice_pair.restype = ctypes.c_int64
            lib.splice_pair.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
            try:
                lib.splice_pair(a.fileno(), b.fileno(),
                                int(CIRCUIT_IDLE_TIMEOUT_S * 1000))
            finally:
                for s in (a, b):
                    try:
                        s.close()
                    except OSError:
                        pass
                with self._mu:
                    self._active_circuits -= 1
            return

        def pump(src: socket.socket, dst: socket.socket) -> None:
            try:
                src.settimeout(CIRCUIT_IDLE_TIMEOUT_S)
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        t1 = threading.Thread(target=pump, args=(a, b), daemon=True)
        t2 = threading.Thread(target=pump, args=(b, a), daemon=True)
        t1.start(); t2.start()
        t1.join(); t2.join()
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass
        with self._mu:
            self._active_circuits -= 1


def main() -> None:
    svc = RelayService().start()
    # Machine-readable multiaddr hand-off for launchers: the identity (and
    # so the /p2p/<id> in the multiaddr) is fresh per start, so orchestrators
    # can't know it in advance — RELAY_ADDR_FILE names a file to publish it
    # in (start_all.py uses this to set RELAY_ADDRS on the nodes).
    addr_file = env_or("RELAY_ADDR_FILE", "")
    if addr_file:
        tmp = addr_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(svc.addr()))
        os.replace(tmp, addr_file)
    threading.Event().wait()


if __name__ == "__main__":
    main()
