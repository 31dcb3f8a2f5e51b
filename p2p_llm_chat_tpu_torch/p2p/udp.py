"""Reliable datagram transport + NAT hole punching support.

The port's copy of ``p2p_llm_chat_tpu/p2p/udp.py``: the same wire bytes
and behaviour, so port and reference peers mix in one fleet; the port
imports nothing of the reference package.

The reference's node listens on TCP *and* QUIC-v1
(go/cmd/node/main.go:139-140) and maps NAT ports
(libp2p.NATPortMap(), go/cmd/node/main.go:143). The in-tree equivalent
is UDP-based direct connectivity: a dialer and a NAT'd listener exchange
their relay-observed UDP endpoints over the relay control channel
(relay.py PUNCH coordination), fire probe datagrams at each other to
open both NAT mappings, and then run the exact same Noise-XX-style
handshake and ChaCha20-Poly1305 framing as the TCP transport — over a
:class:`ReliableDgram`, which duck-types the blocking-socket surface
(``sendall``/``recv``/``settimeout``/``shutdown``/``close``) on top of a
connected UDP socket. Message bytes then flow peer-to-peer; the relay
carries only the few-hundred-byte coordination exchange, not the
conversation (unlike a circuit splice).

Reliability is deliberately minimal — stop-and-wait with per-chunk acks
and retransmission. Chat messages are a few KB (SURVEY.md §2 C2 wire
schema), so a congestion-controlled QUIC reimplementation would be all
cost and no observable difference; the layer is below encryption, so a
forged/replayed datagram at worst perturbs framing and fails AEAD
authentication upstream.

Wire format (one datagram each):
    b"D" seq:8 payload   in-order data chunk
    b"A" seq:8           cumulative-style ack of exactly ``seq``
    b"F" seq:8           sender finished after ``seq-1`` (acked like data)
    b"P"                 punch probe — opens the NAT mapping, else ignored
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Optional

from ..utils.log import get_logger

log = get_logger("p2p.udp")

# Payload bytes per datagram: safely under common path MTUs so the IP
# layer never fragments (fragment loss would multiply retransmissions).
CHUNK = 1152
_ACK_TIMEOUT_S = 0.25
_DEFAULT_SEND_TIMEOUT_S = 10.0
PUNCH_PROBES = 3
PUNCH_INTERVAL_S = 0.05


class ReliableDgram:
    """Socket-shaped reliable byte stream over a connected UDP socket.

    One pump thread per instance reads datagrams: acks for in-flight
    sends are dispatched to the sending thread, in-order data chunks
    append to the receive buffer, duplicates are re-acked (their ack may
    have been lost). ``sendall`` is stop-and-wait per chunk; ``recv``
    blocks on the buffer like a stream socket and returns b"" at the
    remote's FIN.
    """

    def __init__(self, sock: socket.socket, peer: tuple[str, int],
                 send_timeout_s: float = _DEFAULT_SEND_TIMEOUT_S) -> None:
        self._sock = sock
        self._peer = peer
        # Retransmission budget per chunk: bounds how long an unreachable
        # peer (UDP-hostile network after a "successful" coordination
        # exchange) can stall the caller — the hole-punch dialer passes
        # its dial timeout here so punch failures fall back to the relay
        # circuit within the /send deadline.
        self._max_retries = max(1, int(send_timeout_s / _ACK_TIMEOUT_S))
        sock.connect(peer)          # filter to the punched peer's datagrams
        self._send_seq = 0
        self._acks: dict[int, threading.Event] = {}
        self._acks_mu = threading.Lock()
        self._recv_next = 0
        self._recv_buf = bytearray()
        self._fin_seq: Optional[int] = None
        self._cond = threading.Condition()
        self._timeout: Optional[float] = None
        self._closed = threading.Event()
        # Intended hierarchy (machine-checked by graftcheck lock-order):
        # the sender path holds _send_mu across a whole stop-and-wait
        # chunk exchange and takes _acks_mu briefly inside it; nothing
        # may ever take them in the other order.
        # lock-order: ReliableDgram._send_mu < ReliableDgram._acks_mu
        self._send_mu = threading.Lock()
        self._fin_sent = False
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump.start()

    # -- pump ----------------------------------------------------------------

    def _pump_loop(self) -> None:
        sock = self._sock
        while not self._closed.is_set():
            try:
                data = sock.recv(65536)
            except OSError:
                break
            if not data:
                continue
            kind = data[:1]
            if kind == b"P" or len(data) < 9:
                continue
            seq = struct.unpack(">Q", data[1:9])[0]
            if kind == b"A":
                with self._acks_mu:
                    ev = self._acks.get(seq)
                if ev is not None:
                    ev.set()
            elif kind == b"D":
                if seq == self._recv_next:
                    with self._cond:
                        self._recv_buf.extend(data[9:])
                        self._recv_next += 1
                        self._cond.notify_all()
                if seq < self._recv_next:   # delivered (now or earlier): ack
                    self._send_ctrl(b"A", seq)
                # Out-of-order future chunks are dropped — the sender is
                # stop-and-wait, so the only future chunk is seq ==
                # recv_next after a lost predecessor retransmits.
            elif kind == b"F":
                if seq <= self._recv_next:
                    with self._cond:
                        self._fin_seq = seq
                        self._cond.notify_all()
                    self._send_ctrl(b"A", seq)
        with self._cond:
            if self._fin_seq is None:
                self._fin_seq = self._recv_next     # EOF on close
            self._cond.notify_all()

    def _send_ctrl(self, kind: bytes, seq: int, payload: bytes = b"") -> None:
        try:
            self._sock.send(kind + struct.pack(">Q", seq) + payload)
        except OSError:
            pass

    def _send_reliable(self, kind: bytes, seq: int, payload: bytes) -> None:
        ev = threading.Event()
        with self._acks_mu:
            self._acks[seq] = ev
        try:
            for _ in range(self._max_retries):
                self._send_ctrl(kind, seq, payload)
                if ev.wait(_ACK_TIMEOUT_S):
                    return
                if self._closed.is_set():
                    raise OSError("dgram stream closed")
            raise OSError(
                f"no ack for seq {seq} after {self._max_retries} tries")
        finally:
            with self._acks_mu:
                self._acks.pop(seq, None)

    # -- socket surface ------------------------------------------------------

    def sendall(self, data: bytes) -> None:
        with self._send_mu:
            for off in range(0, len(data), CHUNK) or [0]:
                chunk = data[off: off + CHUNK]
                self._send_reliable(b"D", self._send_seq, chunk)
                self._send_seq += 1

    def recv(self, n: int) -> bytes:
        deadline = (time.monotonic() + self._timeout
                    if self._timeout is not None else None)
        with self._cond:
            while not self._recv_buf:
                if (self._fin_seq is not None
                        and self._recv_next >= self._fin_seq):
                    return b""                      # clean EOF
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise socket.timeout("dgram recv timed out")
                self._cond.wait(remaining)
            out = bytes(self._recv_buf[:n])
            del self._recv_buf[:n]
            return out

    def settimeout(self, t: Optional[float]) -> None:
        self._timeout = t

    def shutdown(self, how: int) -> None:
        if how not in (socket.SHUT_WR, socket.SHUT_RDWR):
            return
        with self._send_mu:
            if self._fin_sent:          # a second FIN would never be acked
                return
            self._fin_sent = True
            # The peer's reader may be blocked in recv with NO timeout
            # (the post-handshake steady state), so the FIN must be
            # retransmitted on loss — but briefly: ~2 s covers datagram
            # loss without wedging the closing thread for the full
            # per-chunk budget when the peer has vanished.
            old = self._max_retries
            self._max_retries = min(old, 8)
            try:
                self._send_reliable(b"F", self._send_seq, b"")
            except OSError:
                pass
            finally:
                self._max_retries = old
            self._send_seq += 1

    def close(self) -> None:
        if self._closed.is_set():
            return
        try:
            self.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._cond:
            self._cond.notify_all()

    def getsockname(self):
        return self._sock.getsockname()


# -- NAT endpoint discovery + punching ---------------------------------------

def observe_udp_addr(sock: socket.socket, relay_host: str, relay_port: int,
                     timeout: float = 3.0,
                     attempts: int = 3) -> Optional[tuple[str, int]]:
    """Learn this socket's relay-observed (post-NAT) endpoint: send a
    JSON ``observe`` datagram to the relay's UDP port (relay.py answers
    with the source address it saw — STUN-lite). Returns None when the
    relay doesn't answer (old relay / UDP blocked); callers fall back to
    the local sockname, which is correct on un-NAT'd paths."""
    nonce = os.urandom(8).hex()
    req = json.dumps({"type": "observe", "nonce": nonce}).encode()
    old_timeout = sock.gettimeout()
    sock.settimeout(timeout / attempts)
    try:
        for _ in range(attempts):
            try:
                sock.sendto(req, (relay_host, relay_port))
                data, _ = sock.recvfrom(2048)
                resp = json.loads(data.decode())
                if resp.get("nonce") == nonce and resp.get("addr"):
                    h, p = resp["addr"]
                    return str(h), int(p)
            except (OSError, ValueError, json.JSONDecodeError):
                continue
        return None
    finally:
        sock.settimeout(old_timeout)


def punch(sock: socket.socket, peer: tuple[str, int]) -> None:
    """Fire probe datagrams at the peer's observed endpoint: the first
    outbound packet opens this side's NAT mapping; a few repeats cover
    probe loss while the far side's mapping opens."""
    for _ in range(PUNCH_PROBES):
        try:
            sock.sendto(b"P", peer)
        except OSError:
            return
        time.sleep(PUNCH_INTERVAL_S)
