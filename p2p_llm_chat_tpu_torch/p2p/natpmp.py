"""NAT-PMP port mapping client (RFC 6886) — `libp2p.NATPortMap()` parity.

The port's copy of ``p2p_llm_chat_tpu/p2p/natpmp.py``: the same wire bytes
and behaviour, so port and reference peers mix in one fleet; the port
imports nothing of the reference package.

The reference enables router-cooperative port mapping on every node via
``libp2p.NATPortMap()`` (go/cmd/node/main.go:143): when the home gateway
speaks NAT-PMP/UPnP, the node maps its listen port and advertises the
external address, making itself directly dialable without a relay. This
module is the from-scratch equivalent for the common protocol (NAT-PMP;
its successor PCP shares the port and the result-code idea). Hole punching
(p2p/udp.py) remains the fallback when no cooperative gateway exists —
together they cover the reference's NATPortMap + DCUtR posture.

Protocol (RFC 6886, binary over UDP to gateway port 5351):

- external address request: ``ver=0 op=0`` (2 bytes) ->
  ``ver op+128 result(2) epoch(4) extip(4)`` (12 bytes)
- mapping request: ``ver=0 op={1:udp,2:tcp} rsvd(2) iport(2) eport(2)
  lifetime(4)`` (12 bytes) -> ``ver op+128 result(2) epoch(4) iport(2)
  eport(2) lifetime(4)`` (16 bytes)
- delete: a mapping request with lifetime 0 and eport 0
- retransmit: 250 ms initial RTO, doubling per try (RFC schedule; try
  count configurable — the RFC's 9 tries take ~64 s, too slow for a
  chat-node startup path, so the default here is 3)

Result codes: 0 success, 1 unsupported version, 2 not authorized,
3 network failure, 4 out of resources, 5 unsupported opcode.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..utils.log import get_logger

log = get_logger("natpmp")

NATPMP_PORT = 5351
_RESULT_NAMES = {
    0: "success",
    1: "unsupported version",
    2: "not authorized",
    3: "network failure",
    4: "out of resources",
    5: "unsupported opcode",
}

PROTO_UDP = 1
PROTO_TCP = 2


class NatPmpError(Exception):
    def __init__(self, result_code: int) -> None:
        self.result_code = result_code
        super().__init__(
            f"NAT-PMP result {result_code} "
            f"({_RESULT_NAMES.get(result_code, 'unknown')})")


class NatPmpUnavailable(Exception):
    """No gateway answered (not an error — most test/CI networks)."""


@dataclass
class Mapping:
    proto: int            # PROTO_UDP | PROTO_TCP
    internal_port: int
    external_port: int
    lifetime_s: int
    external_ip: Optional[str] = None


def discover_gateway() -> Optional[str]:
    """Default-route gateway from /proc/net/route (Linux). Returns None
    when there is no default route (e.g. isolated containers).

    Linux-only by design: on other platforms this returns None and
    NAT-PMP silently disables (the node falls back to hole punching /
    relay). Set ``NATPMP_GATEWAY`` explicitly to use NAT-PMP elsewhere.
    """
    try:
        with open("/proc/net/route") as f:
            next(f)  # header
            for line in f:
                parts = line.split()
                if len(parts) >= 3 and parts[1] == "00000000":
                    gw = int(parts[2], 16)
                    if gw == 0:
                        continue
                    # /proc encodes the address little-endian.
                    return socket.inet_ntoa(struct.pack("<I", gw))
    except (OSError, StopIteration, ValueError):
        pass
    return None


class NatPmpClient:
    """Blocking NAT-PMP client with the RFC retransmit schedule."""

    def __init__(self, gateway: str, port: int = NATPMP_PORT,
                 *, first_rto_s: float = 0.25, tries: int = 3) -> None:
        try:
            # Resolve once: the response filter compares source IPs, so a
            # hostname gateway would otherwise never match its own replies.
            self.gateway = socket.gethostbyname(gateway)
        except OSError:
            self.gateway = gateway   # fails cleanly in _transact
        self.port = port
        self.first_rto_s = first_rto_s
        self.tries = tries

    def _transact(self, req: bytes, want_op: int, resp_len: int) -> bytes:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            rto = self.first_rto_s
            for _ in range(self.tries):
                sock.sendto(req, (self.gateway, self.port))
                deadline = time.monotonic() + rto
                while True:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    sock.settimeout(rem)
                    try:
                        data, src = sock.recvfrom(64)
                    except socket.timeout:
                        break
                    except OSError:
                        break
                    # RFC 6886 §3.1: responses must come from the gateway.
                    if src[0] != self.gateway:
                        continue
                    if len(data) >= 4 and data[0] == 0 and data[1] == want_op:
                        result = struct.unpack("!H", data[2:4])[0]
                        if result != 0:
                            raise NatPmpError(result)
                        if len(data) >= resp_len:
                            return data
                rto *= 2          # RFC doubling schedule
            raise NatPmpUnavailable(
                f"no NAT-PMP response from {self.gateway}:{self.port}")
        finally:
            sock.close()

    def external_address(self) -> str:
        data = self._transact(struct.pack("!BB", 0, 0), 128, 12)
        return socket.inet_ntoa(data[8:12])

    def map_port(self, proto: int, internal_port: int,
                 external_port: int = 0, lifetime_s: int = 7200) -> Mapping:
        """Request a mapping; the gateway may assign a different external
        port than suggested (RFC 6886 §3.3) — always use the returned one."""
        req = struct.pack("!BBHHHI", 0, proto, 0, internal_port,
                          external_port, lifetime_s)
        data = self._transact(req, 128 + proto, 16)
        iport, eport, granted = struct.unpack("!HHI", data[8:16])
        if iport != internal_port:
            raise NatPmpUnavailable(
                f"response for wrong internal port {iport}")
        return Mapping(proto=proto, internal_port=internal_port,
                       external_port=eport, lifetime_s=granted)

    def unmap(self, proto: int, internal_port: int) -> None:
        """Delete our mapping (lifetime 0, external port 0, §3.4)."""
        req = struct.pack("!BBHHHI", 0, proto, 0, internal_port, 0, 0)
        try:
            self._transact(req, 128 + proto, 16)
        except (NatPmpError, NatPmpUnavailable) as e:
            log.debug("unmap %d/%d: %s", proto, internal_port, e)


class PortMapper:
    """Keeps one TCP mapping alive for a node's p2p listen port.

    ``acquire()`` discovers the gateway (or uses ``NATPMP_GATEWAY``),
    maps the port, and returns the external ``(ip, port)``;
    ``renew_if_due()`` re-requests at half-lifetime (RFC 6886 §3.3
    recommends renewing before expiry; the node calls it from its
    re-register loop); ``release()`` deletes the mapping on shutdown.
    Every failure degrades to "no mapping" — hole punching and the relay
    remain the fallback, matching the reference where NATPortMap is
    best-effort.
    """

    def __init__(self, internal_port: int, gateway: Optional[str] = None,
                 *, lifetime_s: int = 7200, port: int = NATPMP_PORT) -> None:
        self.internal_port = internal_port
        self.gateway = gateway if gateway is not None else discover_gateway()
        self.lifetime_s = lifetime_s
        self._gw_port = port
        self.mapping: Optional[Mapping] = None
        self._renew_at = 0.0
        # Orders renew against release: a renew in flight when release()
        # fires would otherwise RE-create the mapping after the delete,
        # leaking the port forward shutdown cleanup exists to prevent.
        self._mu = threading.Lock()
        self._released = False

    def acquire(self) -> Optional[tuple[str, int]]:
        if self.gateway is None:
            log.info("NAT-PMP: no default gateway; skipping")
            return None
        client = NatPmpClient(self.gateway, self._gw_port)
        try:
            ext_ip = client.external_address()
            m = client.map_port(PROTO_TCP, self.internal_port,
                                self.internal_port, self.lifetime_s)
        except (NatPmpError, NatPmpUnavailable) as e:
            log.info("NAT-PMP unavailable (%s); relying on punch/relay", e)
            return None
        m.external_ip = ext_ip
        self.mapping = m
        self._renew_at = time.monotonic() + m.lifetime_s / 2
        log.info("NAT-PMP mapped %s:%d -> :%d (lifetime %ds)",
                 ext_ip, m.external_port, m.internal_port, m.lifetime_s)
        return ext_ip, m.external_port

    def renew_if_due(self) -> Optional[tuple[str, int]]:
        """Renew at half-lifetime. Returns the new external ``(ip, port)``
        when it CHANGED (gateway reboot / reassigned port — RFC 6886 §3.3
        allows a different grant; §3.6's epoch exists for exactly this),
        else None. Callers must re-advertise on change."""
        with self._mu:
            if (self._released or self.mapping is None
                    or time.monotonic() < self._renew_at):
                return None
            prev = (self.mapping.external_ip, self.mapping.external_port)
            # Fewer retransmits than the initial map: renew runs under
            # self._mu, which node.stop() -> release() also takes, so the
            # worst-case blocking window here directly delays shutdown
            # (ADVICE r4). A missed renew retries at lifetime/4 anyway.
            client = NatPmpClient(self.gateway, self._gw_port, tries=2)
            try:
                ext_ip = client.external_address()
                m = client.map_port(PROTO_TCP, self.internal_port,
                                    self.mapping.external_port,
                                    self.lifetime_s)
                m.external_ip = ext_ip
                self.mapping = m
                self._renew_at = time.monotonic() + m.lifetime_s / 2
                cur = (ext_ip, m.external_port)
                return cur if cur != prev else None
            except (NatPmpError, NatPmpUnavailable) as e:
                log.warning("NAT-PMP renew failed (%s); mapping may lapse", e)
                # Back off half a lifetime before retrying.
                self._renew_at = time.monotonic() + self.lifetime_s / 4
                return None

    def release(self) -> None:
        # Takes the same lock as renew_if_due, so an in-flight renew
        # finishes first and the delete below is the LAST gateway write.
        with self._mu:
            self._released = True
            if self.mapping is not None and self.gateway is not None:
                NatPmpClient(self.gateway, self._gw_port).unmap(
                    PROTO_TCP, self.internal_port)
                self.mapping = None
