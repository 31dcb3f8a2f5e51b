"""Multiaddr parsing/formatting.

The port's copy of ``p2p_llm_chat_tpu/p2p/addr.py``: the same wire bytes
and behaviour, so port and reference peers mix in one fleet; the port
imports nothing of the reference package.

We keep the reference's textual address shape so directory payloads are
wire-compatible (addrs built at go/cmd/node/main.go:176-181):

    /ip4/127.0.0.1/tcp/4001/p2p/<peer-id>

plus the libp2p circuit form for relayed reachability (the reference ships a
relay daemon, go/cmd/relay/main.go, whose addresses take this shape):

    /ip4/<relay-ip>/tcp/<relay-port>/p2p/<relay-id>/p2p-circuit/p2p/<peer-id>

Only the components we route on are modelled (ip4/dns4, tcp, p2p,
p2p-circuit); unknown components raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Multiaddr:
    host: str                       # ip4 or dns4 value
    port: int                       # tcp port
    peer_id: Optional[str] = None   # trailing /p2p/<id> (target)
    # Relay circuit: when set, (host, port, relay_peer_id) address the relay
    # and peer_id addresses the target behind it.
    relay_peer_id: Optional[str] = None
    is_circuit: bool = False

    @classmethod
    def parse(cls, s: str) -> "Multiaddr":
        parts = [p for p in s.strip().split("/") if p != ""]
        host: Optional[str] = None
        port: Optional[int] = None
        peer_ids: list[str] = []
        is_circuit = False
        i = 0
        while i < len(parts):
            key = parts[i]
            if key in ("ip4", "ip6", "dns4", "dns6", "dns"):
                host = parts[i + 1]
                i += 2
            elif key == "tcp":
                port = int(parts[i + 1])
                i += 2
            elif key == "p2p":
                peer_ids.append(parts[i + 1])
                i += 2
            elif key == "p2p-circuit":
                is_circuit = True
                i += 1
            elif key == "quic-v1" or key == "quic":
                # The reference listens on QUIC too (go/cmd/node/main.go:140);
                # our transport is TCP-only, so QUIC addrs parse but carry the
                # same host/port for dialing purposes.
                i += 1
            elif key == "udp":
                port = int(parts[i + 1])
                i += 2
            else:
                raise ValueError(f"unsupported multiaddr component /{key} in {s!r}")
        if host is None or port is None:
            raise ValueError(f"multiaddr missing host/port: {s!r}")
        if is_circuit:
            if len(peer_ids) != 2:
                raise ValueError(f"circuit multiaddr needs relay and target ids: {s!r}")
            return cls(host=host, port=port, peer_id=peer_ids[1],
                       relay_peer_id=peer_ids[0], is_circuit=True)
        return cls(host=host, port=port,
                   peer_id=peer_ids[0] if peer_ids else None)

    def __str__(self) -> str:
        base = f"/ip4/{self.host}/tcp/{self.port}"
        if self.is_circuit:
            return f"{base}/p2p/{self.relay_peer_id}/p2p-circuit/p2p/{self.peer_id}"
        if self.peer_id:
            return f"{base}/p2p/{self.peer_id}"
        return base

    def with_peer(self, peer_id: str) -> "Multiaddr":
        """Encapsulate a /p2p/<id> suffix (go/cmd/node/main.go:179)."""
        return Multiaddr(self.host, self.port, peer_id=peer_id,
                         relay_peer_id=self.relay_peer_id, is_circuit=self.is_circuit)

    def circuit_via(self, relay_id: str) -> "Multiaddr":
        return Multiaddr(self.host, self.port, peer_id=self.peer_id,
                         relay_peer_id=relay_id, is_circuit=True)
