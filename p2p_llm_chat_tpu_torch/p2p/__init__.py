"""Encrypted P2P transport substrate.

The port's copy of ``p2p_llm_chat_tpu/p2p/__init__.py``: the same wire
bytes and behaviour, so port and reference peers mix in one fleet; the
port imports nothing of the reference package.

This is the from-scratch equivalent of the reference's L0 layer (go-libp2p:
noise-encrypted, authenticated streams with stable peer identities —
SURVEY.md §1 L0). Design, not a port:

- **Identity** (:mod:`identity`): Ed25519 static keys; the peer ID is the
  base58 of a 2-byte type tag + raw public key, so any party can recover
  the public key from a peer ID and authenticate the remote end of a
  handshake against a directory record alone.
- **Transport** (:mod:`transport`): Noise-XX-style handshake (X25519
  ephemeral ECDH -> HKDF -> per-direction ChaCha20-Poly1305 keys, both
  sides sign the transcript with their static Ed25519 key), then
  length-prefixed encrypted frames over TCP. One stream per message with
  whole-stream framing, matching the reference's open->write->close
  pattern (go/cmd/node/main.go:245-261).
- **Multiaddrs** (:mod:`addr`): textual addresses keep the reference's
  ``/ip4/<ip>/tcp/<port>/p2p/<peer-id>`` shape (go/cmd/node/main.go:176-181)
  so directory records stay wire-compatible, plus ``/p2p-circuit/`` for
  relayed paths.
"""

from .identity import Identity, peer_id_to_public_key
from .addr import Multiaddr
from .transport import P2PHost, SecureStream

__all__ = ["Identity", "peer_id_to_public_key", "Multiaddr", "P2PHost", "SecureStream"]
