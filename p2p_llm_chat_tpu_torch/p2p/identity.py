"""Peer identity: Ed25519 keypairs and self-certifying peer IDs.

The port's copy of ``p2p_llm_chat_tpu/p2p/identity.py``: the same wire
bytes and behaviour, so port and reference peers mix in one fleet; the
port imports nothing of the reference package.

The reference generates an RSA-2048 key per node start (go/cmd/node/main.go:
293-299) and derives the libp2p peer ID from it. We use Ed25519 (faster
keygen/sign, 32-byte keys) and make the peer ID *self-certifying*: it embeds
the public key, so a dialer holding only a directory record can verify the
remote peer cryptographically. Identities can optionally be persisted —
the reference lists that as future work (README.md:134).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives import serialization
    DEV_CRYPTO = False
except ImportError:
    # Containers without the cryptography package can opt in to the
    # INSECURE stdlib dev fallback (P2P_DEV_CRYPTO=1 — loopback dev and
    # loadgen scale-out only); anything else keeps the loud ImportError.
    from .devcrypto import require_dev_crypto
    require_dev_crypto("p2p.identity")
    from .devcrypto import (            # type: ignore[assignment]
        Ed25519PrivateKey,
        Ed25519PublicKey,
        serialization,
    )
    DEV_CRYPTO = True

from ..utils.base58 import b58decode, b58encode

# 2-byte tag prefixed to the raw public key before base58 encoding, giving
# peer IDs a stable leading character and versioning the key type. Dev
# fallback ids carry their own tag so a null-signature dev identity can
# never parse as — or verify against — a real Ed25519 peer id.
_ED25519_TAG = b"\x01\xdd" if DEV_CRYPTO else b"\x01\xed"


def public_key_to_peer_id(pub: Ed25519PublicKey) -> str:
    raw = pub.public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )
    return b58encode(_ED25519_TAG + raw)


def peer_id_to_public_key(peer_id: str) -> Ed25519PublicKey:
    raw = b58decode(peer_id)
    if len(raw) != 34 or raw[:2] != _ED25519_TAG:
        raise ValueError(
            f"not an ed25519 peer id (this node runs "
            f"{'dev-crypto' if DEV_CRYPTO else 'real'} identities): "
            f"{peer_id!r}")
    return Ed25519PublicKey.from_public_bytes(raw[2:])


@dataclass
class Identity:
    private_key: Ed25519PrivateKey

    @classmethod
    def generate(cls) -> "Identity":
        return cls(Ed25519PrivateKey.generate())

    @classmethod
    def load_or_generate(cls, path: Optional[str]) -> "Identity":
        """Load a persisted identity from ``path``; generate (and persist,
        if a path is given) otherwise."""
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                key = Ed25519PrivateKey.from_private_bytes(f.read())
            return cls(key)
        ident = cls.generate()
        if path:
            raw = ident.private_key.private_bytes(
                serialization.Encoding.Raw,
                serialization.PrivateFormat.Raw,
                serialization.NoEncryption(),
            )
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(raw)
        return ident

    @property
    def public_key(self) -> Ed25519PublicKey:
        return self.private_key.public_key()

    @property
    def public_bytes(self) -> bytes:
        return self.public_key.public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )

    @property
    def peer_id(self) -> str:
        return public_key_to_peer_id(self.public_key)

    def sign(self, data: bytes) -> bytes:
        return self.private_key.sign(data)
